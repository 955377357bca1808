"""repro_torch.farm — the Study run-farm of the PyTorch port: a persistent,
multi-worker simulation service with a fleet-shared dedup cache (the
reference's `repro.farm`, bound to the port's `Study`; one worker process
runs on one device, CUDA unless it is asked for the CPU).

The Study layer compiles design-space experiments into batched kernel
groups; the farm makes that a *service* (the FireSim manager/run-farm
shape): N clients submit serialized `StudyPlan`s over a file-spool job
queue, a **broker** shards them across M **worker** processes with
per-study priorities, cancellation, lease-based re-delivery of a dead
worker's shards, and straggler detection — and every worker writes
through one content-hash dedup cache, so across all clients and all
studies no cell is ever computed twice fleet-wide.

    python -m repro_torch.farm serve  --root farm &             # broker
    python -m repro_torch.farm worker --root farm --device cuda:0 &  # any number
    python -m repro_torch.farm submit studies.edp_array_size --root farm --wait

    # or in-process:
    from repro_torch.farm import Broker, FarmClient, Worker
    sid = FarmClient(root).submit(studies.edp_array_size())
    ...
    res = FarmClient(root).result(sid)   # bit-identical to Study.run()

Transport is a lock-free file spool (atomic temp+rename writes, atomic
rename claims, at-least-once delivery) — no sockets, no daemons, works
anywhere a shared directory does. See DESIGN.md "The run-farm".
"""
from .broker import Broker
from .client import FarmClient
from .queue import FarmDirs, FileSpool, QueueItem
from .worker import Worker

__all__ = ["Broker", "FarmClient", "FarmDirs", "FileSpool", "QueueItem",
           "Worker"]
