"""Worker: one simulation-executing process of the farm.

A worker owns a process and one device (`device=`: CUDA unless it is
asked for the CPU; a machine with four cards runs four workers, each with
`--device cuda:i`, the fast layout), or with `use_mesh=True` a mesh of
this process's devices shaped by `dist.plan_elastic_remesh` (every card
by default, one worker for the host: batched groups shard their design
axis over it, as the reference's mesh worker does; each block repeats
the group's host-bound dispatch, so it is slower than a worker a card),
and loops:

    claim shard -> rebuild study (cached per study id) -> execute the
    shard's cells through `Study._execute_cells` -> write the shard
    result atomically -> ack the shard.

Execution reuses the exact machinery of a local `Study.run()` — the
batched `_sweep_batched` call (and its CUDA kernels) for group shards and
the per-op engine for fallback cells — against the **fleet-shared dedup
cache**
(`<root>/cache/`, same content-hash format as `Study.cache(...)`, so a
warm single-process cache carries straight over and no cell is computed
twice fleet-wide). Results are bit-identical to a local run on the same
device type regardless of how the broker sliced the groups, because each
design's values do not depend on which designs share the batched call.

Crash safety: the shard result is written *before* the ack, so a worker
dying anywhere in the loop leaves either a claimable lease (broker
requeues it) or a durable result — never a lost shard. Re-execution
after a requeue race is harmless: cells are deterministic and results
are keyed by shard id (last atomic write wins, same bytes).

Heartbeats (`<root>/workers/<wid>.json`) tell the broker the live fleet
size, which feeds elastic shard sizing for subsequently-ingested
studies.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import Dict, Optional, Sequence, Tuple

from ..api.study import Study, StudyPlan, _mesh_device
from ..core.replay import resolve_device
from ..dist import ElasticPlan, plan_elastic_remesh
from ..faults import fs as _fs
from .queue import SHARDS_TOPIC, FarmDirs, FileSpool, read_json, \
    write_json_atomic

__all__ = ["Worker"]


class Worker:
    def __init__(self, root: str, worker_id: Optional[str] = None, *,
                 cache: Optional[str] = "auto", device=None,
                 use_mesh: bool = False,
                 mesh_devices: Optional[Sequence] = None):
        """cache: "auto" = the farm root's shared dedup cache; a path =
        use that directory; None = no caching (every cell executes —
        used by throughput benchmarks to measure cold cost). device: where
        this worker's cells run (CUDA by default, raising without a card;
        "cpu" runs the kernels' plain versions). The cell hash carries the
        device type, so CPU and CUDA workers never serve each other's
        cells. use_mesh: shard batched groups over a mesh of
        `mesh_devices` (by default every card of the process, or the one
        CPU), its shape planned by `plan_elastic_remesh`; `device` must
        be one of them and defaults to the first."""
        self._mesh = None
        self._mesh_plan: Optional[ElasticPlan] = None
        if use_mesh:
            self._build_mesh(device, mesh_devices)
            self.device = _mesh_device(self._mesh, device)
        else:
            self.device = resolve_device(device)
        self.dirs = FarmDirs(root)
        self.spool = FileSpool(root)
        self.worker_id = worker_id or \
            f"w-{os.getpid()}-{uuid.uuid4().hex[:4]}"
        self.cache_dir = (self.dirs.cache_dir() if cache == "auto"
                          else cache)
        self.shards_done = 0
        self.cells_done = 0
        self.cache_hits = 0
        self._studies: Dict[str, Tuple[Study, StudyPlan]] = {}

    def _build_mesh(self, device, devices: Optional[Sequence]) -> None:
        """Shape a data mesh over this process's devices via the elastic
        planner (batched groups shard their design axis over it)."""
        from ..launch.mesh import make_device_mesh
        if devices is None and resolve_device(device).type == "cpu":
            devices = ["cpu"]
        devices = make_device_mesh(devices).devices   # None: every card
        n = len(devices)
        self._mesh_plan = plan_elastic_remesh(n, global_batch=n)
        self._mesh = make_device_mesh(devices,
                                      shape=self._mesh_plan.mesh_shape,
                                      axis_names=self._mesh_plan.mesh_axes)

    @property
    def mesh_shape(self) -> Optional[list]:
        """The mesh's shape as the heartbeat and results write it."""
        return (list(self._mesh_plan.mesh_shape) if self._mesh_plan
                else None)

    # ---- the work loop -------------------------------------------------------
    def step(self) -> bool:
        """Claim and execute at most one shard. Returns True if a shard
        was processed (work may remain), False if the queue was empty."""
        item = self.spool.claim(SHARDS_TOPIC, self.worker_id)
        if item is not None:
            # kill-point: died holding a fresh claim — the lease expires
            # and the broker re-delivers (a budgeted attempt)
            _fs.crash_point("worker.claimed")
        self._heartbeat(current=item.item_id if item else None)
        if item is None:
            return False
        p = item.payload
        sid = str(p.get("study_id", "?"))
        shard = int(p.get("shard", -1))
        t0 = time.perf_counter()
        try:
            study, plan = self._study(sid)
            results, executed, hits = study._execute_cells(
                plan, p["cells"], cache_dir=self.cache_dir,
                device=self.device, mesh=self._mesh)
            out = {"study_id": sid, "shard": shard,
                   "worker": self.worker_id,
                   "cells": {str(i): m for i, m in results.items()},
                   "executed_cells": executed, "cache_hits": hits,
                   "seconds": time.perf_counter() - t0,
                   "mesh": self.mesh_shape, "device": self.device.type}
            self.cells_done += len(results)
            self.cache_hits += hits
        except Exception as e:  # noqa: BLE001 — report, don't poison-loop
            out = {"study_id": sid, "shard": shard,
                   "worker": self.worker_id,
                   "error": f"{type(e).__name__}: {e}",
                   "seconds": time.perf_counter() - t0}
        # result BEFORE ack: a crash in between re-delivers the shard,
        # and the duplicate result is byte-identical (deterministic cells)
        write_json_atomic(self.dirs.shard_result_path(sid, shard), out,
                          site="worker.result")
        # kill-point: result durable, shard still leased — the broker
        # requeues it and the re-executed duplicate folds once
        _fs.crash_point("worker.pre_ack")
        self.spool.ack(item)
        self.shards_done += 1
        self._heartbeat(current=None)
        return True

    def serve(self, *, poll: float = 0.2, stop_event=None,
              idle_exit: Optional[float] = None) -> None:
        """Loop `step` (the `python -m repro_torch.farm worker` body).
        idle_exit: exit after this many seconds without claiming work
        (lets CI/bench fleets drain and terminate themselves)."""
        idle_since = time.time()
        while True:
            if self.step():
                idle_since = time.time()
                continue
            if idle_exit is not None and \
                    time.time() - idle_since > idle_exit:
                return
            if stop_event is not None:
                if stop_event.wait(poll):
                    return
            else:
                time.sleep(poll)

    # ---- internals -------------------------------------------------------------
    def _study(self, sid: str) -> Tuple[Study, StudyPlan]:
        """Rebuild (once per study id) the study + plan from the spec
        the broker parked on disk before enqueueing any shard."""
        if sid not in self._studies:
            spec = read_json(self.dirs.spec_path(sid))
            if spec is None:
                raise FileNotFoundError(
                    f"no spec on disk for study {sid!r}")
            study = Study.from_spec(spec)
            self._studies[sid] = (study, study.plan())
        return self._studies[sid]

    def _heartbeat(self, current: Optional[str]) -> None:
        """Advisory liveness ping. A failing heartbeat write (disk
        hiccup) must never kill a worker mid-shard — the broker treats
        a stale/unreadable heartbeat as dead-worker, which is exactly
        the degradation we want."""
        try:
            write_json_atomic(self.dirs.worker_path(self.worker_id), {
                "worker": self.worker_id, "time": time.time(),
                "pid": os.getpid(), "shards_done": self.shards_done,
                "cells_done": self.cells_done,
                "cache_hits": self.cache_hits,
                "current_shard": current,
                "mesh": self.mesh_shape, "device": self.device.type},
                site="worker.heartbeat")
        except OSError:
            pass
