"""The per-core arrival-skew feed into the shared-DRAM contention queues
(`trace.contention`); port of `repro.noc.stage.noc_arrival_skew`.

The reference's `NocStage` (the routed stage of the per-op pipeline)
comes with the per-op engine, module item 8 of the port (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from ..core.accelerator import AcceleratorConfig
from ..core.multicore import effective_nop_hops
from .router import eager_noc_delay
from .topology import noc_kind


def noc_arrival_skew(cfg: AcceleratorConfig, per_core_bytes,
                     window: float) -> np.ndarray:
    """Per-core DRAM arrival offset (cycles): zero-load routed latency plus
    router queueing extra (`eager_noc_delay`, float64). Feeds
    `trace.contention`'s request timestamps so NoP skew spreads the
    shared-queue burst.

    With the NoC plane disabled (or a single core) this is exactly the
    legacy `nop_hops * nop_cycles_per_hop` offset, keeping the contention
    path bit-identical to NoC-free behavior.
    """
    hops = effective_nop_hops(cfg)
    zero_load = hops * cfg.nop_cycles_per_hop
    if noc_kind(cfg) is None:
        return zero_load
    noc = cfg.noc
    flits = np.asarray(per_core_bytes, dtype=np.float64) / noc.flit_bytes
    stats = eager_noc_delay(
        noc.topology, cfg.mesh_rows, cfg.mesh_cols, flits,
        noc.link_bandwidth_bytes_per_cycle, noc.flit_bytes,
        noc.buffer_flits, cfg.nop_cycles_per_hop, float(window))
    return zero_load + stats["extra"]
