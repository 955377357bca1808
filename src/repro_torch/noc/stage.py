"""The per-core arrival-skew feed into the shared-DRAM contention queues
(`trace.contention`); port of `repro.noc.stage.noc_arrival_skew` with the
NoC plane disabled."""
from __future__ import annotations

import numpy as np

from ..core.accelerator import AcceleratorConfig
from ..core.multicore import effective_nop_hops


def noc_arrival_skew(cfg: AcceleratorConfig, per_core_bytes,
                     window: float) -> np.ndarray:
    """Per-core DRAM arrival offset (cycles). With the NoC plane disabled
    (or a single core) it is the legacy `nop_hops * nop_cycles_per_hop`
    offset, as in the reference. A NoC-enabled multi-core design needs the
    routed plane, which this port does not model yet:
    `effective_nop_hops` raises NotImplementedError for it, naming module
    item 7. `per_core_bytes` and `window` feed the routed model only."""
    del per_core_bytes, window
    return effective_nop_hops(cfg) * cfg.nop_cycles_per_hop
