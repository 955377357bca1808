"""`NocStage`, the routed-interconnect stage of the per-op pipeline, and
the per-core arrival-skew feed into the shared-DRAM contention queues
(`trace.contention`); port of `repro.noc.stage`.

The stage sits between sram and dram in `core.stages.build_pipeline`: the
partition's compute makespan is the injection window, and the op's DRAM
demand (the same capacity-based traffic the dram stage computes right
after) is the payload each core pushes over the NoP toward the memory
controller. It runs the float64 numpy router (`router.eager_noc_delay`),
so `force_fallback=True` studies hold the batched tensor model against it.
At zero load the stage adds exactly 0.0 cycles. `allreduce_cycles` and
`noc_link_util` are reported, not folded into the total.
"""
from __future__ import annotations

import numpy as np

from ..core.accelerator import AcceleratorConfig
from ..core.multicore import effective_nop_hops
from ..core.stages import CoreStage, OpContext, host_dram_traffic
from .router import eager_noc_delay
from .topology import noc_kind
from .traffic import allreduce_cycles, memory_flits


class NocStage(CoreStage):
    """Routed NoP contention on the op's memory traffic (host numpy)."""
    name = "noc"

    def apply(self, ctx: OpContext) -> None:
        cfg = ctx.cfg
        # sparsity composes like the partition stage: sparse runs model the
        # single-core compressed stream, so there is no multi-core NoP plane
        if noc_kind(cfg) is None or ctx.sp.enabled:
            return
        op, noc = ctx.op, cfg.noc
        n = cfg.num_cores
        dram = host_dram_traffic(cfg, op, self.core(ctx))
        wb = cfg.memory.word_bytes
        dram_bytes = float(dram["dram_ifmap"]
                           + dram["dram_filter"] * ctx.filter_shrink
                           + dram["dram_ofmap_writes"]
                           + dram["dram_ofmap_reads"]) * wb
        flits = np.full(n, float(memory_flits(dram_bytes, n, noc.flit_bytes)))
        stats = eager_noc_delay(
            noc.topology, cfg.mesh_rows, cfg.mesh_cols, flits,
            noc.link_bandwidth_bytes_per_cycle, noc.flit_bytes,
            noc.buffer_flits, cfg.nop_cycles_per_hop, ctx.comp)
        ctx.noc_extra = float(stats["stall"])
        # all-reduce of the op's output matrix (per instance): the batched
        # sweep's payload convention
        ar = allreduce_cycles(
            noc.topology, cfg.mesh_rows, cfg.mesh_cols,
            float(op.M) * float(op.N) * wb,
            noc.link_bandwidth_bytes_per_cycle, noc.flit_bytes,
            noc.buffer_flits, cfg.nop_cycles_per_hop)
        ctx.noc_stats = dict(
            noc_link_util=float(stats["link_util"]),
            noc_max_busy=float(stats["max_busy"]),
            allreduce_cycles=float(ar))


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
