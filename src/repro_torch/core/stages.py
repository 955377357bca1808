"""The simulation pipeline as explicit, pluggable stages; PyTorch port of
`repro.core.stages`.

One GEMM op flows through (paper Fig. 1, left to right):

    mapping -> partition -> sparsity -> sram -> noc -> dram -> layout -> energy

Each stage is a small object with `apply(ctx)` mutating an `OpContext`;
`build_pipeline(fidelity)` selects the DRAM stage: the first-order
bandwidth-overlap model (`fast`), the replay of a synthetic tile-prefetch
stream (`cycle`) or of the op's generated demand trace (`trace`).
`core.engine.simulate_op` / `simulate_network` run ops through it one at a
time, as the reference does.

Where the work sits: the per-op scalar bookkeeping (a few dozen numbers
per op) runs on the host, in Python numbers where the reference computes
on Python numbers and in float32 CPU scalars where it computes in jnp
float32, operation for operation, whatever the pipeline's device. The
request streams and every kernel input live on the pipeline's device
(CUDA unless the caller asks for the CPU): `cycle` and `trace` replay
one stream per gemm op, one replay-kernel launch on CUDA; the layout
stage makes one bank-conflict-kernel launch per gemm op. On CUDA each
launches its kernel or raises; on the CPU the kernel's plain version
runs.

The traced twins below (`traced_gemm_stats`, `traced_op_stats`, ...) run
the same stage math on float32 tensors with a leading design axis, which
is what the batched sweep runs. Every feature is data (`torch.where` on
0/1 selectors) or a static flavor of the call: the `sparsity=` and
`multicore=` dicts and `layout=` carry the layer-wise and row-wise N:M
models, the multi-core partition and the bank-conflict layout stage, so
one call evaluates a mixed dense / sparse / multi-core design group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import dataflow as dfm
from .accelerator import AcceleratorConfig, MemoryConfig, SparsityConfig
from .energy import DEFAULT_ERT, ERT, action_counts, action_counts_raw, energy_pj
from .layout import streaming_layout_extra
from .multicore import best_multicore, best_multicore_cycles_model
from .replay import resolve_device
from .sparsity import (sparse_compute_cycles, sparse_compute_cycles_model,
                       storage_bytes_model, storage_report)
from .workloads import Op

FIDELITIES = ("fast", "cycle", "trace")

_DRAM_REQ_CAP = 16384     # cycle-fidelity request cap per op (scaled beyond)
_CYCLE_GRAN = 512         # cycle-fidelity bytes per request


def host_f32(x) -> torch.Tensor:
    """A number as a float32 scalar on the CPU: what the reference's jnp
    math makes of a Python number (rounded to float32 once)."""
    return torch.tensor(float(x), dtype=torch.float32)


def host_dram_traffic(cfg: AcceleratorConfig, op: Op, core) -> Dict:
    """The capacity-model DRAM traffic of one op instance on `core`:
    float32 CPU scalars, as the reference's per-op `dram_traffic` gives
    them."""
    return dfm.dram_traffic(cfg.dataflow, host_f32(op.M), host_f32(op.N),
                            host_f32(op.K), core.rows, core.cols,
                            cfg.memory)


@dataclasses.dataclass
class OpContext:
    """Mutable working state threaded through the stage pipeline.

    Per-instance quantities (comp, stall, traffic) are for ONE instance of
    the op; the energy/finalize stage multiplies by `op.count`.
    """
    cfg: AcceleratorConfig
    op: Op
    ert: ERT
    sp: SparsityConfig
    # mapping / partition / sparsity
    comp: float = 0.0
    scheme: str = "single"
    util: float = 0.0
    sparse_info: Optional[Dict[str, float]] = None
    filter_shrink: float = 1.0
    # traffic
    sram: Optional[Dict[str, float]] = None
    dram: Optional[Dict[str, torch.Tensor]] = None
    dram_elems: float = 0.0
    dram_bytes: float = 0.0           # per instance
    stall: float = 0.0
    dram_stats: Optional[Dict[str, float]] = None
    layout_extra: float = 0.0
    noc_extra: float = 0.0            # per instance (noc.stage.NocStage)
    noc_stats: Optional[Dict[str, float]] = None
    # finalized totals (x op.count)
    compute_total: float = 0.0
    stall_total: float = 0.0
    noc_total: float = 0.0
    layout_total: float = 0.0
    total: float = 0.0
    sram_reads: float = 0.0
    sram_writes: float = 0.0
    dram_bytes_total: float = 0.0
    energy_total: float = 0.0
    energy_by_action: Optional[Dict[str, float]] = None


class Stage:
    """A pipeline stage. Subclasses set `name` and implement `apply`."""
    name = "stage"

    def apply(self, ctx: OpContext) -> None:
        raise NotImplementedError


class CoreStage(Stage):
    """A stage whose model depends on one core's geometry. `core_index`
    selects the core a heterogeneous mesh is analyzed through; every
    core-dependent stage in one pipeline shares the same index so the
    report describes an actual core, not a mix."""

    def __init__(self, core_index: int = 0):
        self.core_index = core_index

    def core(self, ctx: OpContext):
        return ctx.cfg.cores[self.core_index]


class MappingStage(CoreStage):
    """Single-core dataflow mapping: analytical compute cycles + PE
    utilization (SCALE-Sim v2 runtime equations), exact on integers."""
    name = "mapping"

    def apply(self, ctx: OpContext) -> None:
        op, core, df = ctx.op, self.core(ctx), ctx.cfg.dataflow
        ctx.comp = float(dfm.compute_cycles(df, op.M, op.N, op.K,
                                            core.rows, core.cols))
        ctx.scheme = "single"
        ctx.util = float(dfm.pe_utilization(df, op.M, op.N, op.K,
                                            core.rows, core.cols))


class PartitionStage(Stage):
    """Multi-core partitioning: pick the best spatial/spatio-temporal
    split over the core grid (skipped for single-core or sparse runs,
    matching the paper's feature composition)."""
    name = "partition"

    def apply(self, ctx: OpContext) -> None:
        if ctx.sp.enabled or ctx.cfg.num_cores <= 1:
            return
        op = ctx.op
        mc = best_multicore(ctx.cfg, op.M, op.N, op.K)
        ctx.comp = mc.cycles
        ctx.scheme = f"{mc.scheme}({mc.Pr}x{mc.Pc})"
        ctx.util = min(1.0, op.M * op.N * op.K / max(
            1.0, sum(c.num_pes for c in ctx.cfg.cores) * mc.cycles))


class SparsityStage(CoreStage):
    """N:M weight sparsity: compressed-stream compute cycles + storage
    report; records the filter-traffic shrink applied downstream."""
    name = "sparsity"

    def apply(self, ctx: OpContext) -> None:
        if not ctx.sp.enabled:
            return
        op, core, cfg = ctx.op, self.core(ctx), ctx.cfg
        ctx.comp = float(sparse_compute_cycles(
            cfg.dataflow, op.M, op.N, op.K, core.rows, core.cols, ctx.sp))
        ctx.sparse_info = storage_report(op.M, op.K, ctx.sp,
                                         cfg.memory.word_bytes)
        ctx.scheme = "single"
        ctx.util = min(1.0, op.M * op.N * op.K / max(
            1.0, core.num_pes * ctx.comp * ctx.sp.m / max(ctx.sp.n, 1)))
        ctx.filter_shrink = (ctx.sparse_info["total_bytes"]
                             / max(ctx.sparse_info["original_bytes"], 1.0))


class SramStage(CoreStage):
    """Aggregate SRAM demand counts; sparse filters stream compressed."""
    name = "sram"

    def apply(self, ctx: OpContext) -> None:
        op, core, cfg = ctx.op, self.core(ctx), ctx.cfg
        sram = dfm.sram_traffic(cfg.dataflow, op.M, op.N, op.K,
                                core.rows, core.cols)
        if ctx.filter_shrink != 1.0:
            sram["filter_reads"] = sram["filter_reads"] * ctx.filter_shrink
        ctx.sram = sram


class DramStage(CoreStage):
    """Capacity-based DRAM traffic shared by all fidelities; subclasses
    supply the stall model. The analyzed core comes from `core_index`."""
    name = "dram"

    def apply(self, ctx: OpContext) -> None:
        cfg = ctx.cfg
        dram = host_dram_traffic(cfg, ctx.op, self.core(ctx))
        if ctx.filter_shrink != 1.0:
            dram["dram_filter"] = dram["dram_filter"] * ctx.filter_shrink
        ctx.dram = dram
        ctx.dram_elems = float(dram["dram_ifmap"] + dram["dram_filter"]
                               + dram["dram_ofmap_writes"]
                               + dram["dram_ofmap_reads"])
        ctx.dram_bytes = ctx.dram_elems * cfg.memory.word_bytes
        self.stalls(ctx)

    def stalls(self, ctx: OpContext) -> None:
        raise NotImplementedError


class FastDramStage(DramStage):
    """First-order stall: double-buffered transfer time vs compute, per
    instance (`op.count` scaling happens once, in the energy stage)."""
    name = "dram[fast]"

    def stalls(self, ctx: OpContext) -> None:
        bw = ctx.cfg.dram.bandwidth_bytes_per_cycle * ctx.cfg.dram.channels
        # `dram_stall_cycles_simple` on Python numbers: the difference in
        # float64, its clamp rounded to float32, as the reference's is
        ctx.stall = float(torch.clamp_min(
            host_f32(ctx.dram_bytes / bw - ctx.comp), 0.0))


def _replay_stats(hits, misses, conflicts) -> Dict[str, int]:
    return dict(row_hits=int(hits), row_misses=int(misses),
                row_conflicts=int(conflicts))


class CycleDramStage(DramStage):
    """Cycle-accurate (Ramulator-like) DRAM: a tile-prefetch stream of at
    most `_DRAM_REQ_CAP` requests of 512 bytes through banked channels
    with finite queues, folded and scaled beyond the cap, replayed on
    `device` (one replay-kernel launch per op on CUDA). `engine` selects
    the replay engine (`core.replay.ENGINES`)."""
    name = "dram[cycle]"

    def __init__(self, core_index: int = 0, engine: Optional[str] = None,
                 device="cuda"):
        super().__init__(core_index)
        self.engine = engine
        self.device = torch.device(device)

    def stalls(self, ctx: OpContext) -> None:
        from .dram import simulate_dram, tile_prefetch_trace
        gran = _CYCLE_GRAN
        n_req = max(1, int(ctx.dram_bytes) // gran)
        scale = max(1.0, n_req / _DRAM_REQ_CAP)
        n_sim = min(n_req, _DRAM_REQ_CAP)
        folds = max(1, int(math.ceil(n_sim / 32)))
        t, a, w = tile_prefetch_trace(n_sim * gran // folds, folds,
                                      ctx.comp / max(folds, 1) / scale,
                                      gran, device=self.device)
        res = simulate_dram(t, a, w, ctx.cfg.dram, gran, engine=self.engine)
        # one device sync for every number the report keeps
        vals = torch.stack([x.to(torch.float64) for x in (
            res.stall_cycles, res.throughput, res.latency.mean(),
            res.row_hits, res.row_misses, res.row_conflicts)]).tolist()
        ctx.stall = vals[0] * scale
        ctx.dram_stats = dict(**_replay_stats(*vals[3:]),
                              throughput_Bpc=vals[1], mean_latency=vals[2],
                              scaled_by=scale)


class TraceDramStage(DramStage):
    """Trace fidelity: the demand-request stream is synthesized from the
    mapping itself (`trace.generator`: tile schedule, double-buffered
    prefetch deadlines, per-dataflow operand walks, layout-aware
    addresses) and replayed on `device` (one replay-kernel launch per op
    on CUDA). Unlike `CycleDramStage`'s synthetic linear prefetch,
    row-buffer statistics here respond to dataflow, tiling and layout."""
    name = "dram[trace]"

    def __init__(self, core_index: int = 0, spec=None,
                 engine: Optional[str] = None, device="cuda"):
        super().__init__(core_index)
        if spec is None:
            from ..trace.generator import DEFAULT_SPEC
            spec = DEFAULT_SPEC
        self.spec = spec
        self.engine = engine
        self.device = torch.device(device)

    def stalls(self, ctx: OpContext) -> None:
        from ..trace.generator import gemm_trace_stats
        op, cfg = ctx.op, ctx.cfg
        core = self.core(ctx)
        dram = ctx.dram
        res = gemm_trace_stats(
            cfg.dataflow, op.M, op.N, op.K, core.rows, core.cols, ctx.comp,
            dram["dram_ifmap"], dram["dram_filter"],
            dram["dram_ofmap_writes"], dram["dram_ofmap_reads"],
            cfg.dram, cfg.memory.word_bytes, self.spec,
            engine=self.engine, device=self.device)
        keys = ("stall_cycles", "row_hit_rate", "throughput_Bpc",
                "mean_latency", "scaled_by", "row_hits", "row_misses",
                "row_conflicts")
        vals = dict(zip(keys, torch.stack(
            [res[k].to(torch.float64) for k in keys]).tolist()))
        ctx.stall = vals["stall_cycles"]
        ctx.dram_stats = dict(
            **_replay_stats(vals["row_hits"], vals["row_misses"],
                            vals["row_conflicts"]),
            **{k: vals[k] for k in ("row_hit_rate", "throughput_Bpc",
                                    "mean_latency", "scaled_by")})


class LayoutStage(CoreStage):
    """On-chip bank-conflict slowdown on the streaming operand, through
    the shared model (`layout.streaming_layout_extra`) on `device`: one
    bank-conflict-kernel launch per op on CUDA."""
    name = "layout"

    def __init__(self, core_index: int = 0, device="cuda"):
        super().__init__(core_index)
        self.device = torch.device(device)

    def apply(self, ctx: OpContext) -> None:
        cfg, op = ctx.cfg, ctx.op
        if not cfg.layout.enabled:
            return
        core = self.core(ctx)

        def dev_f32(x):
            return torch.tensor(float(x), dtype=torch.float32,
                                device=self.device)

        ctx.layout_extra = float(streaming_layout_extra(
            cfg.layout, dev_f32(core.rows), dev_f32(ctx.comp),
            dev_f32(max(1, op.N)), cfg.memory.word_bytes, r_cap=core.rows))


class EnergyStage(Stage):
    """Finalize: x op.count, action counts, ERT energy lookup."""
    name = "energy"

    def apply(self, ctx: OpContext) -> None:
        op, cfg = ctx.op, ctx.cfg
        ctx.compute_total = ctx.comp * op.count
        ctx.stall_total = ctx.stall * op.count
        ctx.noc_total = ctx.noc_extra * op.count
        ctx.layout_total = ctx.layout_extra * op.count
        ctx.total = (ctx.compute_total + ctx.stall_total + ctx.noc_total
                     + ctx.layout_total)
        sram = ctx.sram
        ctx.sram_reads = float(sram["ifmap_reads"] + sram["filter_reads"]
                               + sram["ofmap_reads"]) * op.count
        ctx.sram_writes = float(sram["ofmap_writes"]) * op.count
        ctx.dram_bytes_total = ctx.dram_bytes * op.count
        counts = action_counts(
            cfg, cycles=ctx.compute_total, macs=op.macs,
            ifmap_reads=float(sram["ifmap_reads"]) * op.count,
            filter_reads=float(sram["filter_reads"]) * op.count,
            ofmap_writes=float(sram["ofmap_writes"]) * op.count,
            ofmap_reads=float(sram["ofmap_reads"]) * op.count,
            dram_bytes=ctx.dram_bytes_total,
            l2_reads=(ctx.dram_elems * op.count
                      if cfg.memory.l2_sram_bytes else 0.0))
        ctx.energy_total, ctx.energy_by_action = _energy(counts, ctx.ert)


def _energy(counts, ert: ERT):
    """(total pJ, {action: pJ}) as Python floats."""
    e = energy_pj(counts, ert)
    return float(e["total"]), {k: float(v) for k, v in e.items()
                               if k != "total"}


def build_pipeline(fidelity: str = "fast", *, core_index: int = 0,
                   trace_spec=None, engine: Optional[str] = None,
                   device=None) -> Tuple[Stage, ...]:
    """The canonical GEMM pipeline for a fidelity level.

    core_index: the core whose geometry every core-dependent stage
    (mapping, sparsity, sram, noc, dram, layout) analyzes. trace_spec:
    optional `trace.generator.TraceSpec` for the trace fidelity. engine:
    DRAM replay engine for the cycle/trace stages (`core.replay.ENGINES`;
    None = the chunked replay). device: where the request streams and
    kernel inputs live, CUDA unless the caller asks for the CPU (raises
    without a card).
    """
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                         f"got {fidelity!r}")
    device = resolve_device(device)
    if fidelity == "cycle":
        dram: DramStage = CycleDramStage(core_index, engine, device)
    elif fidelity == "trace":
        dram = TraceDramStage(core_index, trace_spec, engine, device)
    else:
        dram = FastDramStage(core_index)
    from ..noc.stage import NocStage    # lazy: noc depends on core.stages
    return (MappingStage(core_index), PartitionStage(),
            SparsityStage(core_index), SramStage(core_index),
            NocStage(core_index), dram, LayoutStage(core_index, device),
            EnergyStage())


def pipeline_engine(pipeline: Sequence[Stage]) -> str:
    """Runtime replay-engine label of a pipeline's DRAM stage: '' for the
    fast model (it replays nothing); otherwise "cuda", "torch:plain" or
    "reference" (`core.replay.resolve_engine_runtime` on the stage's
    device), so reports record what actually ran."""
    from . import replay as _rp
    for s in pipeline:
        if isinstance(s, (CycleDramStage, TraceDramStage)):
            return _rp.resolve_engine_runtime(s.engine, s.device)
    return ""


def resolve_sparsity(cfg: AcceleratorConfig, op: Op) -> SparsityConfig:
    """Per-op N:M override (layer-wise sparsity ratios)."""
    sp = cfg.sparsity
    if op.sparsity_nm is not None:
        sp = SparsityConfig(enabled=True, n=op.sparsity_nm[0],
                            m=op.sparsity_nm[1], row_wise=sp.row_wise,
                            representation=sp.representation)
    return sp


def run_gemm_pipeline(cfg: AcceleratorConfig, op: Op,
                      pipeline: Sequence[Stage],
                      ert: ERT = DEFAULT_ERT) -> OpContext:
    ctx = OpContext(cfg=cfg, op=op, ert=ert, sp=resolve_sparsity(cfg, op))
    for stage in pipeline:
        stage.apply(ctx)
    return ctx


def run_vector(cfg: AcceleratorConfig, op: Op,
               ert: ERT = DEFAULT_ERT) -> OpContext:
    """Vector ops bypass the array pipeline and run on the SIMD unit; every
    component (cycles, traffic, action counts) scales with `op.count`."""
    core = cfg.cores[0]
    wb = cfg.memory.word_bytes
    ctx = OpContext(cfg=cfg, op=op, ert=ert, sp=cfg.sparsity)
    cyc = float(dfm.simd_cycles(op.vector_elems, core.simd_lanes,
                                core.simd_latency)) * op.count
    elems = op.vector_elems * op.count
    ctx.comp = cyc
    ctx.compute_total = cyc
    ctx.total = cyc
    ctx.sram_reads = elems
    ctx.sram_writes = elems
    ctx.dram_bytes_total = elems * wb
    counts = action_counts(cfg, cycles=cyc, macs=0.0,
                           ifmap_reads=elems, filter_reads=0.0,
                           ofmap_writes=elems, ofmap_reads=0.0,
                           dram_bytes=ctx.dram_bytes_total)
    ctx.energy_total, ctx.energy_by_action = _energy(counts, ert)
    return ctx


# --------------------------------------------------------------------------
# Traced twins: the same stage math on tensors with a leading design axis.
# --------------------------------------------------------------------------

_NO_SPILL_BYTES = 1 << 62     # "infinite" psum SRAM: legacy traced semantics


def traced_memory(sram_elems, word_bytes=2, *, ifmap_elems=None,
                  filter_elems=None, ofmap_elems=None,
                  l2_bytes=0) -> MemoryConfig:
    """A MemoryConfig whose fields may be tensors. With only `sram_elems`,
    reproduces the legacy traced model: both operand SRAMs sized to
    sram_elems, psums never spill."""
    wb = word_bytes
    return MemoryConfig(
        ifmap_sram_bytes=(ifmap_elems if ifmap_elems is not None
                          else sram_elems) * wb,
        filter_sram_bytes=(filter_elems if filter_elems is not None
                           else sram_elems) * wb,
        ofmap_sram_bytes=(ofmap_elems * wb if ofmap_elems is not None
                          else _NO_SPILL_BYTES),
        l2_sram_bytes=l2_bytes, word_bytes=wb)


def traced_gemm_stats(dataflow: str, M, N, K, R, C, mem: MemoryConfig,
                      bw_bytes_per_cycle) -> Dict[str, torch.Tensor]:
    """mapping + sram + dram(fast) stages on tensors."""
    comp = dfm.compute_cycles(dataflow, M, N, K, R, C)
    util = dfm.pe_utilization(dataflow, M, N, K, R, C)
    sram = dfm.sram_traffic(dataflow, M, N, K, R, C)
    dram = dfm.dram_traffic(dataflow, M, N, K, R, C, mem)
    dram_elems = (dram["dram_ifmap"] + dram["dram_filter"]
                  + dram["dram_ofmap_writes"] + dram["dram_ofmap_reads"])
    dram_bytes = dram_elems * mem.word_bytes
    stall = dfm.dram_stall_cycles_simple(dram_bytes, comp,
                                         bw_bytes_per_cycle)
    return dict(compute_cycles=comp, stall_cycles=stall,
                total_cycles=comp + stall, utilization=util,
                dram_bytes=dram_bytes, dram_elems=dram_elems, **sram)


def traced_vector_stats(elems, lanes, latency, word_bytes
                        ) -> Dict[str, torch.Tensor]:
    """SIMD sidecar (per instance; callers scale by count)."""
    cyc = dfm.simd_cycles(elems, lanes, latency)
    return dict(compute_cycles=cyc, dram_bytes=elems * word_bytes)


def traced_energy_counts(*, R, C, mem: MemoryConfig, cycles, macs,
                         ifmap_reads, filter_reads, ofmap_writes,
                         ofmap_reads, dram_bytes, l2_reads=0.0,
                         row_bytes: int = 64, pes=None,
                         dim32=None) -> Dict[str, torch.Tensor]:
    """The energy stage's action counts with tensor-valued config fields;
    identical formulas to the reference's `energy.action_counts`. `mem`
    must carry real SRAM sizes (not the no-spill sentinel)."""
    sram_kib = (mem.ifmap_sram_bytes + mem.filter_sram_bytes
                + mem.ofmap_sram_bytes) / 1024.0
    if pes is None:
        pes = R * C
    if dim32 is None:
        dim32 = torch.maximum(R, C) / 32.0
    return action_counts_raw(
        pes=pes, dim32=dim32, sram_kib=sram_kib,
        word_bytes=mem.word_bytes, cycles=cycles, macs=macs,
        ifmap_reads=ifmap_reads, filter_reads=filter_reads,
        ofmap_writes=ofmap_writes, ofmap_reads=ofmap_reads,
        dram_bytes=dram_bytes, l2_reads=l2_reads, row_bytes=row_bytes)


def traced_comp_traffic(dataflow: str, M, N, K, R, C, mem: MemoryConfig, *,
                        sparsity: Optional[Dict] = None,
                        multicore: Optional[Dict] = None):
    """Effective compute cycles + (shrunk) SRAM/DRAM traffic.

    Mirrors the stage pipeline's feature composition exactly: the
    partition stage overrides single-core compute when the design has
    multiple cores, and the sparsity stage overrides both (paper
    semantics: sparse runs use the single-core compressed stream).

    sparsity:  {'en', 'n', 'm', 'rw'} tensors (en/rw are 0/1 selectors)
               plus the static 'representation' string.
    multicore: {'rows', 'cols', 'hops'} per-core tensors (core axis last,
               length Pr*Pc), 'nop' cycles-per-hop, and static 'Pr'/'Pc'
               grid shape.

    Returns (comp, sram dict, dram dict, filter_shrink).
    """
    comp = dfm.compute_cycles(dataflow, M, N, K, R, C)
    if multicore is not None:
        comp = best_multicore_cycles_model(
            dataflow, M, N, K, multicore["rows"], multicore["cols"],
            multicore["hops"], multicore["nop"], multicore["Pr"],
            multicore["Pc"])
    shrink = 1.0
    sram = dfm.sram_traffic(dataflow, M, N, K, R, C)
    dram = dfm.dram_traffic(dataflow, M, N, K, R, C, mem)
    if sparsity is not None:
        en, n, m, rw = (sparsity["en"], sparsity["n"], sparsity["m"],
                        sparsity["rw"])
        comp_sp = sparse_compute_cycles_model(dataflow, M, N, K, R, C,
                                              n, m, rw, enabled=en)
        comp = torch.where(torch.as_tensor(en) != 0, comp_sp, comp)
        orig, _, _, total = storage_bytes_model(
            M, K, n, m, rw, sparsity["representation"], mem.word_bytes,
            enabled=en)
        shrink = total / torch.clamp_min(orig, 1.0)
        sram = dict(sram, filter_reads=sram["filter_reads"] * shrink)
        dram = dict(dram, dram_filter=dram["dram_filter"] * shrink)
    # without sparsity the filter shrink is exactly 1: the reference
    # multiplies by f32(1.0), which changes no value
    return comp, sram, dram, shrink


def traced_op_stats(dataflow: str, M, N, K, R, C, mem: MemoryConfig,
                    bw_bytes_per_cycle, *,
                    sparsity: Optional[Dict] = None,
                    multicore: Optional[Dict] = None,
                    layout: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The fast-fidelity gemm pipeline on tensors (per op instance;
    callers scale by count). `layout`: {'cfg': LayoutConfig (static),
    'r_cap': static bound on R}, or None to skip the layout stage. See
    `traced_comp_traffic` for the sparsity/multicore parameters."""
    comp, sram, dram, shrink = traced_comp_traffic(
        dataflow, M, N, K, R, C, mem, sparsity=sparsity,
        multicore=multicore)
    dram_elems = (dram["dram_ifmap"] + dram["dram_filter"]
                  + dram["dram_ofmap_writes"] + dram["dram_ofmap_reads"])
    dram_bytes = dram_elems * mem.word_bytes
    stall = dfm.dram_stall_cycles_simple(dram_bytes, comp,
                                         bw_bytes_per_cycle)
    extra = torch.zeros_like(comp)
    if layout is not None:
        stride = torch.clamp_min(1.0 * N, 1.0)
        extra = streaming_layout_extra(layout["cfg"], R, comp, stride,
                                       mem.word_bytes, r_cap=layout["r_cap"])
    return dict(compute_cycles=comp, stall_cycles=stall,
                layout_extra_cycles=extra, dram_bytes=dram_bytes,
                dram_elems=dram_elems, filter_shrink=shrink, **sram)
