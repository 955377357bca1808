"""The `Simulator` facade and the batched design sweep (PyTorch port of
`repro.api.simulator`).

    sim = Simulator("paper-32", fidelity="fast")      # on the GPU
    report = sim.run(resnet18())                        # NetworkReport
    res = sim.sweep(configs, ops)                       # batched DSE

A `Simulator` binds (config, fidelity, ERT, device) once; `run`/`run_op`
go through the per-op stage pipeline (`core/stages.py`), `sweep` through
a one-workload `api.study.Study`, optionally sharded over a mesh of this
process's devices (`launch/mesh.py::make_device_mesh`): each group's
designs are cut into one contiguous block a device, and every device
runs its block, kernels and all. The sweep is bound by the host's
dispatch, which every block repeats: on four H100s the feature sweep's
mesh run took 4.5x one card's wall (PERF.md). One process a card, each
on its own share of the cells (a farm worker with `--device cuda:i`
each), is the fast layout for a host of several cards; the mesh exists
for parity with the reference's `sweep(mesh=)`.

A sweep stacks per-design config scalars into float32 columns with a
leading design axis and runs the traced stage math on all designs and ops
at once (designs x ops broadcasting stands in for the reference's vmap).
Sparsity (layer-wise and row-wise N:M, per-op overrides), the multi-core
partition (homogeneous or heterogeneous cores, NoP hop offsets) and the
data-layout stage run inside that math; the layout stage's per-cycle
slowdowns come from one bank-conflict kernel launch per group. At trace
fidelity the first-order stall is replaced by the stall of each op's
generated demand stream: one stream per unique stream-determining design
(`sdesign`), generated as one (streams, ops, cap) batch from the
effective compute window and the sparsity-shrunk traffic, decoded in one
call and replayed in one kernel launch, then gathered back per design
through `smap`. On a NoC pod (the routed NoC plane enabled on a
multi-core group) the per-core hops are the routed ones, and the
flit/credit link model (`noc.router.noc_delay_model`) adds its queueing
stall to each design's total and reports link utilization and the ring
all-reduce makespan.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import stages as st
from ..core.accelerator import (AcceleratorConfig, DramConfig, LayoutConfig,
                                MemoryConfig, SparsityConfig)
from ..core.energy import DEFAULT_ERT, ERT, energy_pj
from ..core.engine import (_ENERGY_GROUPS, NetworkReport, OpResult,
                           simulate_network, simulate_op)
from ..core.multicore import effective_nop_hops
from ..core.workloads import PAPER_WORKLOADS, Op
from ..noc.topology import noc_kind
from .presets import get_preset

ConfigLike = Union[AcceleratorConfig, dict, str]
WorkloadLike = Union[Sequence[Op], str]


def as_config(c: ConfigLike) -> AcceleratorConfig:
    """Preset name | nested dict | AcceleratorConfig -> AcceleratorConfig."""
    if isinstance(c, AcceleratorConfig):
        return c
    if isinstance(c, str):
        return get_preset(c)
    if isinstance(c, dict):
        return AcceleratorConfig.from_dict(c)
    raise TypeError(f"cannot build AcceleratorConfig from {type(c)!r}")


def as_workload(w: WorkloadLike) -> List[Op]:
    """Op sequence or paper-workload name ('resnet18', 'vit_base', ...)."""
    if isinstance(w, str):
        if w not in PAPER_WORKLOADS:
            raise KeyError(f"unknown workload {w!r}; "
                           f"available: {sorted(PAPER_WORKLOADS)}")
        return PAPER_WORKLOADS[w]()
    return list(w)


@dataclasses.dataclass
class SweepResult:
    """Per-design-point totals over one workload (arrays of shape (n,))."""
    configs: List[AcceleratorConfig]
    total_cycles: np.ndarray
    compute_cycles: np.ndarray
    stall_cycles: np.ndarray
    dram_bytes: np.ndarray
    energy_pj: np.ndarray
    utilization: np.ndarray
    batched: bool = True          # False when the per-op engine ran
    # runtime replay-engine label of the sweep's DRAM replay ('' for
    # fidelities that replay nothing), see NetworkReport.engine
    engine: str = ""

    @property
    def edp(self) -> np.ndarray:
        return self.energy_pj * 1e-9 * self.total_cycles

    def __len__(self) -> int:
        return len(self.configs)

    def argbest(self, objective: str = "edp") -> int:
        key = dict(edp=self.edp, latency=self.total_cycles,
                   cycles=self.total_cycles, energy=self.energy_pj)
        return int(np.argmin(key[objective]))

    def best(self, objective: str = "edp") -> AcceleratorConfig:
        return self.configs[self.argbest(objective)]


class Simulator:
    """Unified simulation session: config + fidelity + ERT + device, one
    pipeline.

    fidelity: 'fast' (first-order DRAM stalls), 'cycle' (the DRAM replay
    of a synthetic tile-prefetch stream per op) or 'trace' (each op's
    generated demand trace through the same replay).

    trace_spec: optional `trace.generator.TraceSpec`, shared by the per-op
    pipeline and the batched sweep. core_index: the core a heterogeneous
    mesh is analyzed through. engine: DRAM replay engine for the
    cycle/trace fidelities (None: the chunked replay; "reference": the
    per-request scan).

    device: where request streams and kernel inputs live, CUDA unless the
    caller asks for the CPU (`device="cpu"` runs each kernel's plain
    version); without a card the default raises. `sweep(mesh=)` runs the
    batched groups over a mesh of devices instead; the session's device
    must then be one of them.
    """

    def __init__(self, config: ConfigLike = "paper-32", *,
                 fidelity: str = "fast", ert: ERT = DEFAULT_ERT,
                 trace_spec=None, core_index: int = 0,
                 engine: Optional[str] = None, device=None):
        from ..core import replay as _rp
        if fidelity not in st.FIDELITIES:
            raise ValueError(f"fidelity must be one of {st.FIDELITIES}")
        self.config = as_config(config)
        self.fidelity = fidelity
        self.ert = ert
        self.core_index = core_index
        self.engine = _rp.resolve_engine(engine)
        self.device = _rp.resolve_device(device)
        if trace_spec is None and fidelity == "trace":
            from ..trace.generator import DEFAULT_SPEC
            trace_spec = DEFAULT_SPEC
        self.trace_spec = trace_spec
        self.pipeline = st.build_pipeline(fidelity, core_index=core_index,
                                          trace_spec=trace_spec,
                                          engine=self.engine,
                                          device=self.device)

    @classmethod
    def from_preset(cls, name: str, *, fidelity: str = "fast",
                    ert: ERT = DEFAULT_ERT, trace_spec=None,
                    core_index: int = 0, engine: Optional[str] = None,
                    device=None, **kw) -> "Simulator":
        return cls(get_preset(name, **kw), fidelity=fidelity, ert=ert,
                   trace_spec=trace_spec, core_index=core_index,
                   engine=engine, device=device)

    def with_(self, **config_fields) -> "Simulator":
        """New session with dataclass fields replaced on the config."""
        return Simulator(self.config.with_(**config_fields),
                         fidelity=self.fidelity, ert=self.ert,
                         trace_spec=self.trace_spec,
                         core_index=self.core_index, engine=self.engine,
                         device=self.device)

    def stage_names(self) -> List[str]:
        return [s.name for s in self.pipeline]

    # ---- single-config entry points ----------------------------------------
    def run_op(self, op: Op) -> OpResult:
        return simulate_op(self.config, op, ert=self.ert,
                           pipeline=self.pipeline)

    def run(self, workload: WorkloadLike) -> NetworkReport:
        return simulate_network(self.config, as_workload(workload),
                                ert=self.ert, pipeline=self.pipeline)

    def run_lm(self, model_cfg, *, seq: int, batch: int, mode: str,
               cache_len: Optional[int] = None) -> NetworkReport:
        """Model one step of an LM architecture (a model config with the
        reference's `ModelConfig` fields, see `core.workloads.lm_ops`) on
        this accelerator."""
        from ..core.workloads import lm_ops
        return self.run(lm_ops(model_cfg, seq=seq, batch=batch, mode=mode,
                               cache_len=cache_len))

    def seconds(self, cycles: float) -> float:
        """Accelerator cycles -> wall seconds at this config's clock."""
        return cycles / (self.config.clock_ghz * 1e9)

    @staticmethod
    def wave_cost(prefill_rep: NetworkReport, decode_rep: NetworkReport,
                  gen_len: int) -> tuple:
        """(cycles, pJ) for one serving wave: a prefill plus gen_len - 1
        decode steps (the first generated token comes out of prefill)."""
        steps = max(gen_len - 1, 0)
        return (prefill_rep.total_cycles + decode_rep.total_cycles * steps,
                prefill_rep.energy_pj + decode_rep.energy_pj * steps)

    # ---- batched sweep -------------------------------------------------------
    def sweep(self, configs: Sequence[ConfigLike], workload: WorkloadLike,
              *, mesh=None, force_fallback: bool = False) -> SweepResult:
        """Simulate `workload` on every config through a one-workload
        `api.study.Study` on this session's device: one batched call per
        static flavor group at 'fast' and 'trace'; 'cycle' runs through
        the per-op engine. mesh: shard each group's design axis over a
        mesh of devices (`launch/mesh.py::make_device_mesh`), the grid
        padded to a multiple of mesh.size. force_fallback: run every cell
        through the per-op engine (the differential-parity reference)."""
        from .study import Study
        cfgs = [as_config(c) for c in configs]
        if not cfgs:
            empty = np.zeros(0)
            return SweepResult(configs=[], batched=True,
                               **{k: empty for k in
                                  ("total_cycles", "compute_cycles",
                                   "stall_cycles", "dram_bytes",
                                   "energy_pj", "utilization")})
        frame = (Study()
                 .designs(cfgs)
                 .workloads({"workload": as_workload(workload)})
                 .fidelity(self.fidelity)
                 .options(ert=self.ert, engine=self.engine,
                          trace_spec=self.trace_spec,
                          core_index=self.core_index,
                          force_fallback=force_fallback)
                 .run(device=self.device, mesh=mesh))
        return SweepResult(
            configs=cfgs,
            batched=bool(np.all(frame["batched"] > 0)),
            engine=str(frame.meta.get("engine", "")),
            **{k: frame[k] for k in ("total_cycles", "compute_cycles",
                                     "stall_cycles", "dram_bytes",
                                     "energy_pj", "utilization")})


def _pow2_cap(n: int) -> int:
    """Smallest power of two >= n (the static layout-window row bound)."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass(frozen=True)
class _Flavor:
    """The static structure one sweep group shares: the core grid, whether
    any design or op is sparse, the sparse representation, the layout
    stage (its config and row bound r_cap, or None when off) and the NoC
    topology (None unless the routed plane is on and there are several
    cores)."""
    Pr: int
    Pc: int
    with_sparsity: bool
    representation: str
    layout: Optional[LayoutConfig]
    r_cap: int
    noc: Optional[str]

    @property
    def num_cores(self) -> int:
        return self.Pr * self.Pc


def _flavor(cfgs: Sequence[AcceleratorConfig], ops: Sequence[Op],
            core_index: int = 0) -> _Flavor:
    """The group's flavor, validating what the Study plan guarantees: one
    core grid, layout on or off throughout and one NoC kind. A per-op N:M
    override must form a valid SparsityConfig with every design's row_wise
    flag, as the per-op pipeline requires (ValueError otherwise). The
    layout row bound follows the analysed core `core_index`."""
    Pr, Pc = cfgs[0].mesh_rows, cfgs[0].mesh_cols
    if any((c.mesh_rows, c.mesh_cols) != (Pr, Pc) for c in cfgs):
        raise ValueError("sweep group mixes core-grid shapes")
    with_layout = cfgs[0].layout.enabled
    if any(c.layout.enabled != with_layout for c in cfgs):
        raise ValueError(
            "sweep group mixes layout-enabled and -disabled designs")
    kinds = {noc_kind(c) for c in cfgs}
    if len(kinds) > 1:
        raise ValueError("sweep group mixes NoC topologies/enablement")
    gemms = [o for o in ops if o.kind == "gemm"]
    for o in gemms:
        if o.sparsity_nm is not None:
            for rw in {c.sparsity.row_wise for c in cfgs}:
                SparsityConfig(enabled=True, n=o.sparsity_nm[0],
                               m=o.sparsity_nm[1], row_wise=rw)
    return _Flavor(
        Pr=Pr, Pc=Pc,
        with_sparsity=(any(c.sparsity.enabled for c in cfgs)
                       or any(o.sparsity_nm is not None for o in gemms)),
        representation=cfgs[0].sparsity.representation,
        layout=(dataclasses.replace(cfgs[0].layout, enabled=True)
                if with_layout else None),
        r_cap=(_pow2_cap(max(c.cores[core_index].rows for c in cfgs))
               if with_layout else 0),
        noc=kinds.pop())


def _columns(cfgs: Sequence[AcceleratorConfig], fl: _Flavor, device,
             core_index: int = 0):
    """float32 design columns: (designs, 1) per scalar field, which
    broadcasts against the (ops,) workload arrays the way the reference
    vmaps over designs, and (designs, 1, cores) per per-core field (the
    core axis last). The single-core fields R and C are those of core
    `core_index`; the SIMD fields stay core 0's, as in the reference. On
    a NoC pod the per-core hops are the routed ones and the link
    parameters are columns too."""
    cols = {
        "R": [c.cores[core_index].rows for c in cfgs],
        "C": [c.cores[core_index].cols for c in cfgs],
        "lanes": [c.cores[0].simd_lanes for c in cfgs],
        "lat": [c.cores[0].simd_latency for c in cfgs],
        "if_b": [c.memory.ifmap_sram_bytes for c in cfgs],
        "f_b": [c.memory.filter_sram_bytes for c in cfgs],
        "o_b": [c.memory.ofmap_sram_bytes for c in cfgs],
        "l2_b": [c.memory.l2_sram_bytes for c in cfgs],
        "bw": [c.dram.bandwidth_bytes_per_cycle * c.dram.channels
               for c in cfgs],
    }
    if fl.with_sparsity:
        cols["sp_en"] = [1.0 if c.sparsity.enabled else 0.0 for c in cfgs]
        cols["sp_n"] = [c.sparsity.n for c in cfgs]
        cols["sp_m"] = [c.sparsity.m for c in cfgs]
        cols["sp_rw"] = [1.0 if c.sparsity.row_wise else 0.0 for c in cfgs]
    if fl.num_cores > 1:
        cols["mc_R"] = [[k.rows for k in c.cores] for c in cfgs]
        cols["mc_C"] = [[k.cols for k in c.cores] for c in cfgs]
        cols["mc_hops"] = [list(effective_nop_hops(c)) for c in cfgs]
        cols["nop"] = [c.nop_cycles_per_hop for c in cfgs]
    if fl.noc is not None:
        cols["noc_bw"] = [c.noc.link_bandwidth_bytes_per_cycle for c in cfgs]
        cols["noc_flit"] = [c.noc.flit_bytes for c in cfgs]
        cols["noc_buf"] = [c.noc.buffer_flits for c in cfgs]
    out = {}
    for k, vals in cols.items():
        v = torch.tensor(np.asarray(vals, np.float32), device=device)
        out[k] = v[:, None] if v.dim() == 1 else v[:, None, :]
    return out


def _mem(d, word_bytes: int) -> MemoryConfig:
    return MemoryConfig(ifmap_sram_bytes=d["if_b"], filter_sram_bytes=d["f_b"],
                        ofmap_sram_bytes=d["o_b"], l2_sram_bytes=d["l2_b"],
                        word_bytes=word_bytes)


def _features(d, g, fl: _Flavor):
    """The traced feature dicts of a design group for
    `stages.traced_comp_traffic`. Per-op N:M overrides (`Op.sparsity_nm`)
    mirror the per-op pipeline: the op's n:m wins and forces the sparsity
    stage on."""
    sp = mc = None
    if fl.with_sparsity:
        ov, on, om = g["ov"], g["on"], g["om"]
        sp = dict(en=torch.maximum(d["sp_en"], ov),
                  n=torch.where(ov > 0, on, d["sp_n"]),
                  m=torch.where(ov > 0, om, d["sp_m"]),
                  rw=d["sp_rw"], representation=fl.representation)
    if fl.num_cores > 1:
        mc = dict(rows=d["mc_R"], cols=d["mc_C"], hops=d["mc_hops"],
                  nop=d["nop"], Pr=fl.Pr, Pc=fl.Pc)
    return sp, mc


def _stream_dedup(cfgs: Sequence[AcceleratorConfig]):
    """(sidx, smap): the design index of each unique demand stream and the
    stream id of each design. A design's stream is fully determined by
    (array geometry, the hops its partition sees, memory sizing,
    sparsity, core grid), so designs that differ only in bandwidth, SIMD,
    energy, layout or NoC link terms share one replay. The hops are the
    effective ones: routed on a NoC pod, the config's otherwise."""
    seen: Dict[tuple, int] = {}
    sidx: List[int] = []
    smap: List[int] = []
    for i, c in enumerate(cfgs):
        k = (tuple((k_.rows, k_.cols) for k_ in c.cores),
             tuple(effective_nop_hops(c).tolist()),
             c.mesh_rows, c.mesh_cols, c.memory,
             (c.sparsity.enabled, c.sparsity.n, c.sparsity.m,
              c.sparsity.row_wise, c.sparsity.representation),
             c.nop_cycles_per_hop)
        if k not in seen:
            seen[k] = len(sidx)
            sidx.append(i)
        smap.append(seen[k])
    return sidx, smap


def _gemm_arrays(ops: Sequence[Op], device):
    gemms = [o for o in ops if o.kind == "gemm"]
    vecs = [o for o in ops if o.kind == "vector"]

    def col(vals):
        return torch.tensor(np.asarray(vals, np.float32).reshape(-1),
                            device=device)

    nm = [o.sparsity_nm for o in gemms]
    return dict(M=col([o.M for o in gemms]), N=col([o.N for o in gemms]),
                K=col([o.K for o in gemms]), cnt=col([o.count for o in gemms]),
                ov=col([0.0 if x is None else 1.0 for x in nm]),
                on=col([1.0 if x is None else x[0] for x in nm]),
                om=col([1.0 if x is None else x[1] for x in nm]),
                velems=col([o.vector_elems for o in vecs]),
                vcnt=col([o.count for o in vecs]))


def decoded_streams(cfgs: Sequence[AcceleratorConfig], ops: Sequence[Op],
                    dataflow: str, word_bytes: int, dram: DramConfig, spec,
                    device, core_index: int = 0,
                    fl: Optional[_Flavor] = None):
    """Generate and decode the demand streams of every unique stream
    design x gemm op, driven by each op's effective compute window and
    its sparsity-shrunk DRAM traffic: returns (t, flat_bank, ch, row,
    is_write, valid) of shape (streams, ops, cap), the (streams, ops)
    compression `scale` and the design -> stream map `smap`. `fl`: the
    flavor of the whole group when `cfgs` is one block of it. The
    streams' (streams, ops) inputs and per-stream factors are evaluated
    on the host, where their hundred-odd small ops cost a few
    microseconds each (on a card each is a launch); on a CUDA `device`
    one streams-kernel launch then generates, orders and decodes every
    slot (`kernels.streams`)."""
    from ..kernels.streams import decoded_request_streams
    host = torch.device("cpu")
    fl = fl or _flavor(cfgs, ops, core_index)
    sidx, smap = _stream_dedup(cfgs)
    d = _columns([cfgs[i] for i in sidx], fl, host, core_index)
    g = _gemm_arrays(ops, host)
    M, N, K = g["M"], g["N"], g["K"]
    sp, mc = _features(d, g, fl)
    comp, _, dr, _ = st.traced_comp_traffic(dataflow, M, N, K, d["R"], d["C"],
                                            _mem(d, word_bytes),
                                            sparsity=sp, multicore=mc)
    streams, scale = decoded_request_streams(
        dataflow, M, N, K, d["R"], d["C"], comp, dr["dram_ifmap"],
        dr["dram_filter"], dr["dram_ofmap_writes"], dr["dram_ofmap_reads"],
        word_bytes, spec, dram, device)
    return streams, scale, torch.tensor(smap, dtype=torch.int64,
                                        device=device)


def _trace_stalls(cfgs, ops, dataflow, word_bytes, dram, spec, engine,
                  device, core_index: int = 0, fl: Optional[_Flavor] = None):
    """(designs, ops) cycle-accurate stalls: one batched replay of every
    unique stream, scaled and gathered back per design."""
    from ..core.dram import replay_requests
    streams, scale, smap = decoded_streams(cfgs, ops, dataflow, word_bytes,
                                           dram, spec, device, core_index,
                                           fl)
    stall = replay_requests(*streams, dram, spec.gran_bytes,
                            engine=engine).stall_cycles
    return (stall * scale)[smap]


def _design_metrics(d, g, dataflow: str, word_bytes: int, ert: ERT,
                    fl: _Flavor, trace_stall=None) -> Dict[str, torch.Tensor]:
    """Per-design totals over the workload: `d` holds the design columns,
    `g` the (ops,) workload arrays. The reference's per-design
    `one_design`, with the design axis leading."""
    n_designs = d["R"].shape[0]
    M, N, K, cnt = g["M"], g["N"], g["K"], g["cnt"]
    velems, vcnt = g["velems"], g["vcnt"]
    mem = _mem(d, word_bytes)
    R, C = d["R"], d["C"]

    def total(x):
        """Sum over the op axis -> (designs,)."""
        if not isinstance(x, torch.Tensor):        # a constant-0 action
            return torch.zeros(n_designs, device=R.device) + x
        return torch.broadcast_to(x, (n_designs, x.shape[-1])).sum(-1)

    sp, mc = _features(d, g, fl)
    lay = (None if fl.layout is None
           else dict(cfg=fl.layout, r_cap=fl.r_cap))
    s = st.traced_op_stats(dataflow, M, N, K, R, C, mem, d["bw"],
                           sparsity=sp, multicore=mc, layout=lay)
    stall_per_op = s["stall_cycles"] if trace_stall is None else trace_stall
    comp_t = s["compute_cycles"] * cnt
    stall_t = stall_per_op * cnt
    lay_t = s["layout_extra_cycles"] * cnt
    dram_t = s["dram_bytes"] * cnt
    macs = M * N * K * cnt
    if fl.num_cores > 1:
        pes = (d["mc_R"] * d["mc_C"]).sum(-1)
        dim32 = torch.maximum(d["mc_R"], d["mc_C"]).max(-1).values / 32.0
    else:
        pes = R * C
        dim32 = torch.maximum(R, C) / 32.0
    counts = st.traced_energy_counts(
        R=R, C=C, mem=mem, cycles=comp_t, macs=macs,
        ifmap_reads=s["ifmap_reads"] * cnt,
        filter_reads=s["filter_reads"] * cnt,
        ofmap_writes=s["ofmap_writes"] * cnt,
        ofmap_reads=s["ofmap_reads"] * cnt,
        dram_bytes=dram_t,
        l2_reads=torch.where(d["l2_b"] > 0, s["dram_elems"] * cnt, 0.0),
        pes=pes, dim32=dim32)
    e = energy_pj(counts, ert)

    # SIMD sidecar (an empty vector-op list contributes zero); like the
    # per-op engine, every component scales with count
    v = st.traced_vector_stats(velems, d["lanes"], d["lat"], word_bytes)
    vcyc = v["compute_cycles"] * vcnt
    vdram = v["dram_bytes"] * vcnt
    vel_t = velems * vcnt
    zeros_v = torch.zeros_like(vcyc)
    vcounts = st.traced_energy_counts(
        R=R, C=C, mem=mem, cycles=vcyc, macs=zeros_v, ifmap_reads=vel_t,
        filter_reads=zeros_v, ofmap_writes=vel_t, ofmap_reads=zeros_v,
        dram_bytes=vdram, pes=pes, dim32=dim32)
    ve = energy_pj(vcounts, ert)
    energy = total(e["total"]) + total(ve["total"])
    # the grouped-energy column schema shared with the frame
    groups = {grp: sum(total(e[a]) + total(ve[a]) for a in acts)
              for grp, acts in _ENERGY_GROUPS.items()}

    # routed-NoP plane: flit/credit contention on each op's memory traffic
    # toward the MC at core 0, the link parameters as design columns.
    # Sparse ops gate to zero like the partition stage (a single-core
    # compressed stream).
    noc_cols = {}
    if fl.noc is not None:
        from ..noc.router import noc_delay_model
        from ..noc.traffic import allreduce_cycles, memory_flits
        n = fl.num_cores
        gate = ((1.0 - torch.maximum(d["sp_en"], g["ov"]))
                if fl.with_sparsity else torch.ones_like(M))
        flits = (memory_flits(s["dram_bytes"], n, d["noc_flit"])[..., None]
                 * torch.ones(n, device=R.device))     # (designs, ops, cores)
        ns = noc_delay_model(fl.noc, fl.Pr, fl.Pc, flits, d["noc_bw"],
                             d["noc_flit"], d["noc_buf"], d["nop"],
                             s["compute_cycles"])
        ar = allreduce_cycles(fl.noc, fl.Pr, fl.Pc, M * N * word_bytes,
                              d["noc_bw"], d["noc_flit"], d["noc_buf"],
                              d["nop"])
        util_op = torch.broadcast_to(ns["link_util"] * gate,
                                     (n_designs, M.shape[-1]))
        noc_cols = dict(noc_stall_cycles=total(ns["stall"] * gate * cnt),
                        noc_link_util=util_op.max(-1).values,
                        allreduce_cycles=total(ar * gate * cnt))

    comp = total(comp_t) + total(vcyc)
    stall = total(stall_t)
    lay_sum = total(lay_t)
    dram_b = total(dram_t) + total(vdram)
    cycles = comp + stall + lay_sum
    if noc_cols:
        cycles = cycles + noc_cols["noc_stall_cycles"]
    pes1 = pes[:, 0]
    util = torch.clamp_max(total(macs) / torch.clamp_min(pes1 * cycles, 1.0),
                           1.0)
    return dict(total_cycles=cycles, compute_cycles=comp, stall_cycles=stall,
                dram_bytes=dram_b, energy_pj=energy, utilization=util,
                **groups, **noc_cols)


def _sweep_batched(cfgs: Sequence[AcceleratorConfig], ops: Sequence[Op],
                   dataflow: str, word_bytes: int, ert: ERT = DEFAULT_ERT, *,
                   dram: Optional[DramConfig] = None, spec=None,
                   engine: Optional[str] = None,
                   device: Union[str, torch.device] = "cuda",
                   core_index: int = 0, mesh=None) -> Dict[str, np.ndarray]:
    """Simulate `ops` on every design of one static group (shared dataflow,
    word size, core grid, layout flavor and sparse representation, and
    DramConfig at trace fidelity); returns float64 numpy columns, one value
    per design. `dram` set means trace fidelity. `core_index` names the
    core a heterogeneous mesh is analysed through: the array geometry R, C
    and the layout row bound are that core's (the SIMD lanes and latency
    stay core 0's, as in the reference).

    mesh: a mesh of devices (`launch/mesh.py::make_device_mesh`) to run
    on instead of `device`. The designs are padded to a multiple of
    mesh.size with copies of the last one and cut into contiguous blocks,
    one a device; each device runs its block (at trace fidelity, the
    streams its designs reference, its replay and conflict kernels), and
    the columns come back in design order, the pad dropped. The blocks
    are enqueued from this thread one after another and read back at the
    end, so a card runs its block while the host enqueues the next: the
    sweep is host-bound, and a host thread a card took 17x one card's
    wall on four H100s.
    The group's flavor (sparsity, layout row bound) is the whole group's
    in every block, and a design's values do not depend on which others
    share its block.
    """
    for c in cfgs:
        if (c.dataflow, c.memory.word_bytes) != (dataflow, word_bytes):
            raise ValueError("sweep group mixes dataflows or word sizes")
    fl = _flavor(cfgs, ops, core_index)
    kw = dict(dram=dram, spec=spec, engine=engine, core_index=core_index)
    if mesh is None:
        return _to_host(_sweep_block(cfgs, ops, dataflow, word_bytes, ert,
                                     fl, device=torch.device(device), **kw))
    devices = mesh.devices      # checked by the caller (`_mesh_device`)
    n = len(cfgs)
    padded = list(cfgs) + [cfgs[-1]] * ((-n) % len(devices))
    per = len(padded) // len(devices)
    blocks = [padded[i * per:(i + 1) * per] for i in range(len(devices))]

    parts = []
    for block, dev in zip(blocks, devices):
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            parts.append(_sweep_block(block, ops, dataflow, word_bytes, ert,
                                      fl, device=dev, **kw))
    parts = [_to_host(p) for p in parts]
    return {k: np.concatenate([p[k] for p in parts])[:n] for k in parts[0]}


def _sweep_block(cfgs: Sequence[AcceleratorConfig], ops: Sequence[Op],
                 dataflow: str, word_bytes: int, ert: ERT, fl: _Flavor, *,
                 dram: Optional[DramConfig], spec, engine: Optional[str],
                 device: torch.device, core_index: int
                 ) -> Dict[str, torch.Tensor]:
    """`_sweep_batched` of one block of a group of flavor `fl` on
    `device`: its columns as tensors there, not waited for."""
    d = _columns(cfgs, fl, device, core_index)
    g = _gemm_arrays(ops, device)
    stall = None
    if dram is not None:
        from ..trace.generator import DEFAULT_SPEC
        stall = _trace_stalls(cfgs, ops, dataflow, word_bytes, dram,
                              spec or DEFAULT_SPEC, engine, device,
                              core_index, fl)
    return _design_metrics(d, g, dataflow, word_bytes, ert, fl, stall)


def _to_host(res: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in res.items()}
