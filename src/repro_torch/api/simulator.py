"""The batched design sweep (PyTorch port of `repro.api.simulator`'s
`_batched_design_fn` / `_sweep_batched`).

A sweep stacks per-design config scalars into float32 columns with a
leading design axis and runs the traced stage math on all designs and ops
at once (designs x ops broadcasting stands in for the reference's vmap).
At trace fidelity the first-order stall is replaced by the stall of each
op's generated demand stream: one stream per unique stream-determining
design (`sdesign`), generated as one (streams, ops, cap) batch, decoded
in one call and replayed in one kernel launch, then gathered back per
design through `smap`.

This slice covers dense single-core designs with layout and NoC off;
`refuse_outside_slice` names the later slice for everything else.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import stages as st
from ..core.accelerator import AcceleratorConfig, DramConfig, MemoryConfig
from ..core.energy import DEFAULT_ERT, ERT, energy_pj
from ..core.engine import _ENERGY_GROUPS
from ..core.workloads import PAPER_WORKLOADS, Op
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


def refuse_outside_slice(cfg: AcceleratorConfig, ops: Sequence[Op]) -> None:
    """Raise NotImplementedError, naming the slice of the port that brings
    it, for a design or workload this slice does not model. A sparse or
    multi-core design must never come back as a dense single-core result."""
    def later(what: str, item: str):
        raise NotImplementedError(
            f"{what} is not ported yet: it comes with {item} of the "
            f"PyTorch port (ROADMAP.md); this slice runs dense, single-core "
            f"designs with layout and NoC off")

    if cfg.sparsity.enabled:
        later("sparsity", "module item 5 (traced feature models)")
    if any(o.sparsity_nm is not None for o in ops):
        later("a per-op N:M sparsity override",
              "module item 5 (traced feature models)")
    if cfg.num_cores > 1:
        later(f"a {cfg.num_cores}-core design",
              "module item 5 (traced feature models)")
    if cfg.layout.enabled:
        later("the data-layout stage",
              "module item 5 and kernel item 2 (bank-conflict kernel)")
    if cfg.noc.enabled:
        later("the routed NoC plane", "module item 7 (the NoC plane)")


def _columns(cfgs: Sequence[AcceleratorConfig], keys, device):
    cols = {
        "R": [c.cores[0].rows for c in cfgs],
        "C": [c.cores[0].cols for c in cfgs],
        "lanes": [c.cores[0].simd_lanes for c in cfgs],
        "lat": [c.cores[0].simd_latency for c in cfgs],
        "if_b": [c.memory.ifmap_sram_bytes for c in cfgs],
        "f_b": [c.memory.filter_sram_bytes for c in cfgs],
        "o_b": [c.memory.ofmap_sram_bytes for c in cfgs],
        "l2_b": [c.memory.l2_sram_bytes for c in cfgs],
        "bw": [c.dram.bandwidth_bytes_per_cycle * c.dram.channels
               for c in cfgs],
    }
    # float32 columns of shape (designs, 1): they broadcast against the
    # (ops,) workload arrays the way the reference vmaps over designs
    return {k: torch.tensor(np.asarray(cols[k], np.float32),
                            device=device)[:, None] for k in keys}


def _mem(d, word_bytes: int) -> MemoryConfig:
    return MemoryConfig(ifmap_sram_bytes=d["if_b"], filter_sram_bytes=d["f_b"],
                        ofmap_sram_bytes=d["o_b"], l2_sram_bytes=d["l2_b"],
                        word_bytes=word_bytes)


def _stream_dedup(cfgs: Sequence[AcceleratorConfig]):
    """(sidx, smap): the design index of each unique demand stream and the
    stream id of each design. A design's stream is fully determined by its
    array geometry and memory sizing here (dense, single core), so designs
    that differ only in bandwidth, SIMD or energy terms share one replay."""
    seen: Dict[tuple, int] = {}
    sidx: List[int] = []
    smap: List[int] = []
    for i, c in enumerate(cfgs):
        k = (tuple((k_.rows, k_.cols, k_.nop_hops) for k_ in c.cores),
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

    return dict(M=col([o.M for o in gemms]), N=col([o.N for o in gemms]),
                K=col([o.K for o in gemms]), cnt=col([o.count for o in gemms]),
                velems=col([o.vector_elems for o in vecs]),
                vcnt=col([o.count for o in vecs]))


def decoded_streams(cfgs: Sequence[AcceleratorConfig], ops: Sequence[Op],
                    dataflow: str, word_bytes: int, dram: DramConfig, spec,
                    device):
    """Generate and decode the demand streams of every unique stream
    design x gemm op: returns (t, flat_bank, ch, row, is_write, valid) of
    shape (streams, ops, cap), the (streams, ops) compression `scale` and
    the design -> stream map `smap`."""
    from ..core.dram import decode_requests
    from ..trace.generator import gemm_request_stream
    sidx, smap = _stream_dedup(cfgs)
    d = _columns([cfgs[i] for i in sidx],
                 ("R", "C", "if_b", "f_b", "o_b", "l2_b"), device)
    g = _gemm_arrays(ops, device)
    M, N, K = g["M"], g["N"], g["K"]
    comp, _, dr, _ = st.traced_comp_traffic(dataflow, M, N, K, d["R"], d["C"],
                                            _mem(d, word_bytes))
    t, addr, wbit, val, scale = gemm_request_stream(
        dataflow, M, N, K, d["R"], d["C"], comp, dr["dram_ifmap"],
        dr["dram_filter"], dr["dram_ofmap_writes"], dr["dram_ofmap_reads"],
        word_bytes, spec)
    fb, ch, row = decode_requests(addr, dram)        # one flat decode
    return (t, fb, ch, row, wbit, val), scale, torch.tensor(
        smap, dtype=torch.int64, device=device)


def _trace_stalls(cfgs, ops, dataflow, word_bytes, dram, spec, engine,
                  device):
    """(designs, ops) cycle-accurate stalls: one batched replay of every
    unique stream, scaled and gathered back per design."""
    from ..core.dram import replay_requests
    streams, scale, smap = decoded_streams(cfgs, ops, dataflow, word_bytes,
                                           dram, spec, device)
    stall = replay_requests(*streams, dram, spec.gran_bytes,
                            engine=engine).stall_cycles
    return (stall * scale)[smap]


def _design_metrics(d, g, dataflow: str, word_bytes: int, ert: ERT,
                    trace_stall=None) -> Dict[str, torch.Tensor]:
    """Per-design totals over the workload: `d` holds (designs, 1) config
    columns, `g` the (ops,) workload arrays. The reference's per-design
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

    s = st.traced_op_stats(dataflow, M, N, K, R, C, mem, d["bw"])
    stall_per_op = s["stall_cycles"] if trace_stall is None else trace_stall
    comp_t = s["compute_cycles"] * cnt
    stall_t = stall_per_op * cnt
    lay_t = s["layout_extra_cycles"] * cnt
    dram_t = s["dram_bytes"] * cnt
    macs = M * N * K * cnt
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

    comp = total(comp_t) + total(vcyc)
    stall = total(stall_t)
    lay_sum = total(lay_t)
    dram_b = total(dram_t) + total(vdram)
    cycles = comp + stall + lay_sum
    pes1 = pes[:, 0]
    util = torch.clamp_max(total(macs) / torch.clamp_min(pes1 * cycles, 1.0),
                           1.0)
    return dict(total_cycles=cycles, compute_cycles=comp, stall_cycles=stall,
                dram_bytes=dram_b, energy_pj=energy, utilization=util,
                **groups)


def _sweep_batched(cfgs: Sequence[AcceleratorConfig], ops: Sequence[Op],
                   dataflow: str, word_bytes: int, ert: ERT = DEFAULT_ERT, *,
                   dram: Optional[DramConfig] = None, spec=None,
                   engine: Optional[str] = None,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, np.ndarray]:
    """Simulate `ops` on every design of one static group (shared dataflow
    and word size, and DramConfig at trace fidelity); returns float64
    numpy columns, one value per design. `dram` set means trace fidelity.
    """
    for c in cfgs:
        refuse_outside_slice(c, ops)
        if (c.dataflow, c.memory.word_bytes) != (dataflow, word_bytes):
            raise ValueError("sweep group mixes dataflows or word sizes")
    device = torch.device(device)
    d = _columns(cfgs, ("R", "C", "lanes", "lat", "if_b", "f_b", "o_b",
                        "l2_b", "bw"), device)
    g = _gemm_arrays(ops, device)
    stall = None
    if dram is not None:
        from ..trace.generator import DEFAULT_SPEC
        stall = _trace_stalls(cfgs, ops, dataflow, word_bytes, dram,
                              spec or DEFAULT_SPEC, engine, device)
    res = _design_metrics(d, g, dataflow, word_bytes, ert, stall)
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in res.items()}
