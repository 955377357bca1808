"""Multi tensor-core engine: heterogeneous cores, shared L2, non-uniform
split; PyTorch port of `repro.core.multicore` (the partition models and
the shared-DRAM contention entry points).

Paper Sec. III-C/III-D: cores may differ in systolic dims and SIMD units, and
MCM-style packages have non-uniform NoP latency to main memory. Workload is
split so per-core (compute + NoP) finish times equalize: with per-unit-work
rate a_i = cycles per unit of the split dim on core i and fixed NoP offset
b_i = nop_hops * cycles_per_hop * tiles, solve

    a_i * s_i + b_i = theta,  sum_i s_i = S
    => theta = (S + sum(b_i / a_i)) / sum(1 / a_i),  s_i = (theta - b_i) / a_i

then integerize s_i (floor + distribute remainder) and the makespan is
max_i(a_i * s_i + b_i). Uniform grids with zero hops reduce exactly to the
partition.py equations.

The solve lives in `multicore_model` / `best_multicore_cycles_model`:
float32 tensors, no Python branching on data and no loop over cores, with
the core grid shape (Pr, Pc) and scheme static, so the batched sweep
evaluates the whole spatio-temporal partition for every design and op at
once. The eager `simulate_multicore` delegates to the same model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .accelerator import AcceleratorConfig
from .dataflow import _f32, cdiv, map_gemm
from .partition import SCHEMES, partition_footprint


@dataclasses.dataclass(frozen=True)
class MultiCoreResult:
    cycles: float                 # makespan over cores (compute + NoP)
    per_core_cycles: Tuple[float, ...]
    per_core_share: Tuple[int, ...]
    scheme: str
    Pr: int
    Pc: int
    l2_fit: bool                  # partitions fit the shared L2
    l2_spill_elems: float         # unique elements beyond L2 capacity
    footprint_l1: float
    footprint_l2: float
    reduce_elems: float


def _scheme_rate(scheme: str, R, C, Sr, Sc, T, Pr: int, Pc: int):
    """Cycles per unit of the split dimension on one core (a_i). `scheme`,
    `Pr`, `Pc` static; everything else may be tensors."""
    if scheme == "spatial":
        # split Sr: cycles(s) = (2R+C+T-2) * ceil(s/R) * ceil(Sc/(Pc*C))
        return (2 * R + C + T - 2) * cdiv(Sc, Pc * C) / R
    if scheme == "st1":
        return (2 * R + C + cdiv(T, Pc) - 2) * cdiv(Sc, C) / R
    # st2: split Sc
    return (2 * R + C + cdiv(T, Pr) - 2) * cdiv(Sr, R) / C


def _scheme_cycles(scheme: str, R, C, s, Sr, Sc, T, Pr: int, Pc: int):
    """Exact (integer-share) cycles of one core given its split share s."""
    if scheme == "spatial":
        return (2 * R + C + T - 2) * cdiv(s, R) * cdiv(Sc, Pc * C)
    if scheme == "st1":
        return (2 * R + C + cdiv(T, Pc) - 2) * cdiv(s, R) * cdiv(Sc, C)
    return (2 * R + C + cdiv(T, Pr) - 2) * cdiv(Sr, R) * cdiv(s, C)


def split_shares_model(total, a, b):
    """`nonuniform_split` on tensors: group axis 0, any broadcast batch
    behind it. Integerization gives the remainder to the largest
    fractional parts (stable argsort: ties break to the lowest index).

    Float32: shares sum to `total` exactly for split dims within f32's
    integer range (2^24); beyond it, rounding residue is folded into the
    largest-fraction group, keeping the sum within an ulp of `total`.
    """
    inv = 1.0 / a
    theta = (total + torch.sum(b * inv, dim=0)) / torch.sum(inv, dim=0)
    s = torch.clamp_min((theta - b) * inv, 0.0)
    scale = total / torch.clamp_min(torch.sum(s, dim=0), 1e-9)
    s = s * scale
    fl = torch.floor(s)
    rem = total - torch.sum(fl, dim=0)
    order = torch.argsort(-(s - fl), dim=0, stable=True)
    rank = torch.argsort(order, dim=0, stable=True)
    shares = fl + (rank < rem).to(torch.float32)
    resid = total - torch.sum(shares, dim=0)   # 0 whenever rem <= groups
    return shares + torch.where(rank == 0, resid, 0.0)


def nonuniform_split(total: int, rates: Sequence[float],
                     offsets: Sequence[float]) -> List[int]:
    """Equalize a_i*s_i + b_i; integer shares summing to `total` (each >= 0)."""
    f32 = torch.float32
    shares = split_shares_model(torch.tensor(float(total), dtype=f32),
                                torch.tensor(list(rates), dtype=f32),
                                torch.tensor(list(offsets), dtype=f32))
    return [int(x) for x in shares.tolist()]


def _group_maps(scheme: str, Pr: int, Pc: int):
    """Static index maps over the core axis: the first core of each split
    group and the group of each core."""
    grid = np.arange(Pr * Pc).reshape(Pr, Pc)
    groups = grid if scheme in ("spatial", "st1") else grid.T  # rows = groups
    core_group = np.empty(Pr * Pc, dtype=np.int64)
    core_group[groups.ravel()] = np.repeat(np.arange(groups.shape[0]),
                                           groups.shape[1])
    return groups, groups[:, 0], core_group


def multicore_model(dataflow: str, scheme: str, M, N, K, rows, cols, hops,
                    nop_cycles_per_hop, Pr: int, Pc: int):
    """One partition scheme evaluated on tensors.

    rows/cols/hops: per-core geometry with the core axis LAST, shape
    (..., num_cores) (num_cores = Pr*Pc, static), e.g. (designs, 1, cores)
    against (ops,) GEMM dims. M/N/K and `nop_cycles_per_hop` broadcast
    against the leading axes. Returns (makespan, per_core_cycles stacked
    on axis 0, group shares stacked on axis 0), float32.
    """
    M, N, K = (_f32(x, rows) for x in (M, N, K))
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    groups, g_first, core_group = _group_maps(scheme, Pr, Pc)
    total = Sr if scheme in ("spatial", "st1") else Sc
    g_first = torch.as_tensor(g_first, device=rows.device)
    core_group = torch.as_tensor(core_group, device=rows.device)

    # common batch shape of the per-core geometry's leading dims and the
    # GEMM/nop operands; per-core tensors become (cores, *batch) so the
    # core axis broadcasts cleanly against op/design axes
    nop = _f32(nop_cycles_per_hop, rows)
    batch = torch.broadcast_shapes(rows.shape[:-1], Sr.shape, Sc.shape,
                                   T.shape, nop.shape)

    def lead(x, k):                       # (..., k) -> (k, *batch)
        return torch.movedim(torch.broadcast_to(x, batch + (k,)), -1, 0)

    G = groups.shape[0]
    a = _scheme_rate(scheme, lead(rows[..., g_first], G),
                     lead(cols[..., g_first], G), Sr, Sc, T, Pr, Pc)
    b = lead(hops[..., g_first], G) * nop
    a, b = torch.broadcast_tensors(a, b)
    shares = split_shares_model(total, a, b)          # (groups, *batch)

    cyc = _scheme_cycles(scheme, lead(rows, Pr * Pc), lead(cols, Pr * Pc),
                         shares[core_group], Sr, Sc, T, Pr, Pc)
    per_core = cyc + lead(hops, Pr * Pc) * nop
    per_core = torch.broadcast_to(per_core,
                                  (Pr * Pc,) + tuple(per_core.shape[1:]))
    return per_core.max(dim=0).values, per_core, shares


def best_multicore_cycles_model(dataflow: str, M, N, K, rows, cols, hops,
                                nop_cycles_per_hop, Pr: int, Pc: int):
    """Makespan of the best scheme (min cycles, footprint tie-break), the
    tensor twin of `best_multicore(...).cycles`. Scheme order matches
    `best_multicore` so exact ties resolve identically."""
    Sr, Sc, T = map_gemm(dataflow, *(_f32(x, rows) for x in (M, N, K)))
    best_c = best_f = None
    for scheme in SCHEMES:
        c, _, _ = multicore_model(dataflow, scheme, M, N, K, rows, cols,
                                  hops, nop_cycles_per_hop, Pr, Pc)
        fp = partition_footprint(scheme, dataflow, Sr, Sc, T, Pr, Pc)
        f = fp["total"] + 0.0 * c
        if best_c is None:
            best_c, best_f = c, f
        else:
            better = (c < best_c) | ((c == best_c) & (f < best_f))
            best_c = torch.where(better, c, best_c)
            best_f = torch.where(better, f, best_f)
    return best_c


def effective_nop_hops(cfg: AcceleratorConfig) -> np.ndarray:
    """Per-core NoP hops to main memory: routed when the NoC plane is
    enabled on a multi-core design (dimension-ordered routes to the MC at
    core 0, `noc.topology`), else the per-core `nop_hops` config fields
    (legacy offsets)."""
    from ..noc.topology import noc_kind, routed_hop_counts
    kind = noc_kind(cfg)
    if kind is not None:
        return np.asarray(routed_hop_counts(kind, cfg.mesh_rows,
                                            cfg.mesh_cols), dtype=np.float64)
    return np.asarray([c.nop_hops for c in cfg.cores], dtype=np.float64)


def simulate_multicore(cfg: AcceleratorConfig, M: int, N: int, K: int,
                       scheme: str = "spatial") -> MultiCoreResult:
    """Partition one GEMM over the core grid and return the makespan
    (scalar math on CPU tensors)."""
    df = cfg.dataflow
    Sr, Sc, T = map_gemm(df, M, N, K)
    Pr, Pc = cfg.mesh_rows, cfg.mesh_cols
    cores = cfg.cores

    f32 = torch.float32
    rows = torch.tensor([c.rows for c in cores], dtype=f32)
    cols = torch.tensor([c.cols for c in cores], dtype=f32)
    hops = torch.tensor(effective_nop_hops(cfg), dtype=f32)
    _, per_core, shares = multicore_model(
        df, scheme, M, N, K, rows, cols, hops, cfg.nop_cycles_per_hop,
        Pr, Pc)
    per_core_cyc = per_core.to(torch.float64).numpy()
    groups, _, core_group = _group_maps(scheme, Pr, Pc)
    shares_out = shares.numpy().astype(int)[core_group]

    # --- shared L2 capacity check (Sec. III-B) ------------------------------
    fp_l1 = partition_footprint(scheme, df, Sr, Sc, T, Pr, Pc, dedup=False)
    fp_l2 = partition_footprint(scheme, df, Sr, Sc, T, Pr, Pc, dedup=True)
    wb = cfg.memory.word_bytes
    l2_cap_elems = (cfg.memory.l2_sram_bytes / wb
                    if cfg.memory.l2_sram_bytes else 0.0)
    l2_need = float(fp_l2["stream_in"] + fp_l2["stationary"])
    l2_fit = (l2_cap_elems == 0.0) or (l2_need <= l2_cap_elems)
    spill = 0.0 if l2_fit else l2_need - l2_cap_elems

    return MultiCoreResult(
        cycles=float(per_core_cyc.max()),
        per_core_cycles=tuple(float(c) for c in per_core_cyc),
        per_core_share=tuple(int(s) for s in shares_out),
        scheme=scheme, Pr=Pr, Pc=Pc,
        l2_fit=bool(l2_fit), l2_spill_elems=float(spill),
        footprint_l1=float(fp_l1["total"]), footprint_l2=float(fp_l2["total"]),
        reduce_elems=float(fp_l1["reduce_elems"]))


def simulate_multicore_contention(cfg: AcceleratorConfig, M: int, N: int,
                                  K: int, scheme: str = "spatial",
                                  private_channels: bool = False,
                                  spec=None, device="cuda"):
    """Shared-DRAM contention for one partitioned GEMM, on `device` (CUDA
    unless the caller asks for the CPU): per-core demand traces merged
    through the shared channels, against each core alone on the memory
    system. Returns a `trace.contention.ContentionResult` with per-core
    stall inflation.

    private_channels: pin core c's bursts to channel c; with one core per
    channel the contention path then decomposes exactly into the isolated
    runs.
    """
    from ..trace.contention import multicore_contention
    return multicore_contention(cfg, M, N, K, scheme=scheme,
                                private_channels=private_channels, spec=spec,
                                device=device)


def contention_summary(cfg: AcceleratorConfig, M: int, N: int, K: int,
                       scheme: str = "spatial",
                       private_channels: bool = False,
                       spec=None, device="cuda") -> Dict[str, float]:
    """`simulate_multicore_contention` flattened to a metric dict: the cell
    evaluator of the `multicore_contention` named study. Infinite stall
    inflations (cores that only stall under contention) are reported as a
    count, not a column value, so the frame stays CSV-safe."""
    r = simulate_multicore_contention(cfg, M, N, K, scheme,
                                      private_channels, spec, device)
    finite = [x for x in r.stall_inflation if np.isfinite(x)]
    return dict(
        channels=float(cfg.dram.channels),
        cores=float(cfg.num_cores),
        makespan_isolated=float(r.makespan_isolated),
        makespan_shared=float(r.makespan_shared),
        contention_slowdown=float(r.makespan_shared
                                  / max(r.makespan_isolated, 1e-9)),
        max_stall_inflation=float(max(finite)) if finite else 1.0,
        cores_stalled_only_shared=float(len(r.stall_inflation)
                                        - len(finite)),
        row_hits=float(r.row_hits), row_misses=float(r.row_misses),
        row_conflicts=float(r.row_conflicts))


def best_multicore(cfg: AcceleratorConfig, M: int, N: int, K: int,
                   objective: str = "cycles") -> MultiCoreResult:
    results = [simulate_multicore(cfg, M, N, K, s)
               for s in ("spatial", "st1", "st2")]
    if objective == "cycles":
        return min(results, key=lambda r: (r.cycles, r.footprint_l1))
    return min(results, key=lambda r: (r.footprint_l1, r.cycles))
