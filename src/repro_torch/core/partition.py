"""Spatial and spatio-temporal multi-core partitioning (paper Sec. III-A);
PyTorch port of `repro.core.partition`.

Schemes for a Pr x Pc core grid over mapping dims (Sr, Sc, T):

  spatial (Eq. 1): split Sr over Pr, Sc over Pc
      cycles = (2R + C + T - 2) * ceil(Sr/(Pr*R)) * ceil(Sc/(Pc*C))
  st1     (Eq. 2): split Sr over Pr, T over Pc
      cycles = (2R + C + ceil(T/Pc) - 2) * ceil(Sr/(Pr*R)) * ceil(Sc/C)
  st2     (Eq. 3): split Sc over Pc, T over Pr
      cycles = (2R + C + ceil(T/Pr) - 2) * ceil(Sr/R) * ceil(Sc/(Pc*C))

Memory footprints count L1-resident elements summed over cores; `dedup=True`
models the shared L2 (Sec. III-B) which stores each unique element once.
Temporal splits of a reduction dim (os dataflow: T = K) additionally require
cross-core psum reduction, reported as `reduce_elems`.

Every function takes Python numbers or float32 tensors of any broadcastable
shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .dataflow import cdiv, map_gemm

SCHEMES = ("spatial", "st1", "st2")


def partition_cycles(scheme: str, R, C, Sr, Sc, T, Pr: int, Pc: int):
    if scheme == "spatial":
        return (2 * R + C + T - 2) * cdiv(Sr, Pr * R) * cdiv(Sc, Pc * C)
    if scheme == "st1":
        return (2 * R + C + cdiv(T, Pc) - 2) * cdiv(Sr, Pr * R) * cdiv(Sc, C)
    if scheme == "st2":
        return (2 * R + C + cdiv(T, Pr) - 2) * cdiv(Sr, R) * cdiv(Sc, Pc * C)
    raise ValueError(f"unknown scheme {scheme!r}")


def partition_footprint(scheme: str, dataflow: str, Sr, Sc, T,
                        Pr: int, Pc: int, dedup: bool = False) -> Dict:
    """L1 footprint (elements) summed over all cores + psum reduction traffic.

    Mapping-space operand shapes: stationary (Sr x Sc), streamed-in (Sr x T),
    streamed-out (Sc x T).
    """
    stat = 1.0 * Sr * Sc
    op_in = 1.0 * Sr * T
    op_out = 1.0 * Sc * T
    reduce_elems = 0.0
    if scheme == "spatial":
        f_stat, f_in, f_out = stat, Pc * op_in, Pr * op_out
    elif scheme == "st1":                      # Sr spatial, T temporal
        f_stat, f_in, f_out = Pc * stat, op_in, Pr * op_out
        if dataflow == "os":                   # T = K: psums reduced over Pc
            reduce_elems = (Pc - 1) * stat
    else:                                      # st2: Sc spatial, T temporal
        f_stat, f_in, f_out = Pr * stat, Pc * op_in, op_out
        if dataflow == "os":
            reduce_elems = (Pr - 1) * stat
    if dedup:                                  # shared L2 holds each once
        f_stat, f_in, f_out = stat, op_in, op_out
    return dict(stationary=f_stat, stream_in=f_in, stream_out=f_out,
                total=f_stat + f_in + f_out, reduce_elems=reduce_elems)


def factor_pairs(n: int) -> List[Tuple[int, int]]:
    return [(p, n // p) for p in range(1, n + 1) if n % p == 0]


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    scheme: str
    Pr: int
    Pc: int
    cycles: float
    footprint: float          # no-L2 (L1-replicated) footprint, elements
    footprint_l2: float       # with shared-L2 dedup
    reduce_elems: float


def enumerate_plans(dataflow: str, M, N, K, R: int, C: int,
                    num_cores: int) -> List[PartitionPlan]:
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    plans = []
    for scheme in SCHEMES:
        for Pr, Pc in factor_pairs(num_cores):
            cyc = partition_cycles(scheme, R, C, Sr, Sc, T, Pr, Pc)
            fp = partition_footprint(scheme, dataflow, Sr, Sc, T, Pr, Pc)
            fp2 = partition_footprint(scheme, dataflow, Sr, Sc, T, Pr, Pc,
                                      dedup=True)
            plans.append(PartitionPlan(scheme, Pr, Pc, float(cyc),
                                       float(fp["total"]), float(fp2["total"]),
                                       float(fp["reduce_elems"])))
    return plans


def best_plan(dataflow: str, M, N, K, R: int, C: int, num_cores: int,
              objective: str = "cycles") -> PartitionPlan:
    """objective: 'cycles' (tiebreak footprint) or 'footprint' (tiebreak cycles)."""
    plans = enumerate_plans(dataflow, M, N, K, R, C, num_cores)
    if objective == "cycles":
        return min(plans, key=lambda p: (p.cycles, p.footprint))
    if objective == "footprint":
        return min(plans, key=lambda p: (p.footprint, p.cycles))
    raise ValueError(objective)
