"""End-to-end simulation engine: op graph x AcceleratorConfig -> report;
PyTorch port of `repro.core.engine`.

Thin wrappers over the stage pipeline in `core/stages.py` (mapping ->
partition -> sparsity -> sram -> noc -> dram -> layout -> energy): one op
at a time, as the reference runs them, on the pipeline's device (CUDA
unless the caller asks for the CPU; see `stages.build_pipeline`). Vector
ops run on the SIMD unit. `gemm_summary_traced` and `energy_traced` are
the tensor forms for sweeps over (R, C) or (M, N, K) grids; the batched
`api.study.Study` is the path for design grids. Also here: the frame
schema every serialized result shares (version stamp, grouped energy
columns, the CSV writer).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import torch

from . import stages as st
from .accelerator import AcceleratorConfig
from .energy import DEFAULT_ERT, ERT, edp, power_w
from .workloads import Op

# Version stamp shared by every serialized result. Bump when a column's
# meaning changes so stale files / downstream parsers fail loud.
RESULT_SCHEMA_VERSION = 1

# Grouped CSV columns for the energy breakdown (pJ).
_ENERGY_GROUPS = {
    "energy_mac_pj": ("mac_random", "mac_wire", "spad_read", "spad_write"),
    "energy_sram_pj": ("sram_read_random", "sram_read_repeat",
                       "sram_write_random", "sram_write_repeat",
                       "sram_idle_kib_cycles", "l2_read", "l2_write"),
    "energy_dram_pj": ("dram_bytes", "noc_byte_hops"),
    "energy_static_pj": ("mac_gated", "pe_leak"),
}

# The one grouped-energy column schema, in this order.
ENERGY_GROUP_COLUMNS = tuple(_ENERGY_GROUPS)


def energy_group_totals(by_action: Optional[Dict[str, float]]
                        ) -> Dict[str, float]:
    """Reduce an action -> pJ mapping onto the grouped energy columns."""
    return {g: sum((by_action or {}).get(a, 0.0) for a in acts)
            for g, acts in _ENERGY_GROUPS.items()}


def write_csv_table(path: str, header: Sequence[str],
                    rows: Sequence[Sequence]) -> None:
    """The shared CSV writer. Floats are written with repr() so a
    read-back parses to the identical value; everything else with str().
    The stdlib csv module escapes labels containing commas or quotes."""
    import csv

    def fmt(v) -> str:
        if isinstance(v, float):         # incl. numpy scalars: cast so
            return repr(float(v))        # numpy-2 reprs don't leak in
        return str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow([fmt(v) for v in r])


@dataclasses.dataclass
class OpResult:
    name: str
    kind: str
    compute_cycles: float
    stall_cycles: float
    layout_extra_cycles: float
    total_cycles: float
    utilization: float
    macs: float
    sram_reads: float
    sram_writes: float
    dram_bytes: float
    energy_pj: float
    scheme: str = "single"
    dram_stats: Optional[Dict[str, float]] = None
    sparse_storage: Optional[Dict[str, float]] = None
    energy_by_action: Optional[Dict[str, float]] = None
    noc_stall_cycles: float = 0.0       # routed-NoP queueing (noc.stage)
    noc_stats: Optional[Dict[str, float]] = None

    def energy_group(self, group: str) -> float:
        return energy_group_totals(self.energy_by_action)[group]


@dataclasses.dataclass
class NetworkReport:
    ops: List[OpResult]
    total_cycles: float
    compute_cycles: float
    stall_cycles: float
    layout_extra_cycles: float
    dram_bytes: float
    energy_pj: float
    energy_breakdown: Dict[str, float]
    avg_power_w: float
    edp: float
    utilization: float
    noc_stall_cycles: float = 0.0
    # runtime replay-engine label of the DRAM stage that ran ('' for the
    # fast model): "cuda", "torch:plain" or "reference"
    engine: str = ""

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["schema_version"] = RESULT_SCHEMA_VERSION
        return json.dumps(d, indent=1, default=float)

    def write_csv(self, path: str) -> None:
        cols = ["name", "kind", "compute_cycles", "stall_cycles",
                "layout_extra_cycles", "total_cycles", "utilization",
                "dram_bytes", "energy_pj"]
        rows = [[getattr(o, c) for c in cols]
                + [o.energy_group(g) for g in ENERGY_GROUP_COLUMNS]
                for o in self.ops]
        write_csv_table(path, cols + list(ENERGY_GROUP_COLUMNS), rows)


def _result_from_ctx(ctx: st.OpContext, kind: str) -> OpResult:
    op = ctx.op
    return OpResult(
        op.name, kind, ctx.compute_total, ctx.stall_total, ctx.layout_total,
        ctx.total, ctx.util, op.macs if kind == "gemm" else 0.0,
        ctx.sram_reads, ctx.sram_writes, ctx.dram_bytes_total,
        ctx.energy_total, ctx.scheme, ctx.dram_stats, ctx.sparse_info,
        ctx.energy_by_action, noc_stall_cycles=ctx.noc_total,
        noc_stats=ctx.noc_stats)


def simulate_op(cfg: AcceleratorConfig, op: Op, *,
                dram_fidelity: str = "fast", ert: ERT = DEFAULT_ERT,
                pipeline: Optional[Sequence[st.Stage]] = None,
                device=None) -> OpResult:
    """Simulate one op through the stage pipeline. `pipeline` is a
    prebuilt stage list (it fixes the device); by default one is built
    from `dram_fidelity` on `device` (CUDA unless the caller asks for the
    CPU; raises without a card)."""
    if pipeline is None:
        pipeline = st.build_pipeline(dram_fidelity, device=device)
    if op.kind == "vector":
        return _result_from_ctx(st.run_vector(cfg, op, ert), "vector")
    return _result_from_ctx(
        st.run_gemm_pipeline(cfg, op, pipeline, ert), "gemm")


def simulate_network(cfg: AcceleratorConfig, ops: Sequence[Op], *,
                     dram_fidelity: str = "fast", ert: ERT = DEFAULT_ERT,
                     pipeline: Optional[Sequence[st.Stage]] = None,
                     device=None) -> NetworkReport:
    """Simulate every op in order and total them (see `simulate_op`)."""
    if pipeline is None:
        pipeline = st.build_pipeline(dram_fidelity, device=device)
    results = [simulate_op(cfg, o, ert=ert, pipeline=pipeline) for o in ops]
    total = sum(r.total_cycles for r in results)
    e_total = sum(r.energy_pj for r in results)
    macs = sum(r.macs for r in results)
    pes = sum(c.num_pes for c in cfg.cores)
    breakdown: Dict[str, float] = {}
    for r in results:
        for k, v in (r.energy_by_action or {}).items():
            breakdown[k] = breakdown.get(k, 0.0) + float(v)
    return NetworkReport(
        ops=results, total_cycles=total,
        compute_cycles=sum(r.compute_cycles for r in results),
        stall_cycles=sum(r.stall_cycles for r in results),
        layout_extra_cycles=sum(r.layout_extra_cycles for r in results),
        dram_bytes=sum(r.dram_bytes for r in results),
        energy_pj=e_total, energy_breakdown=breakdown,
        avg_power_w=power_w(e_total, total, cfg.clock_ghz),
        edp=edp(e_total, total),
        utilization=min(1.0, macs / max(1.0, pes * total)),
        noc_stall_cycles=sum(r.noc_stall_cycles for r in results),
        engine=st.pipeline_engine(pipeline))


# --------------------------------------------------------------------------
# Tensor forms for sweeps over array or GEMM dimensions
# --------------------------------------------------------------------------

def gemm_summary_traced(dataflow: str, M, N, K, R, C, *,
                        sram_elems, bw_bytes_per_cycle, word_bytes=2):
    """Single-core summary on float32 tensors (every argument but
    `dataflow` and `word_bytes` a tensor or number; they broadcast), the
    stage math of `stages.traced_gemm_stats` with both operand SRAMs
    sized to `sram_elems` and psums never spilling."""
    M, N, K, R, C = (torch.as_tensor(x, dtype=torch.float32)
                     for x in (M, N, K, R, C))
    mem = st.traced_memory(sram_elems, word_bytes)
    s = st.traced_gemm_stats(dataflow, M, N, K, R, C, mem,
                             bw_bytes_per_cycle)
    return {k: s[k] for k in ("compute_cycles", "stall_cycles",
                              "total_cycles", "utilization", "dram_bytes")}


def energy_traced(comp_cycles, macs, dram_bytes, R, C,
                  ert: ERT = DEFAULT_ERT):
    """Energy estimate on float32 tensors for sweeps (MAC, leakage and
    DRAM dominate)."""
    comp_cycles, macs, dram_bytes = (
        torch.as_tensor(x, dtype=torch.float32)
        for x in (comp_cycles, macs, dram_bytes))
    pes = 1.0 * R * C
    util = torch.clamp(macs / torch.clamp_min(pes * comp_cycles, 1.0),
                       0.0, 1.0)
    return (pes * comp_cycles * util * ert.mac_random
            + pes * comp_cycles * (1 - util) * ert.mac_gated
            + pes * comp_cycles * ert.pe_leak_per_cycle
            + 3.0 * macs * ert.spad_read
            + dram_bytes * ert.dram_per_byte)
