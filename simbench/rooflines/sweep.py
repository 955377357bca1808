"""The least time of one pass of a trace-fidelity design sweep at the
chip's peak, counted from the pass's designs and ops (what the frame's
semantics need), not from what any kernel launches.

Operations, each elementwise result of the plain reference
(`simbench/reference/sim.py`) counted once, data movement (gathers,
stacks, the sort, casts) not counted; the counts were taken by a
TorchDispatchMode over the reference and a test takes them again:
- stage math, per (design, gemm op): mapping, SRAM and DRAM traffic,
  energy counts and the ERT, and the sums over ops: 120 (119.2 for ws
  and is, 112.6 for os, with the per-design work spread over the ops);
- the SIMD sidecar, per (design, vector op): 59 (58.8);
- per valid request: generation 78 (region, operand walk, row-major
  address, prefetch schedule), decode 8 (burst, channel, bank, row),
  one replay pass 11 (`replay.OPS_PER_VALID_REQUEST`).
Bytes, each once: per design 8 float32 config columns in and 13 float64
frame columns out; per gemm op M, N, K, count and the sparsity override
(5 float32), per vector op its elements and count (2 float32).
Valid requests a (design, gemm op): ceil(its DRAM bytes / granule),
between 1 and the trace cap, as the generator's stream holds them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..reference import sim
from .peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S
from .replay import OPS_PER_VALID_REQUEST

STAGE_OPS_PER_GEMM = 120
STAGE_OPS_PER_VECTOR = 59
GEN_OPS_PER_REQUEST = 78
DECODE_OPS_PER_REQUEST = 8
BYTES_PER_DESIGN = 8 * 4 + 13 * 8
BYTES_PER_GEMM = 5 * 4
BYTES_PER_VECTOR = 2 * 4


def valid_requests(designs: Sequence[Dict], ops: Sequence[Dict],
                   spec: Dict) -> int:
    """Valid requests the pass's streams hold, from the traffic model."""
    g = sim.op_arrays(ops, torch.float32, "cpu")
    total = 0
    for df in ("ws", "os", "is"):
        group = [d for d in designs if d["dataflow"] == df]
        if not group or g["M"].numel() == 0:
            continue
        d = sim.design_columns(group, torch.float32, "cpu")
        dr = sim.dram_traffic(df, g["M"], g["N"], g["K"], d["R"], d["C"],
                              dict(if_b=d["if_b"], f_b=d["f_b"],
                                   o_b=d["o_b"], word_bytes=2))
        elems = (dr["dram_ifmap"] + dr["dram_filter"]
                 + dr["dram_ofmap_reads"] + dr["dram_ofmap_writes"])
        n = torch.clamp(torch.ceil(elems * 2.0 / spec["gran_bytes"]),
                        min=1.0, max=float(spec["cap"]))
        total += int(n.to(torch.float64).sum())
    return total


def pass_least_s(designs: Sequence[Dict], ops: Sequence[Dict],
                 spec: Dict) -> float:
    n_g = sum(o["kind"] == "gemm" for o in ops)
    n_v = len(ops) - n_g
    D = len(designs)
    req = valid_requests(designs, ops, spec)
    n_ops = (D * (n_g * STAGE_OPS_PER_GEMM + n_v * STAGE_OPS_PER_VECTOR)
             + req * (GEN_OPS_PER_REQUEST + DECODE_OPS_PER_REQUEST
                      + OPS_PER_VALID_REQUEST))
    n_bytes = (D * BYTES_PER_DESIGN + n_g * BYTES_PER_GEMM
               + n_v * BYTES_PER_VECTOR)
    return max(n_ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)
