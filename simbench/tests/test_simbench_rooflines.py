"""The roofline counts: the replay's bytes as `chip_smoke.py` counts them,
and the per-element operation counts behind `sweep_mfu`, taken again."""
import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from simbench.reference import sim
from simbench.rooflines import replay as rr
from simbench.rooflines import sweep as rs

DRAM = dict(channels=2, banks_per_channel=16, row_bytes=2048, tRCD=14,
            tRP=14, tCAS=14, burst_bytes=64, tBURST=4, read_queue=128,
            write_queue=128, bandwidth_bytes_per_cycle=19.2)
# data movement, not counted as operations
MOVES = {"gather", "stack", "sort", "index", "expand", "view", "unsqueeze",
         "slice", "select", "cat", "_to_copy", "copy_", "clone",
         "broadcast_tensors", "lift_fresh", "detach", "arange", "zeros",
         "zeros_like", "full", "full_like", "empty", "scalar_tensor",
         "alias", "_unsafe_view", "reshape", "squeeze", "new_zeros",
         "empty_like", "ones_like", "_local_scalar_dense", "expand_as",
         "as_strided", "fill_"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if name not in MOVES:
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.n[name] += sum(o.numel() for o in outs
                                if isinstance(o, torch.Tensor))
        return out


def test_replay_bytes_match_chip_smoke():
    assert rr.replay_bytes(1776, 4096) == 147_344_064
    # a length that is not a whole chunk is padded to one
    assert rr.replay_bytes(1, 65) == rr.replay_bytes(1, 128)
    assert rr.replay_least_s(1776, 4096, 1776 * 4096) == pytest.approx(
        147_344_064 / 3.35e12)


def _designs(df):
    return [dict(array=a, sram_mb=s, dataflow=df)
            for a in (16, 32, 64, 128, 256) for s in (0.25, 1, 8)]


@pytest.mark.parametrize("df", ["ws", "os", "is"])
def test_operation_counts_are_the_reference_s(df):
    gemm = [dict(name="g", kind="gemm", M=768, N=197, K=768, count=1.0,
                 vector_elems=0.0)] * 10
    vec = [dict(name="v", kind="vector", M=0, N=0, K=0, count=1.0,
                vector_elems=1e5)] * 10
    d = sim.design_columns(_designs(df), torch.float32, "cpu")
    n = len(_designs(df))
    for ops, const in ((gemm, rs.STAGE_OPS_PER_GEMM),
                       (vec, rs.STAGE_OPS_PER_VECTOR)):
        g = sim.op_arrays(ops, torch.float32, "cpu")
        stall = torch.zeros(n, g["M"].numel())
        c = Count()
        with c:
            sim.design_metrics(df, d, g, stall)
        per = sum(c.n.values()) / (n * len(ops))
        assert per <= const < per + 8
    g = sim.op_arrays(gemm, torch.float32, "cpu")
    M, N, K, R, C = g["M"], g["N"], g["K"], d["R"], d["C"]
    comp = sim.compute_cycles(df, M, N, K, R, C)
    dr = sim.dram_traffic(df, M, N, K, R, C, dict(
        if_b=d["if_b"], f_b=d["f_b"], o_b=d["o_b"], word_bytes=2))
    cap = 512
    c, c2 = Count(), Count()
    with c:
        sim.request_stream(df, M, N, K, R, C, comp, dr["dram_ifmap"],
                           dr["dram_filter"], dr["dram_ofmap_writes"],
                           dr["dram_ofmap_reads"], word_bytes=2, cap=cap,
                           gran_bytes=64, dtype=torch.float32)
    slots = n * len(gemm) * cap
    assert sum(c.n.values()) / slots == pytest.approx(
        rs.GEN_OPS_PER_REQUEST, abs=0.5)
    addr = torch.arange(slots, dtype=torch.int64) * 64
    with c2:
        sim.decode(addr, DRAM)
    assert sum(c2.n.values()) / slots == rs.DECODE_OPS_PER_REQUEST


def test_pass_least_time_counts_valid_requests():
    ops = [dict(name="g", kind="gemm", M=64, N=64, K=64, count=1.0,
                vector_elems=0.0)]
    d = [dict(array=16, sram_mb=8, dataflow="ws")]
    # 64 x 64 x 3 operands of 2 bytes in 64-byte requests, no refetch
    assert rs.valid_requests(d, ops, dict(cap=65536, gran_bytes=64)) == 384
    assert rs.valid_requests(d, ops, dict(cap=100, gran_bytes=64)) == 100
    least = rs.pass_least_s(d, ops, dict(cap=65536, gran_bytes=64))
    assert least == pytest.approx(
        (120 + 384 * (78 + 8 + 11)) / 67e12)
