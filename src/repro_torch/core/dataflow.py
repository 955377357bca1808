"""Dataflow mapping + runtime equations + SRAM/DRAM traffic model; PyTorch
port of `repro.core.dataflow`.

GEMM convention (paper Table II): O[M, N] = W[M, K] @ X[K, N] with
  M = output features (weight rows), N = tokens/pixels, K = reduction.

Mapping dims (Sr, Sc, T):
  input-stationary  (is): (K, N, M)   X stationary on the array
  weight-stationary (ws): (K, M, N)   W stationary on the array
  output-stationary (os): (M, N, K)   O stationary on the array

Every function takes float32 tensors of any broadcastable shape (a
leading design axis against a trailing op axis is the sweep's case) and
computes in float32, operation for operation as the reference does, so
the two packages agree to the last bit on the same inputs. Ceil-division
is ``-(-a // b)``: tensor `//` is a floored division with the same
result as numpy's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .accelerator import AcceleratorConfig, MemoryConfig


def cdiv(a, b):
    return -(-a // b)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """`x` as a float32 tensor on `like`'s device (a Python number is
    rounded to float32 once, as JAX rounds a weakly typed scalar)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def map_gemm(dataflow: str, M, N, K) -> Tuple:
    """(Sr, Sc, T) per paper Table II."""
    if dataflow == "is":
        return K, N, M
    if dataflow == "ws":
        return K, M, N
    if dataflow == "os":
        return M, N, K
    raise ValueError(f"unknown dataflow {dataflow!r}")


def unmap_gemm(dataflow: str, Sr, Sc, T) -> Tuple:
    """Inverse of `map_gemm`: mapping dims (Sr, Sc, T) -> (M, N, K)."""
    if dataflow == "is":          # (Sr, Sc, T) = (K, N, M)
        return T, Sc, Sr
    if dataflow == "ws":          # (K, M, N)
        return Sc, T, Sr
    if dataflow == "os":          # (M, N, K)
        return Sr, Sc, T
    raise ValueError(f"unknown dataflow {dataflow!r}")


def fold_counts(Sr, Sc, R, C):
    return cdiv(Sr, R), cdiv(Sc, C)


def compute_cycles(dataflow: str, M, N, K, R, C):
    """Single-core compute cycles: (2R + C + T - 2) * ceil(Sr/R) * ceil(Sc/C)
    (the SCALE-Sim v2 analytical runtime, paper Eq. 1 with Pr=Pc=1)."""
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    fr, fc = fold_counts(Sr, Sc, R, C)
    return (2 * R + C + T - 2) * fr * fc


def pe_utilization(dataflow: str, M, N, K, R, C):
    """Useful MACs / (PEs * compute cycles)."""
    macs = 1.0 * M * N * K
    cyc = compute_cycles(dataflow, M, N, K, R, C)
    return macs / (1.0 * R * C * cyc)


def mapping_occupancy(dataflow: str, M, N, K, R, C):
    """Average fraction of the array occupied by the mapping (edge folds)."""
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    fr, fc = fold_counts(Sr, Sc, R, C)
    return (1.0 * Sr * Sc) / (1.0 * fr * R * fc * C)


def sram_traffic(dataflow: str, M, N, K, R, C) -> Dict[str, torch.Tensor]:
    """Aggregate SRAM demand counts (elements), SCALE-Sim v2 semantics.
    Keys: ifmap_reads (X), filter_reads (W), ofmap_writes, ofmap_reads."""
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    fr, fc = fold_counts(Sr, Sc, R, C)
    WK = 1.0 * M * K
    XK = 1.0 * K * N
    O = 1.0 * M * N
    if dataflow == "ws":          # W stationary, X streams, psums accumulate
        filter_reads = WK
        ifmap_reads = fc * XK
        ofmap_writes = fr * O
        ofmap_reads = (fr - 1) * O
    elif dataflow == "is":        # X stationary, W streams
        ifmap_reads = XK
        filter_reads = fc * WK
        ofmap_writes = fr * O
        ofmap_reads = (fr - 1) * O
    else:                         # os: O stationary, both operands stream
        filter_reads = fc * WK
        ifmap_reads = fr * XK
        ofmap_writes = O
        ofmap_reads = 0.0 * O
    return dict(ifmap_reads=ifmap_reads, filter_reads=filter_reads,
                ofmap_writes=ofmap_writes, ofmap_reads=ofmap_reads)


def dram_traffic(dataflow: str, M, N, K, R, C,
                 mem: MemoryConfig) -> Dict[str, torch.Tensor]:
    """Capacity-based DRAM traffic model (elements) over double-buffered
    SRAM: the cheaper of the two canonical loop orders (keep X resident /
    keep W resident), plus psum spill traffic when the psum working set
    exceeds the ofmap SRAM. `mem`'s byte fields are tensors here."""
    wb = mem.word_bytes
    WK = 1.0 * M * K
    XK = 1.0 * K * N
    O = 1.0 * M * N

    def cap(nbytes):                                  # elements, >= 1
        return torch.clamp_min(_f32(nbytes / wb, O), 1.0)

    cap_if = cap(mem.ifmap_sram_bytes)
    cap_f = cap(mem.filter_sram_bytes)
    cap_o = cap(mem.ofmap_sram_bytes)

    # order A: X resident in tiles of n_t columns; W refetched per tile.
    n_t = torch.minimum(torch.clamp_min(cap_if // torch.clamp_min(K, 1), 1),
                        N)
    total_a = XK + WK * cdiv(N, n_t)
    # order B: W resident in tiles of m_t rows; X refetched per tile.
    m_t = torch.minimum(torch.clamp_min(cap_f // torch.clamp_min(K, 1), 1),
                        M)
    total_b = WK + XK * cdiv(M, m_t)

    a_better = total_a <= total_b
    dram_x = torch.where(a_better, XK, XK * cdiv(M, m_t))
    dram_w = torch.where(a_better, WK * cdiv(N, n_t), WK)

    # psum spill: ws/is accumulate across ceil(Sr/R) row folds; spills if
    # the live psum tile (C cols * T) exceeds the ofmap SRAM.
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    fr, _ = fold_counts(Sr, Sc, R, C)
    live_psum = 1.0 * C * T
    spill = live_psum > cap_o
    if dataflow == "os":              # os psums never leave the array
        spill = torch.zeros_like(spill)
    spills = torch.where(spill, (fr - 1) * O, 0.0 * O)
    dram_o_writes = O + spills
    dram_o_reads = spills
    return dict(dram_ifmap=dram_x, dram_filter=dram_w,
                dram_ofmap_writes=dram_o_writes, dram_ofmap_reads=dram_o_reads)


def dram_stall_cycles_simple(total_bytes, compute_cycles_, bw_bytes_per_cycle):
    """First-order memory-bound stall: double-buffered transfer vs compute."""
    xfer = total_bytes / bw_bytes_per_cycle
    return torch.clamp_min(xfer - compute_cycles_, 0.0)


def simd_cycles(elements, lanes, latency=1.0):
    """Vector-unit cycles for pointwise/reduction ops (Sec. III-C)."""
    return cdiv(elements, lanes) * latency


def gemm_summary(cfg: AcceleratorConfig, M, N, K) -> Dict[str, torch.Tensor]:
    """Single-core end-to-end summary for one GEMM on core 0 (no DRAM cycle
    model). M, N, K are numbers or float32 tensors; numbers become float32
    scalars on the CPU, so every entry is a float32 tensor."""
    M, N, K = (x if isinstance(x, torch.Tensor)
               else torch.tensor(float(x), dtype=torch.float32)
               for x in (M, N, K))
    core = cfg.cores[0]
    R, C = core.rows, core.cols
    df = cfg.dataflow
    cyc = compute_cycles(df, M, N, K, R, C)
    sram = sram_traffic(df, M, N, K, R, C)
    dram = dram_traffic(df, M, N, K, R, C, cfg.memory)
    wb = cfg.memory.word_bytes
    dram_bytes = (dram["dram_ifmap"] + dram["dram_filter"]
                  + dram["dram_ofmap_writes"] + dram["dram_ofmap_reads"]) * wb
    bw = cfg.dram.bandwidth_bytes_per_cycle * cfg.dram.channels
    stall = dram_stall_cycles_simple(dram_bytes, cyc, bw)
    return dict(compute_cycles=cyc,
                utilization=pe_utilization(df, M, N, K, R, C),
                dram_bytes=dram_bytes,
                stall_cycles=stall,
                total_cycles=cyc + stall,
                **sram, **dram)
