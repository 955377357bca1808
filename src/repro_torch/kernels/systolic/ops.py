"""The cycle-level fold plane: one weight-stationary fold's functional output,
per-cycle PE activity and utilisation (`simulate_fold`), and the batched
activity of many folds (`batched_fold_activity`, the DSE fast path).

Where it runs follows the tensors: CUDA tensors launch the CUDA kernels
(`systolic.py`), which launch or raise; CPU tensors run their plain PyTorch
versions (`ref.py`). `cycles = 2R + C + T - 2` equals
`core.dataflow.compute_cycles` for one fold, and `active` equals the
per-cycle scan of `ref.systolic_ws_reference` after the R-cycle preload.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ref import (systolic_matmul_reference, total_cycles_ws,
                  wavefront_activity_plain)


class FoldSim(NamedTuple):
    out: torch.Tensor            # (T, C) functional result
    active: torch.Tensor         # (2R + C + T - 2,) int32 active PEs per cycle
    cycles: int
    utilization: torch.Tensor    # float32 scalar in [0, 1]


def fold_output(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """O = x @ w in promote_types(x, w): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.is_cuda:
        from .systolic import systolic_matmul
        return systolic_matmul(x.contiguous(), w.contiguous())
    return systolic_matmul_reference(x, w)


def batched_fold_activity(Ts: torch.Tensor, *, R: int, C: int,
                          n_cycles: int) -> torch.Tensor:
    """(B,) stream lengths -> (B, n_cycles) int32 active PEs per wavefront
    cycle of each fold, in one CUDA launch for a CUDA tensor (the plain
    version for a CPU tensor). Cycles past a fold's end are 0."""
    Ts = Ts.to(torch.int32)
    if Ts.is_cuda:
        from .systolic import wavefront_activity_batched
        return wavefront_activity_batched(Ts.contiguous(), R=R, C=C,
                                          n_cycles=n_cycles)
    return wavefront_activity_plain(Ts, R=R, C=C, n_cycles=n_cycles)


def fold_activity(T: int, *, R: int, C: int, n_cycles: int,
                  device) -> torch.Tensor:
    """One fold of T stream elements -> (n_cycles,) int32 active PEs per
    wavefront cycle on `device`: one CUDA launch with T as its argument on
    a CUDA device, the plain version on the CPU."""
    if torch.device(device).type == "cuda":
        from .systolic import wavefront_activity
        return wavefront_activity(T, R=R, C=C, n_cycles=n_cycles,
                                  device=device)
    Ts = torch.tensor([T], dtype=torch.int32, device=device)
    return wavefront_activity_plain(Ts, R=R, C=C, n_cycles=n_cycles)[0]


def simulate_fold(x: torch.Tensor, w: torch.Tensor) -> FoldSim:
    """Simulate one WS fold on the tensors' device: x (T, R) streamed,
    w (R, C) stationary."""
    T, R = x.shape
    C = w.shape[1]
    out = fold_output(x, w)
    wave = fold_activity(T, R=R, C=C, n_cycles=T + R + C - 2,
                         device=x.device)
    preload = torch.full((R,), C, dtype=torch.int32, device=x.device)
    active = torch.cat([preload, wave])       # weight rows shift in first
    cycles = total_cycles_ws(T, R, C)
    util = active.sum().to(torch.float32) / torch.tensor(
        float(R * C * cycles), dtype=torch.float32, device=x.device)
    return FoldSim(out, active, cycles, util)
