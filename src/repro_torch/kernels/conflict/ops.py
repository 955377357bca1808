"""The bank-conflict kernel's one dispatch, and the per-cycle slowdown of a
streaming access pattern (`layout_slowdown`).

Where it runs follows the tensors: CUDA tensors launch the CUDA kernel
(`conflict.py`), which launches or raises; CPU tensors run the plain
PyTorch version (`ref.py`).
"""
from __future__ import annotations

import torch

from ...core.accelerator import LayoutConfig


def per_cycle_slowdown(line: torch.Tensor, bank: torch.Tensor, *,
                       num_banks: int, ports: int = 1) -> torch.Tensor:
    """(cycles, k) line/bank ids -> (cycles,) int32 slowdown, >= 1: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. An id
    whose bank lies outside [0, num_banks) is counted in no bank, as in the
    reference."""
    if line.is_cuda:
        from .conflict import conflict_slowdown
        return conflict_slowdown(line.to(torch.int32).contiguous(),
                                 bank.to(torch.int32).contiguous(),
                                 num_banks=num_banks, ports=ports)
    from .ref import conflict_slowdown_reference
    return conflict_slowdown_reference(line, bank, num_banks=num_banks,
                                       ports=ports)


def layout_slowdown(cfg: LayoutConfig, *, R: int, n_cycles: int,
                    lead_stride: int, elem_stride: int, word_bytes: int = 2,
                    device="cuda") -> torch.Tensor:
    """Per-cycle slowdown of a systolic streaming pattern under a flat
    layout, on `device` (CUDA unless the caller asks for the CPU)."""
    from ...core.layout import flat_ids, streaming_access_pattern
    idx = streaming_access_pattern(R, n_cycles, lead_stride, elem_stride,
                                   device=device)
    line, _, bank = flat_ids(idx, cfg, word_bytes)
    return per_cycle_slowdown(line, bank, num_banks=cfg.num_banks,
                              ports=cfg.ports_per_bank)
