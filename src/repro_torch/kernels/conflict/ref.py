"""The bank-conflict kernel's plain PyTorch version: sort-based distinct
counting, the form of the reference's `core.layout._distinct_slowdown`.

The composite key is built in int64. The reference forms it in int32 with
the line maximum taken per (design, op) under its vmap; one batched call
here takes a single maximum over the whole batch, which could overflow
int32 where the reference does not."""
from __future__ import annotations

import torch


def conflict_slowdown_reference(line: torch.Tensor, bank: torch.Tensor, *,
                                num_banks: int, ports: int = 1
                                ) -> torch.Tensor:
    """(cycles, k) line/bank ids -> (cycles,) int32 slowdown, >= 1, on the
    tensors' device. An id whose bank lies outside [0, num_banks) is
    counted in no bank, as the reference's one-hot against
    `iota(num_banks)` drops it: it is moved to an extra bank column (line
    0) that the maximum never reads."""
    line = line.to(torch.int64)
    bank = bank.to(torch.int64)
    cycles = line.shape[0]
    if cycles == 0:
        return torch.empty((0,), dtype=torch.int32, device=line.device)
    out = (bank < 0) | (bank >= num_banks)
    bank = torch.where(out, num_banks, bank)
    line = torch.where(out, 0, line)
    stride = line.max() + 1
    key = torch.sort(bank * stride + line, dim=1).values
    new = torch.ones_like(key, dtype=torch.int32)
    new[:, 1:] = (key[:, 1:] != key[:, :-1]).to(torch.int32)
    counts = torch.zeros((cycles, num_banks + 1), dtype=torch.int32,
                         device=line.device)
    counts.scatter_add_(1, key // stride, new)
    per_bank = -(-counts[:, :num_banks] // ports)
    return per_bank.max(dim=1).values.clamp_min(1).to(torch.int32)
