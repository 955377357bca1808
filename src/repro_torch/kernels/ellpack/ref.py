"""Plain PyTorch versions of the ELLPACK packer.

- `ellpack_pack_reference`: `core.sparsity.pack_ellpack_block` (a stable
  sort) truncated or padded to the kernel's fixed `keep` slots, the
  oracle.
- `ellpack_pack_plain`: the kernel's own formulation on tensors, which
  `ops.py` runs for CPU tensors: each nonzero's rank is the count of
  nonzeros before it in its block (a cumulative sum), and slot j gathers
  the element of rank j.
Both copy values, floats and integers alike (an integer's zero is 0,
its most negative value is not zero). The plain version equals the CUDA
kernel bit for bit;
the reference equals it by value (a padding slot there may keep one of
the block's -0.0 zeros where the kernel writes +0.0). The Pallas kernel
selects through a one-hot contraction instead, which agrees on finite
inputs only (a NaN or +-Inf there spreads NaN over its block).
"""
from __future__ import annotations

import torch

from ...core.sparsity import pack_ellpack_block
from .._dtypes import DTYPES, refusal

# the input dtypes the packer takes (the CUDA kernel's too)
PACK_DTYPES = DTYPES


def check_pack_input(w: torch.Tensor, m: int) -> None:
    """TypeError for a dtype the packer does not take, saying why;
    ValueError unless w is (rows, K) with K a multiple of m."""
    if w.dtype not in PACK_DTYPES:
        raise TypeError(f"w is {w.dtype}: {refusal(w.dtype)}")
    if w.dim() != 2:
        raise ValueError(f"w must be (rows, K), got {tuple(w.shape)}")
    if m < 1 or w.shape[1] % m:
        raise ValueError(f"K = {w.shape[1]} is not a multiple of m = {m}")


def ellpack_pack_reference(w: torch.Tensor, *, m: int, keep: int = 0):
    """w (rows, K) -> (vals, idx), each (rows, K//m, keep)."""
    keep = keep or max(1, m // 2)
    vals, idx, _ = pack_ellpack_block(w, m)
    cur = vals.shape[-1]
    if cur >= keep:
        return vals[..., :keep], idx[..., :keep]
    pad = (0, keep - cur)
    return (torch.nn.functional.pad(vals, pad),
            torch.nn.functional.pad(idx, pad, value=-1))


def ellpack_pack_plain(w: torch.Tensor, *, m: int, keep: int = 0):
    """w (rows, K), K % m == 0 -> (vals (rows, K//m, keep) in w's dtype,
    idx (rows, K//m, keep) int32, -1 past a block's nonzeros). A block with
    more than `keep` nonzeros keeps its first `keep`."""
    check_pack_input(w, m)
    rows, K = w.shape
    keep = keep or max(1, m // 2)
    wb = w.reshape(rows, K // m, m)
    nz = wb != 0
    seen = torch.cumsum(nz, dim=-1, dtype=torch.int32)  # rank + 1 at a nonzero
    j = torch.arange(keep, dtype=torch.int32, device=w.device)
    # the element of rank j sits at the position equal to the number of
    # positions whose running count is still <= j
    pos = (seen[..., None, :] <= j[:, None]).sum(-1, dtype=torch.int32)
    filled = j < seen[..., -1:]
    vals = torch.where(filled, torch.take_along_dim(
        wb, pos.clamp_max(m - 1).to(torch.int64), dim=-1),
        torch.zeros((), dtype=w.dtype, device=w.device))
    idx = torch.where(filled, pos, -1).to(torch.int32)
    return vals, idx
