"""The ELLPACK packer's one dispatch, and its storage report (the
SPARSE_REPORT rows, paper Fig. 6).

Where it runs follows the tensor: a CUDA tensor launches the CUDA kernel
(`ellpack.py`), which launches or raises; a CPU tensor runs the plain
PyTorch version (`ref.py`).
"""
from __future__ import annotations

import torch

from ...core.sparsity import metadata_bits


def pack_ellpack(w: torch.Tensor, *, m: int, keep: int = 0):
    """w (rows, K) -> (vals, idx), each (rows, K//m, keep): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if w.is_cuda:
        from .ellpack import ellpack_pack
        return ellpack_pack(w.contiguous(), m=m, keep=keep)
    from .ref import ellpack_pack_plain
    return ellpack_pack_plain(w, m=m, keep=keep)


def pack_with_report(w: torch.Tensor, *, m: int, keep: int = 0):
    """Returns (vals, idx, report); the report mirrors SPARSE_REPORT.csv,
    with the stored nonzeros counted from the packed indices."""
    keep = keep or max(1, m // 2)
    vals, idx = pack_ellpack(w, m=m, keep=keep)
    nnz = int((idx >= 0).sum())
    wb = w.element_size()
    report = dict(
        representation="ellpack_block",
        original_bytes=float(w.numel() * wb),
        values_bytes=float(nnz * wb),
        metadata_bytes=float(nnz * metadata_bits(m) / 8.0),
    )
    report["total_bytes"] = report["values_bytes"] + report["metadata_bytes"]
    return vals, idx, report
