"""The ELLPACK packer: a hand-written CUDA kernel for Hopper and its wrapper.

Replaces the Pallas kernel `repro.kernels.ellpack.ellpack.ellpack_pack`.
One launch packs a whole (rows, K) matrix: one thread per (row, m-block)
walks its block once (see the note at the top of `csrc/ellpack_pack.cu`).
`ellpack_pack` builds the kernel on first use (`kernels._build`), checks
its inputs and launches it on the current CUDA stream; every launch adds
one to `LAUNCHES`. It launches or raises: there is no fallback. The plain
PyTorch versions are in `ref.py`, and `ops.py` picks between them by
device.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaLibrary
from .ref import check_pack_input

# Kernel launches since the last reset (`chip_smoke.py` reads it to show
# the ELLPACK plane went through the kernel).
LAUNCHES = 0

# dtype codes of the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LIB = CudaLibrary("ellpack_pack.cu", "ellpack_pack_launch",
                   [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG = ""


def build():
    """Compile (once per source version) and load the kernel; returns its
    C launch function."""
    global BUILD_LOG
    fn = _LIB.load()
    BUILD_LOG = _LIB.log
    return fn


def ellpack_pack(w: torch.Tensor, *, m: int, keep: int = 0):
    """w (rows, K) on a CUDA device, float32, bfloat16 or float16, K % m
    == 0 -> (vals (rows, K//m, keep) in w's dtype, idx (rows, K//m, keep)
    int32): each m-block's first `keep` nonzeros in order, with their
    intra-block positions; 0 and -1 fill the rest. `keep` defaults to
    max(1, m // 2). Inputs must be finite (see `ref.py`)."""
    global LAUNCHES
    check_pack_input(w, m)
    if not w.is_cuda:
        raise ValueError(f"w must be a CUDA tensor, got {w.device}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    rows, K = w.shape
    keep = keep or max(1, m // 2)
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    vals = torch.empty((rows, K // m, keep), dtype=w.dtype, device=w.device)
    idx = torch.empty((rows, K // m, keep), dtype=torch.int32,
                      device=w.device)
    nblocks = rows * (K // m)
    if nblocks == 0:
        return vals, idx            # nothing to launch
    launch = build()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(w.data_ptr(), vals.data_ptr(), idx.data_ptr(), nblocks,
                     m, keep, _DTYPE_CODE[w.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ELLPACK kernel launch failed: CUDA error {err} "
                           f"(rows={rows}, K={K}, m={m}, keep={keep})")
    LAUNCHES += 1
    return vals, idx
