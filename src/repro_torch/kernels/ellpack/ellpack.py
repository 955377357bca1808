"""The ELLPACK packer: a hand-written CUDA kernel for Hopper and its wrapper.

Replaces the Pallas kernel `repro.kernels.ellpack.ellpack.ellpack_pack`.
One launch packs a whole (rows, K) matrix through one of two instances of
`csrc/ellpack_pack.cu` (see the note at its top): the vector path (whole
blocks by 16- or 8-byte loads, ranks from a bit mask, one store each for a
block's values and indices) or the scalar path (one thread per block,
element by element). The C entry picks it from w's pointer, m, keep and
the element size; `path_for` asks it which. `ellpack_pack` builds the
kernel on first use (`kernels._build`), checks its inputs and launches it
on the current CUDA stream; every launch adds one to `LAUNCHES`. It
launches or raises: there is no fallback. The plain PyTorch versions are
in `ref.py`, and `ops.py` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaLibrary
from .ref import check_pack_input

# Kernel launches since the last reset (`chip_smoke.py` reads it to show
# the ELLPACK plane went through the kernel).
LAUNCHES = 0

_LIB = CudaLibrary("ellpack_pack.cu", "ellpack_pack_launch",
                   [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG = ""


def path_for(w: torch.Tensor, m: int, keep: int) -> str:
    """"vector" or "scalar": the path the kernel takes for w at (m, keep),
    as its C entry picks it from w's pointer, m, keep and element size
    (builds the kernel)."""
    fn = _LIB.function("ellpack_path_for", [ctypes.c_void_p]
                       + [ctypes.c_int] * 3, ctypes.c_int)
    return ("vector" if fn(w.data_ptr(), m, keep, w.element_size())
            else "scalar")


def build():
    """Compile (once per source version) and load the kernel; returns its
    C launch function."""
    global BUILD_LOG
    fn = _LIB.load()
    BUILD_LOG = _LIB.log
    return fn


def ellpack_pack(w: torch.Tensor, *, m: int, keep: int = 0):
    """w (rows, K) on a CUDA device, K % m == 0, float32, bfloat16,
    float16, int8, uint8, int16 or int32 -> (vals (rows, K//m, keep) in
    w's dtype, idx (rows, K//m, keep)
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
                     m, keep, w.element_size(),
                     int(not w.dtype.is_floating_point), stream)
    if err != 0:
        raise RuntimeError(f"ELLPACK kernel launch failed: CUDA error {err} "
                           f"(rows={rows}, K={K}, m={m}, keep={keep}, "
                           f"{w.dtype})")
    LAUNCHES += 1
    return vals, idx
