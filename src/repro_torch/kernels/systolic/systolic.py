"""The systolic fold kernels: two hand-written CUDA kernels for Hopper and
their wrappers.

- `systolic_matmul` replaces the Pallas kernel
  `repro.kernels.systolic.systolic.systolic_matmul`: one fold's functional
  output O = x @ w in the promoted dtype: float32 accumulation and one
  rounding for a float result, wrapping 32-bit sums narrowed for an
  integer one (`csrc/systolic_matmul.cu`).
- `wavefront_activity_batched` replaces
  `repro.kernels.systolic.systolic.wavefront_activity`, batched by
  construction: a (B,) int32 array of stream lengths -> (B, n_cycles)
  active-PE counts in one launch, in closed form
  (`csrc/wavefront_activity.cu`); `wavefront_activity` is its one-fold
  entry, which takes T as a kernel argument.

Each builds its kernel on first use (`kernels._build`), checks its inputs
and launches on the current CUDA stream; every launch adds one to
`MATMUL_LAUNCHES` or `WAVEFRONT_LAUNCHES`. They launch or raise: there is
no fallback. The plain PyTorch versions are in `ref.py`, and `ops.py`
picks between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import CudaLibrary
from .ref import check_matmul_dtypes

# Kernel launches since the last reset (`chip_smoke.py` reads them to show
# the fold plane went through the kernels).
MATMUL_LAUNCHES = 0
WAVEFRONT_LAUNCHES = 0

# dtype codes of the C entry points
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.int32: 6}

_MATMUL = CudaLibrary("systolic_matmul.cu", "systolic_matmul_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
_WAVEFRONT = CudaLibrary("wavefront_activity.cu", "wavefront_activity_launch",
                         [ctypes.c_void_p] * 2
                         + [ctypes.c_longlong] + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
_WAVEFRONT_SCALAR = ("wavefront_activity_scalar_launch",
                     [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p], ctypes.c_int)
# ptxas reports (registers, shared memory, spills) of the last builds
MATMUL_BUILD_LOG = ""
WAVEFRONT_BUILD_LOG = ""


def build_matmul():
    """Compile (once per source version) and load the matmul kernel;
    returns its C launch function."""
    global MATMUL_BUILD_LOG
    fn = _MATMUL.load()
    MATMUL_BUILD_LOG = _MATMUL.log
    return fn


def build_wavefront():
    """Compile (once per source version) and load the wavefront kernel;
    returns its C launch function."""
    global WAVEFRONT_BUILD_LOG
    fn = _WAVEFRONT.load()
    WAVEFRONT_BUILD_LOG = _WAVEFRONT.log
    return fn


def matmul_blocks(T: int, C: int) -> int:
    """Blocks of the matmul kernel's grid for a (T, C) output, as the
    kernel counts them (builds the kernel)."""
    fn = _MATMUL.function("systolic_matmul_blocks", [ctypes.c_int] * 2,
                          ctypes.c_longlong)
    return int(fn(T, C))


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def systolic_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (T, R), w (R, C) CUDA tensors of float32, bfloat16, float16,
    int8, uint8, int16 or int32 in any mix -> O = x @ w (T, C) in
    promote_types(x, w), each operand cast to it first: accumulated in
    float32 for a float O, modulo 2^32 and narrowed for an integer O."""
    global MATMUL_LAUNCHES
    out_dtype = check_matmul_dtypes(x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x (T, R) and w (R, C) must chain, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    _check_cuda(x, "x")
    _check_cuda(w, "w")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    (T, R), C = x.shape, w.shape[1]
    if max(T, R, C) >= 2 ** 31:
        raise ValueError(f"fold {T} x {R} x {C} exceeds the kernel's int32 "
                         f"sizes")
    out = torch.empty((T, C), dtype=out_dtype, device=x.device)
    if T == 0 or C == 0:
        return out                  # nothing to launch
    launch = build_matmul()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), T, R, C,
                     _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], stream)
    if err != 0:
        raise RuntimeError(f"systolic matmul launch failed: CUDA error {err} "
                           f"(T={T}, R={R}, C={C})")
    MATMUL_LAUNCHES += 1
    return out


def _check_wavefront_shape(R: int, C: int, n_cycles: int) -> None:
    if R < 1 or C < 1 or n_cycles < 0:
        raise ValueError(f"need R, C >= 1 and n_cycles >= 0, got R={R}, "
                         f"C={C}, n_cycles={n_cycles}")
    if n_cycles + R + C >= 2 ** 31:
        raise ValueError(f"n_cycles = {n_cycles} overflows the kernel's "
                         f"int32 cycle index")


def wavefront_activity_batched(Ts: torch.Tensor, *, R: int, C: int,
                               n_cycles: int) -> torch.Tensor:
    """(B,) int32 stream lengths on a CUDA device -> (B, n_cycles) int32
    active PEs per cycle of each fold's skewed R x C wavefront; cycles at
    or past T + R + C - 2 are 0."""
    global WAVEFRONT_LAUNCHES
    if Ts.dim() != 1:
        raise ValueError(f"Ts must be (B,), got {tuple(Ts.shape)}")
    if Ts.dtype != torch.int32:
        raise TypeError(f"Ts must be torch.int32, got {Ts.dtype}")
    _check_cuda(Ts, "Ts")
    _check_wavefront_shape(R, C, n_cycles)
    B = Ts.shape[0]
    out = torch.empty((B, n_cycles), dtype=torch.int32, device=Ts.device)
    if B == 0 or n_cycles == 0:
        return out                  # nothing to launch
    launch = build_wavefront()
    with torch.cuda.device(Ts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(Ts.data_ptr(), out.data_ptr(), B, n_cycles, R, C,
                     stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err} (B={B}, n_cycles={n_cycles}, R={R})")
    WAVEFRONT_LAUNCHES += 1
    return out


def wavefront_activity(T: int, *, R: int, C: int, n_cycles: int,
                       device="cuda") -> torch.Tensor:
    """One fold of T stream elements -> (n_cycles,) int32 active PEs per
    wavefront cycle on the CUDA `device`, T passed to the kernel as an
    argument (no device tensor holds it)."""
    global WAVEFRONT_LAUNCHES
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the wavefront kernel runs on a CUDA device, got "
                         f"{device}")
    T = int(T)
    if not -2 ** 31 <= T < 2 ** 31:
        raise ValueError(f"T = {T} is not an int32")
    _check_wavefront_shape(R, C, n_cycles)
    out = torch.empty((n_cycles,), dtype=torch.int32, device=device)
    if n_cycles == 0:
        return out                  # nothing to launch
    build_wavefront()
    launch = _WAVEFRONT.function(*_WAVEFRONT_SCALAR)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(T, out.data_ptr(), n_cycles, R, C, stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err} (T={T}, n_cycles={n_cycles}, R={R})")
    WAVEFRONT_LAUNCHES += 1
    return out


def launch_floor() -> None:
    """Launch the wavefront library's empty kernel once on the current CUDA
    stream, through ctypes as the entries above launch theirs: the floor
    under any launch of this path, for measurements. Not counted."""
    fn = _WAVEFRONT.function("wavefront_empty_launch", [ctypes.c_void_p],
                             ctypes.c_int)
    err = fn(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
