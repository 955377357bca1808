"""The bank-conflict kernel: a hand-written CUDA kernel for Hopper and its
wrapper.

Replaces the Pallas kernel `repro.kernels.conflict.conflict.conflict_slowdown`.
One launch computes the per-cycle slowdown of every row: for k <= 256 a
few lanes of a warp hold a row's (bank, line) pairs as packed keys, sort
them in registers and count the distinct pairs per bank by scans; longer
rows go to a shared-memory instance (see the note at the top of
`csrc/conflict_slowdown.cu`). `conflict_slowdown` builds the kernel on
first use (`kernels._build`), checks its inputs and launches it on the
current CUDA stream; every launch adds one to `LAUNCHES` and to its
card's entry of `LAUNCHES_BY_CARD`. It launches or raises: there is no
fallback. The plain PyTorch version is `ref.py`, and
`ops.py` picks between the two by device.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .._build import CudaLibrary

# Kernel launches since the last reset (the sweep and `chip_smoke.py` read
# it to show the main path went through the kernel), in all and by card
# index.
LAUNCHES = 0
LAUNCHES_BY_CARD: collections.Counter = collections.Counter()

# the shared-memory instance keeps 3 int32 per id for each of its 4 warps,
# at most the 227 KB a block may use
MAX_K = (227 * 1024) // (4 * 3 * 4)
# the kernel's instances: register widths (rows of up to that many ids) and
# -1, shared memory (any k); 0 lets the kernel pick by k
INSTANCES = (32, 64, 128, 256, -1)

_LIB = CudaLibrary("conflict_slowdown.cu", "conflict_slowdown_launch",
                   [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG = ""


def build():
    """Compile (once per source version) and load the kernel; returns its
    C launch function."""
    global BUILD_LOG
    fn = _LIB.load()
    BUILD_LOG = _LIB.log
    return fn


def instance_for(k: int) -> int:
    """The instance the kernel runs for rows of k ids (builds the kernel):
    the smallest register width of `INSTANCES` that holds k, or -1."""
    fn = _LIB.function("conflict_slowdown_instance", [ctypes.c_int],
                       ctypes.c_int)
    return int(fn(k))


def conflict_slowdown(line: torch.Tensor, bank: torch.Tensor, *,
                      num_banks: int, ports: int = 1,
                      instance: int = 0) -> torch.Tensor:
    """(cycles, k) int32 line/bank ids on a CUDA device -> (cycles,) int32
    slowdown, >= 1: per cycle, max over banks of ceil(distinct (bank, line)
    pairs in the bank / ports).

    `instance` 0 lets the kernel pick its instance by k (`instance_for`);
    tests and measurements name one of `INSTANCES` to run it on rows it
    can take.

    An id whose bank lies outside [0, num_banks), negative included, is
    counted in no bank, as the reference's one-hot drops it: the kernel
    masks it at load time (the layout stage's `flat_ids` never makes
    one)."""
    global LAUNCHES
    if line.dim() != 2 or line.shape != bank.shape:
        raise ValueError(f"line and bank must be (cycles, k) of one shape, "
                         f"got {tuple(line.shape)} and {tuple(bank.shape)}")
    for x, name in ((line, "line"), (bank, "bank")):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bank.device != line.device:
        raise ValueError(f"bank is on {bank.device}, line on {line.device}")
    if num_banks < 1 or ports < 1:
        raise ValueError(f"num_banks and ports must be >= 1, got "
                         f"{num_banks} and {ports}")
    rows, k = line.shape
    if k > MAX_K:
        raise ValueError(f"k = {k} ids per cycle exceed the kernel's "
                         f"shared-memory limit of {MAX_K}")
    if instance != 0 and (instance not in INSTANCES
                          or 0 < instance < k or (instance > 0 and k == 0)):
        raise ValueError(f"instance {instance} cannot take rows of k = {k} "
                         f"ids (instances: {INSTANCES})")
    out = torch.empty((rows,), dtype=torch.int32, device=line.device)
    if rows == 0:
        return out                  # nothing to launch
    launch = build()
    with torch.cuda.device(line.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(line.data_ptr(), bank.data_ptr(), out.data_ptr(),
                     rows, k, int(num_banks), int(ports), int(instance),
                     stream)
    if err != 0:
        raise RuntimeError(f"conflict kernel launch failed: CUDA error {err} "
                           f"(rows={rows}, k={k})")
    LAUNCHES += 1
    LAUNCHES_BY_CARD[line.device.index] += 1
    return out
