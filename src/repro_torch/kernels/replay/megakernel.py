"""The trace-replay megakernel: a hand-written CUDA kernel for Hopper, its
wrapper, and its plain PyTorch version.

Replaces the Pallas kernel `repro.kernels.replay.megakernel.replay_megakernel`.
One launch replays a whole batch of decoded request streams: one warp
per stream, several streams per block, the chunk loop and the stream's
architectural state inside the warp (see the note at the top of
`csrc/replay_megakernel.cu`).

- `prepare` pads (..., n) request arrays into the kernel's (S, npad)
  inputs.
- `launch_cuda` builds the kernel on first use (nvcc, `sm_90a`, into
  `build/kernels/` of the checkout), binds its plain C entry point with
  ctypes, checks its inputs and launches it on the current CUDA stream;
  every launch adds one to `LAUNCHES`. It launches or raises: there is no
  fallback.
- `run_plain` is the same function in plain PyTorch (`chunkmath`), driven
  by a Python loop over chunks with the streams as a leading batch axis.

`core.replay.replay_decoded` picks between the two. Both replay each
stream as one core's, with one in-flight queue per direction (the
sweep's streams of multi-core designs included, as in the reference
sweep): the C entry point's `n_cores` and `n_qg` are fixed at 1 here
(the kernel refuses any other value), and its core-id input is all zeros.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...core.accelerator import DramConfig
from .._build import CudaLibrary
from . import chunkmath as cm

# Kernel launches since the last reset (the sweep and `chip_smoke.py` read
# it to show the main path went through the kernel).
LAUNCHES = 0

_LIB = CudaLibrary("replay_megakernel.cu", "replay_megakernel_launch",
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG = ""


def build():
    """Compile (once per source version) and load the kernel; returns its
    C launch function."""
    global BUILD_LOG
    fn = _LIB.load()
    BUILD_LOG = _LIB.log
    return fn


def _check(x: torch.Tensor, name: str, dtype, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ids(ins, *, n_banks: int, ch_n: int) -> None:
    """Bank/channel ids of valid requests index shared-memory state inside
    the kernel; refuse out-of-range ids before launching."""
    _, fb, ch, _, _, v, _ = ins
    vm = v != 0
    for x, hi, name in ((fb, n_banks, "flat_bank"), (ch, ch_n, "ch")):
        bad = vm & ((x < 0) | (x >= hi))
        if bool(bad.any()):
            raise ValueError(f"{name} of a valid request outside [0, {hi})")


def launch_cuda(ins, *, cfg: DramConfig, busy: float, C: int,
                max_passes: Optional[int], tol: float):
    """Launch the CUDA kernel on prepared (S, npad) inputs
    (t f32; fb, ch, row, w, v, cid int32). Returns (done, shift (S, 1),
    cnt)."""
    global LAUNCHES
    t = ins[0]
    S, npad = t.shape
    if C < 1 or npad % C:
        raise ValueError(f"stream length {npad} is not a multiple of the "
                         f"chunk {C}")
    _check(t, "t_issue", torch.float32, (S, npad))
    for x, name in zip(ins[1:], ("flat_bank", "ch", "row", "is_write",
                                 "valid", "core_id")):
        _check(x, name, torch.int32, (S, npad))
        if x.device != t.device:
            raise ValueError(f"{name} is on {x.device}, t_issue on "
                             f"{t.device}")
    _check_ids(ins, n_banks=cfg.channels * cfg.banks_per_channel,
               ch_n=cfg.channels)
    launch = build()
    done = torch.empty((S, npad), dtype=torch.float32, device=t.device)
    shift = torch.empty((S, 1), dtype=torch.float32, device=t.device)
    cnt = torch.empty((S, 4), dtype=torch.int32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            *(x.data_ptr() for x in ins), done.data_ptr(), shift.data_ptr(),
            cnt.data_ptr(), S, npad // C, C, cfg.channels,
            cfg.banks_per_channel, cfg.tRCD, cfg.tRP, cfg.tCAS,
            cfg.read_queue, cfg.write_queue, 1, 1,     # n_cores, n_qg
            -1 if max_passes is None else int(max_passes), float(busy),
            float(tol), stream)
    if err != 0:
        raise RuntimeError(f"replay megakernel launch failed: CUDA error "
                           f"{err} (S={S}, C={C}, "
                           f"queues={cfg.read_queue}/{cfg.write_queue})")
    LAUNCHES += 1
    return done, shift, cnt


def run_plain(ins, *, cfg: DramConfig, busy: float, C: int,
              max_passes: Optional[int], tol: float):
    """The kernel's function in plain PyTorch, on the same prepared
    inputs. Returns (done, shift (S, 1), cnt, passes); `passes` (S, nc)
    counts the fixed-point passes of every (stream, chunk)."""
    t, fb, ch, row, w, v, _ = ins
    S, npad = t.shape
    nc = npad // C
    state = cm.init_state(
        S, n_banks=cfg.channels * cfg.banks_per_channel, ch_n=cfg.channels,
        Qr=cfg.read_queue, Qw=cfg.write_queue, device=t.device)
    done = torch.empty_like(t)
    cnt = torch.zeros((S, 4), dtype=torch.int32, device=t.device)
    passes = torch.empty((S, nc), dtype=torch.int32, device=t.device)
    for k in range(nc):
        sl = slice(k * C, (k + 1) * C)
        tk, fbk, chk, rowk = t[:, sl], fb[:, sl], ch[:, sl], row[:, sl]
        wk, vk = w[:, sl] != 0, v[:, sl] != 0
        tab = cm.chunk_tables(fbk, chk, rowk, wk, vk, cfg=cfg, busy=busy)
        state, done[:, sl], counts, passes[:, k] = cm.chunk_resolve(
            state, tab, tk, rowk, wk, vk, fbk, chk, cfg=cfg, busy=busy,
            max_passes=max_passes, tol=tol)
        cnt[:, :3] += counts.to(torch.int32)
    return done, state.shift[:, None], cnt, passes


def prepare(t_issue, flat_bank, ch, row, is_write, valid, C: int):
    """(..., n) request arrays -> seven contiguous (S, npad) kernel inputs,
    padded with invalid requests to a multiple of the chunk C; the last
    is the all-zero core id of a single-core design."""
    batch = t_issue.shape[:-1]
    n = t_issue.shape[-1]
    npad = -(-n // C) * C
    S = 1
    for b in batch:
        S *= int(b)

    def flat(x, dtype):
        x = torch.broadcast_to(x, batch + (n,)).to(dtype).reshape(S, n)
        if npad > n:
            x = torch.cat([x, x.new_zeros((S, npad - n))], dim=-1)
        return x.contiguous()

    i32 = torch.int32
    return (flat(t_issue, torch.float32), flat(flat_bank, i32), flat(ch, i32),
            flat(row, i32), flat(is_write, i32), flat(valid, i32),
            torch.zeros((S, npad), dtype=i32, device=t_issue.device))

