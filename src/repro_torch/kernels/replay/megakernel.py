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
  every launch adds one to `LAUNCHES` and to its card's entry of
  `LAUNCHES_BY_CARD`. It launches or raises: there is no fallback.
- `run_plain` is the same function in plain PyTorch (`chunkmath`), driven
  by a Python loop over chunks with the streams as a leading batch axis.

`core.replay.replay_decoded` picks between the two. Both take a stream
merged from `n_cores` cores (each request's core id selects its issue
shift; `shift` comes back per core) and `n_qg` in-flight queue groups per
direction (1, or one per channel for the shared-DRAM contention path).
The sweep replays each stream as one core's with one queue group, as the
reference sweep does; the kernel runs that case in its single-core
instance. `MAX_CORES` and `MAX_QUEUE_GROUPS` are the kernel's limits.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from ...core.accelerator import DramConfig
from .._build import CudaLibrary
from . import chunkmath as cm

# Kernel launches since the last reset (the sweep and `chip_smoke.py` read
# it to show the main path went through the kernel), in all and by card
# index.
LAUNCHES = 0
LAUNCHES_BY_CARD: collections.Counter = collections.Counter()

# The kernel's limits (`kMaxCores`, `kMaxGroups` in the .cu): cores per
# merged stream and queue groups per direction.
MAX_CORES = 32
MAX_QUEUE_GROUPS = 32

_LIB = CudaLibrary("replay_megakernel.cu", "replay_megakernel_launch",
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
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


def check_modes(cfg: DramConfig, n_cores: int, n_qg: int) -> None:
    """Refuse a core count or queue-group count the kernel does not take:
    n_cores in [1, MAX_CORES], n_qg 1 or cfg.channels, at most
    MAX_QUEUE_GROUPS."""
    if not 1 <= n_cores <= MAX_CORES:
        raise ValueError(f"n_cores = {n_cores} outside the kernel's "
                         f"[1, {MAX_CORES}]")
    if n_qg not in (1, cfg.channels):
        raise ValueError(f"n_qg must be 1 or the channel count "
                         f"{cfg.channels}, got {n_qg}")
    if n_qg > MAX_QUEUE_GROUPS:
        raise ValueError(f"n_qg = {n_qg} queue groups exceed the kernel's "
                         f"{MAX_QUEUE_GROUPS}")


def _check_ids(ins, *, n_banks: int, ch_n: int,
               n_cores: Optional[int] = None) -> None:
    """Bank/channel ids of valid requests (and core ids, when the kernel
    reads them: `n_cores` given) index shared-memory state inside the
    kernel; refuse out-of-range ids before launching, with one device
    sync."""
    _, fb, ch, _, _, v, cid = ins
    vm = v != 0
    ids = [(fb, n_banks, "flat_bank"), (ch, ch_n, "ch")]
    if n_cores is not None:
        ids.append((cid, n_cores, "core_id"))
    bad = torch.stack([(vm & ((x < 0) | (x >= hi))).any()
                       for x, hi, _ in ids]).tolist()
    for (_, hi, name), b in zip(ids, bad):
        if b:
            raise ValueError(f"{name} of a valid request outside [0, {hi})")


def launch_cuda(ins, *, cfg: DramConfig, busy: float, C: int,
                max_passes: Optional[int], tol: float, n_cores: int = 1,
                n_qg: int = 1, grouped: bool = False,
                check_ids: bool = True):
    """Launch the CUDA kernel on prepared (S, npad) inputs
    (t f32; fb, ch, row, w, v, cid int32). Returns (done, shift
    (S, n_cores), cnt). `n_cores = n_qg = 1` runs the single-core instance
    unless `grouped` asks for the multi-core one (tests hold the two
    against each other). `check_ids=False` skips the range check of the
    ids (a device sync) for inputs already checked, as a measurement that
    replays a CUDA graph of launches does."""
    global LAUNCHES
    t = ins[0]
    S, npad = t.shape
    if C < 1 or npad % C:
        raise ValueError(f"stream length {npad} is not a multiple of the "
                         f"chunk {C}")
    check_modes(cfg, n_cores, n_qg)
    _check(t, "t_issue", torch.float32, (S, npad))
    for x, name in zip(ins[1:], ("flat_bank", "ch", "row", "is_write",
                                 "valid", "core_id")):
        _check(x, name, torch.int32, (S, npad))
        if x.device != t.device:
            raise ValueError(f"{name} is on {x.device}, t_issue on "
                             f"{t.device}")
    multi = grouped or n_cores > 1 or n_qg > 1      # the kernel reads cid
    if check_ids:
        _check_ids(ins, n_banks=cfg.channels * cfg.banks_per_channel,
                   ch_n=cfg.channels, n_cores=n_cores if multi else None)
    launch = build()
    done = torch.empty((S, npad), dtype=torch.float32, device=t.device)
    shift = torch.empty((S, n_cores), dtype=torch.float32, device=t.device)
    cnt = torch.empty((S, 4), dtype=torch.int32, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            *(x.data_ptr() for x in ins), done.data_ptr(), shift.data_ptr(),
            cnt.data_ptr(), S, npad // C, C, cfg.channels,
            cfg.banks_per_channel, cfg.tRCD, cfg.tRP, cfg.tCAS,
            cfg.read_queue, cfg.write_queue, int(n_cores), int(n_qg),
            int(multi),
            -1 if max_passes is None else int(max_passes), float(busy),
            float(tol), stream)
    if err != 0:
        raise RuntimeError(f"replay megakernel launch failed: CUDA error "
                           f"{err} (S={S}, C={C}, n_cores={n_cores}, "
                           f"n_qg={n_qg}, "
                           f"queues={cfg.read_queue}/{cfg.write_queue})")
    LAUNCHES += 1
    LAUNCHES_BY_CARD[t.device.index] += 1
    return done, shift, cnt


def run_plain(ins, *, cfg: DramConfig, busy: float, C: int,
              max_passes: Optional[int], tol: float, n_cores: int = 1,
              n_qg: int = 1):
    """The kernel's function in plain PyTorch, on the same prepared
    inputs. Returns (done, shift (S, n_cores), cnt, passes); `passes`
    (S, nc) counts the fixed-point passes of every (stream, chunk)."""
    check_modes(cfg, n_cores, n_qg)
    t, fb, ch, row, w, v, cid = ins
    S, npad = t.shape
    nc = npad // C
    state = cm.init_state(
        S, n_banks=cfg.channels * cfg.banks_per_channel, ch_n=cfg.channels,
        Qr=cfg.read_queue, Qw=cfg.write_queue, device=t.device,
        n_cores=n_cores, n_qg=n_qg)
    done = torch.empty_like(t)
    cnt = torch.zeros((S, 4), dtype=torch.int32, device=t.device)
    passes = torch.empty((S, nc), dtype=torch.int32, device=t.device)
    for k in range(nc):
        sl = slice(k * C, (k + 1) * C)
        tk, fbk, chk, rowk = t[:, sl], fb[:, sl], ch[:, sl], row[:, sl]
        wk, vk = w[:, sl] != 0, v[:, sl] != 0
        tab = cm.chunk_tables(fbk, chk, rowk, wk, vk, cid[:, sl], cfg=cfg,
                              busy=busy, n_cores=n_cores, n_qg=n_qg)
        state, done[:, sl], counts, passes[:, k] = cm.chunk_resolve(
            state, tab, tk, rowk, wk, vk, fbk, chk, cfg=cfg, busy=busy,
            max_passes=max_passes, tol=tol)
        cnt[:, :3] += counts.to(torch.int32)
    return done, state.shift, cnt, passes


def prepare(t_issue, flat_bank, ch, row, is_write, valid, C: int,
            core_id=None):
    """(..., n) request arrays -> seven contiguous (S, npad) kernel inputs,
    padded with invalid requests to a multiple of the chunk C; the last
    is the core id (all zeros when `core_id` is None: a single core)."""
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
    cid = (torch.zeros((S, npad), dtype=i32, device=t_issue.device)
           if core_id is None else flat(core_id, i32))
    return (flat(t_issue, torch.float32), flat(flat_bank, i32), flat(ch, i32),
            flat(row, i32), flat(is_write, i32), flat(valid, i32), cid)
