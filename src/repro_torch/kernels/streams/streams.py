"""The streams kernel: a hand-written CUDA kernel for Hopper that
generates, orders by issue time and decodes a batch of demand-request
streams in one launch, and its wrapper.

Replaces no Pallas kernel: the reference computes the layer in `jnp`
(see the note at the top of `csrc/request_streams.cu`). `request_streams`
packs the per-stream factors of a `trace.generator.StreamPrologue` into
one row of 64 float32 a stream (on the host for the sweep, then one copy
to the card), builds the kernel on first use (`kernels._build`),
launches it on the current CUDA stream of the target device and reads
back the least and greatest address of every slot, raising
`core.dram.check_addresses`' error when they leave [0, 2^31): one
device read a launch. Every launch adds one to `LAUNCHES`
and to its card's entry of `LAUNCHES_BY_CARD`. It launches or raises:
there is no fallback. Its plain version is the generator's stable sort
(`trace.generator.gemm_request_stream`) + `core.dram.decode_requests`,
which it equals bit for bit; `ops.py` picks between the two by device.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ...core.accelerator import DramConfig
from .._build import CudaLibrary

# Kernel launches since the last reset (the sweep and `chip_smoke.py` read
# it to show the main path went through the kernel), in all and by card
# index.
LAUNCHES = 0
LAUNCHES_BY_CARD: collections.Counter = collections.Counter()

# slots a stream the kernel takes: float32 counts them exactly
MAX_CAP = 1 << 24
# floats in a stream's row (`kNP` in the .cu)
ROW = 64
_LAYOUTS = {"row": 0, "col": 1, "tiled": 2, "strided": 3}

_LIB = CudaLibrary("request_streams.cu", "request_streams_launch",
                   [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
# ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG = ""


def build():
    """Compile (once per source version) and load the kernel; returns its
    C launch function."""
    global BUILD_LOG
    fn = _LIB.load()
    BUILD_LOG = _LIB.log
    return fn


def pack_rows(pro) -> torch.Tensor:
    """(streams, 64) float32: each stream's factors in the order of the
    kernel's `Field`s. The tiled layout's tiles a row and the strided
    layout's `_modmul` factors come from the same PyTorch expressions
    the generator evaluates a slot."""
    from ...trace.generator import REGION_SPAN, _const, _modmul_factors
    spec = pro.spec
    n = pro.n_model
    zeros4 = torch.zeros_like(pro.rows_r)
    tpr = (-(-pro.cols_r // spec.tile_c) if spec.layout == "tiled"
           else zeros4)
    if spec.layout == "strided":
        span = _const(REGION_SPAN // pro.word_bytes, n.device)
        xa1, xa64 = _modmul_factors(pro.step * spec.stride_elems, span)
    else:
        xa1 = xa64 = torch.zeros_like(pro.n_tiles)
    cols = [n[..., None], pro.edges[..., :3], pro.starts, pro.q,
            pro.n_tiles - 1.0, pro.tile_cyc, pro.fast_len, pro.slow_len,
            pro.fast_a1, pro.fast_a64, pro.slow_a1, pro.slow_a64,
            pro.rows_r, pro.cols_r, tpr, xa1, xa64]
    cols = [torch.broadcast_to(c, n.shape + c.shape[-1:]) for c in cols]
    # the padding as one more piece: a padding op over the whole rows
    # would run on the host's thread pool, which costs more than it saves
    pad = ROW - sum(c.shape[-1] for c in cols)
    cols.append(torch.zeros(n.shape + (pad,), device=n.device))
    return torch.cat(cols, dim=-1).reshape(-1, ROW)


def launch_streams(pro, dram: DramConfig, device=None):
    """One launch of the kernel on the streams of `pro` (a
    `trace.generator.StreamPrologue` on the host or on the card), on
    `device` (default: `pro`'s, a CUDA device), without the address check:
    ((t, flat_bank, ch, row, is_write, valid), scale, span), `span` the
    two words `check_span` reads. A host prologue's rows and scale reach
    the card in two copies."""
    global LAUNCHES
    from ...trace.generator import REGION_SPAN, fast_is_row_of
    spec = pro.spec
    dev = pro.n_model.device if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the streams kernel runs on a CUDA device, "
                         f"got {dev}")
    cap = spec.cap
    if cap > MAX_CAP:
        raise ValueError(f"trace cap {cap} exceeds the streams kernel's "
                         f"{MAX_CAP} slots a stream")
    shape = tuple(pro.n_model.shape) + (cap,)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    dev = t.device
    fb, ch, row = (torch.empty(shape, dtype=torch.int32, device=dev)
                   for _ in range(3))
    w, v = (torch.empty(shape, dtype=torch.bool, device=dev)
            for _ in range(2))
    span = torch.empty((2,), dtype=torch.int64, device=dev)
    n_streams = pro.n_model.numel()
    if n_streams == 0:                               # nothing to launch
        return (t, fb, ch, row, w, v), pro.scale.to(dev), None
    rows, scale = pack_rows(pro).to(dev), pro.scale.to(dev)
    f32 = np.float32
    tr, tc = f32(spec.tile_r), f32(spec.tile_c)
    fast_row = sum(int(b) << r for r, b in
                   enumerate(fast_is_row_of(pro.dataflow)))
    launch = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            rows.data_ptr(), t.data_ptr(), fb.data_ptr(), ch.data_ptr(),
            row.data_ptr(), w.data_ptr(), v.data_ptr(), span.data_ptr(),
            n_streams, cap, int(pro.dataflow == "os"),
            _LAYOUTS[spec.layout], fast_row, int(pro.word_bytes),
            dram.burst_bytes, dram.channels, dram.banks_per_channel,
            max(1, dram.row_bytes // dram.burst_bytes),
            float(f32(spec.gran_bytes) / f32(pro.word_bytes)),
            float(REGION_SPAN // pro.word_bytes),
            float(tr), float(tc), float(f32(1.0) / tr),
            float(f32(1.0) / tc), float(f32(spec.tile_r * spec.tile_c)),
            stream)
    if err != 0:
        raise RuntimeError(f"streams kernel launch failed: CUDA error {err} "
                           f"(streams={n_streams}, cap={cap})")
    LAUNCHES += 1
    LAUNCHES_BY_CARD[dev.index] += 1
    return (t, fb, ch, row, w, v), scale, span


def check_span(span) -> None:
    """`core.dram.check_addresses` on a launch's least and greatest
    address (stored as (uint64)addr ^ 2^63): one device read."""
    from ...core.dram import check_address_range
    if span is None:
        return
    lo, hi = ((x % (1 << 64)) - (1 << 63) for x in span.tolist())
    check_address_range(lo, hi)


def request_streams(pro, dram: DramConfig, device=None):
    """The streams of `pro` (a `trace.generator.StreamPrologue`) decoded
    and sorted by issue time on `device` (default: `pro`'s, a CUDA
    device), by one kernel launch: ((t, flat_bank, ch, row, is_write,
    valid), scale), each stream tensor of the batch shape + (cap,), bit
    for bit what `gemm_request_stream` + `decode_requests` give; raises
    `check_addresses`' ValueError when an address leaves [0, 2^31)."""
    streams, scale, span = launch_streams(pro, dram, device)
    check_span(span)
    return streams, scale
