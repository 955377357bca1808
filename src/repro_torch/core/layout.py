"""On-chip multi-bank data-layout modeling (paper Sec. VI) and the DRAM-side
operand layouts; PyTorch port of `repro.core.layout`.

The multi-bank SRAM is a 2D array: a "line" aggregates the same row index
across banks; each bank offers `ports_per_bank` concurrent line accesses per
cycle. A data layout assigns each tensor element a (line_id, col_id) via
nested-loop dimension orders; bank_id = col_id // bandwidth_per_bank.

Per-cycle slowdown (paper eq.): the bank needing the most distinct lines
relative to its ports sets the cycle's latency:

    slowdown = max_i ceil(distinct_lines(bank_i) / ports(bank_i))

The layout stage computes it with the CUDA bank-conflict kernel on the
card and with its plain PyTorch version on the CPU
(`kernels.conflict.ops.per_cycle_slowdown`); the plain version
(`kernels.conflict.ref`) is the sort-based form of the reference's
`_distinct_slowdown`.
"""
from __future__ import annotations

import dataclasses

import torch

from .accelerator import LayoutConfig


def chw_ids(c, h, w, H: int, W: int, cfg: LayoutConfig,
            word_bytes: int = 2):
    """Paper's (line_id, col_id, bank_id) for a CxHxW tensor layout."""
    c1, h1, w1 = cfg.c1_step, cfg.h1_step, cfg.w1_step
    line = (c // c1) * (-(-H // h1)) * (-(-W // w1)) \
        + (h // h1) * (-(-W // w1)) + (w // w1)
    col = (w % w1) * h1 * c1 + (h % h1) * c1 + (c % c1)
    bpb = max(1, cfg.line_bytes // word_bytes)   # elements per bank line
    bank = (col // bpb) % cfg.num_banks
    return line, col, bank


def flat_ids(flat_index, cfg: LayoutConfig, word_bytes: int = 2):
    """Row-major layout for 2D operand matrices: contiguous elements fill a
    line across banks, then move to the next line. Bank ids of
    non-negative indices lie in [0, num_banks)."""
    bpb = max(1, cfg.line_bytes // word_bytes)
    elems_per_line = bpb * cfg.num_banks
    line = flat_index // elems_per_line
    col = flat_index % elems_per_line
    bank = col // bpb
    return line, col, bank


def slowdown_per_cycle(line: torch.Tensor, bank: torch.Tensor,
                       num_banks: int, ports: int = 1) -> torch.Tensor:
    """(cycles, k) line/bank ids -> per-cycle int32 slowdown (>= 1), on the
    tensors' device (the CUDA kernel or its plain version)."""
    from ..kernels.conflict.ops import per_cycle_slowdown
    return per_cycle_slowdown(line, bank, num_banks=num_banks, ports=ports)


def streaming_access_pattern(R: int, n_cycles: int, lead_stride: int,
                             elem_stride: int = 1, *,
                             device="cuda") -> torch.Tensor:
    """Flat element indices accessed per cycle by a streaming operand port:
    cycle t reads R elements {t*lead_stride + r*elem_stride} (int64), on
    `device` (CUDA unless the caller asks for the CPU)."""
    t = torch.arange(n_cycles, device=device)[:, None]
    r = torch.arange(R, device=device)[None, :]
    return t * lead_stride + r * elem_stride


# Fixed per-op analysis window of the streaming slowdown model: every op is
# analyzed over at most this many cycles.
STREAM_WINDOW_CYCLES = 512


def streaming_ids(cfg: LayoutConfig, R, elem_stride, word_bytes: int = 2, *,
                  r_cap: int, lead_stride: int = 1):
    """The (line, bank) ids the layout stage hands the bank-conflict
    kernel: int32 of shape (len(R), len(elem_stride), STREAM_WINDOW_CYCLES,
    r_cap), one row per (array rows, op stride, cycle). Rows r >= R repeat
    the r = 0 access, which adds no distinct (bank, line) pair."""
    dev = R.device
    t = torch.arange(STREAM_WINDOW_CYCLES, dtype=torch.int64, device=dev)
    r = torch.arange(r_cap, dtype=torch.int64, device=dev)
    # integer index grid: element offsets stay exact past f32's 2^24
    # (large-vocab GEMMs stream with strides in the 100k+ range); the
    # float32 stride is cast to an integer as the reference casts it
    stride = elem_stride.to(torch.float32).to(torch.int32).to(torch.int64)
    idx = (t[None, :, None] * int(lead_stride)
           + r[None, None, :] * stride[:, None, None])     # (S, cycles, r)
    line, _, bank = flat_ids(idx, cfg, word_bytes)
    line, bank = line.to(torch.int32), bank.to(torch.int32)
    rvalid = r[None, None, None, :] < R[:, None, None, None]
    return (torch.where(rvalid, line, line[..., :1]),
            torch.where(rvalid, bank, bank[..., :1]))


def streaming_layout_extra(cfg: LayoutConfig, R, comp, elem_stride,
                           word_bytes: int = 2, *, r_cap: int = None,
                           lead_stride: int = 1):
    """Extra cycles a systolic streaming pattern loses to bank conflicts.

    `R` (array rows), `comp` (compute cycles) and `elem_stride` are float32
    tensors that broadcast together, `elem_stride` lying along the last
    axis (e.g. R (designs, 1), comp (designs, ops), elem_stride (ops,));
    the LayoutConfig, `r_cap` (static bound on R) and the
    `STREAM_WINDOW_CYCLES` window are static. Cycles past
    clip(floor(comp), 8, window) are masked out of the mean.

    The per-cycle slowdowns depend on R and the stride alone, so they are
    computed once per distinct R value and op, in one call of the
    bank-conflict kernel (or its plain version on the CPU), and gathered
    back per design.
    """
    comp = torch.as_tensor(comp, dtype=torch.float32)
    dev = comp.device
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    stride = torch.as_tensor(elem_stride, dtype=torch.float32, device=dev)
    if stride.dim() > 1:
        raise ValueError("elem_stride must be a scalar or one axis (ops,)")
    if r_cap is None:
        r_cap = int(R.max())
    uR, r_inv = torch.unique(R.reshape(-1), return_inverse=True)
    strides = stride.reshape(-1)
    line, bank = streaming_ids(cfg, uR, strides, word_bytes, r_cap=r_cap,
                               lead_stride=lead_stride)
    n_cyc = STREAM_WINDOW_CYCLES
    sd = slowdown_per_cycle(line.reshape(-1, r_cap), bank.reshape(-1, r_cap),
                            cfg.num_banks, cfg.ports_per_bank)
    # prefix sums of the integer slowdowns over the window: (uR, S, 1 + n)
    csum = torch.nn.functional.pad(
        torch.cumsum(sd.reshape(uR.shape[0], strides.shape[0], n_cyc)
                     .to(torch.int64), dim=-1), (1, 0))
    shape = torch.broadcast_shapes(R.shape, comp.shape, stride.shape)
    n_valid = torch.clamp(torch.floor(torch.clamp_max(1.0 * comp, n_cyc)),
                          8, n_cyc)
    ri = torch.broadcast_to(r_inv.reshape(R.shape), shape)
    si = torch.broadcast_to(torch.arange(strides.shape[0], device=dev)
                            .reshape(stride.shape), shape)
    nv = torch.broadcast_to(n_valid, shape)
    total = csum[ri, si, nv.to(torch.int64)]
    mean_sd = total.to(torch.float32) / nv
    return (mean_sd - 1.0) * comp


DRAM_LAYOUTS = ("row", "col", "tiled", "strided")


def operand_linear_index(row, col, rows, cols, order: str = "row",
                         tile_r: int = 32, tile_c: int = 32):
    """DRAM-side storage layout: operand element (row, col) of a
    rows x cols matrix -> linear element offset within its region.

    - 'row':   row-major (C order);
    - 'col':   column-major (Fortran order);
    - 'tiled': tile_r x tile_c blocks laid out row-major, row-major inside
               each block.

    `row`/`col`/`rows`/`cols` are float32 tensors; `order`, `tile_r` and
    `tile_c` are static. ('strided' is synthesized directly from the stream
    position in the generator, not from coordinates.)
    """
    if order == "row":
        return row * cols + col
    if order == "col":
        return col * rows + row
    if order == "tiled":
        tiles_per_row = -(-cols // tile_c)
        tile_id = (row // tile_r) * tiles_per_row + (col // tile_c)
        return (tile_id * (tile_r * tile_c)
                + (row % tile_r) * tile_c + (col % tile_c))
    raise ValueError(f"unknown DRAM layout order {order!r}; "
                     f"known: {DRAM_LAYOUTS}")


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    mean_slowdown: float
    max_slowdown: float
    extra_cycles: float


def evaluate_layout(cfg: LayoutConfig, R: int, n_cycles: int,
                    lead_stride: int, elem_stride: int = 1,
                    word_bytes: int = 2, *, device="cuda") -> LayoutResult:
    """Slowdown of a systolic streaming pattern under a flat layout, on
    `device` (CUDA unless the caller asks for the CPU).

    lead_stride/elem_stride describe how consecutive cycles / array rows map
    to operand addresses (dataflow-dependent): e.g. ws streams a column of X
    per cycle (elem_stride = N, lead_stride = 1 for row-major K x N).
    """
    from ..kernels.conflict.ops import layout_slowdown
    sd = layout_slowdown(cfg, R=R, n_cycles=n_cycles,
                         lead_stride=lead_stride, elem_stride=elem_stride,
                         word_bytes=word_bytes, device=device).to(torch.int64)
    return LayoutResult(mean_slowdown=float(sd.to(torch.float32).mean()),
                        max_slowdown=float(sd.max()),
                        extra_cycles=float((sd - 1).sum()))
