"""Dataflow-aware DRAM demand-trace synthesis; PyTorch port of
`repro.trace.generator`.

The demand request stream (issue cycle, address, is_write) of one GEMM
comes from its mapping: the tile schedule (fold grid and per-tile compute
window), a double-buffered prefetch scheduler, per-dataflow operand walks
and a layout-aware address map. Everything is fixed-shape: a
`TraceSpec.cap`-sized request buffer with a `valid` mask and a real-valued
`scale` (model stall * scale estimates the real stall).

Where the reference vmaps one op's generator over designs and ops, this
port takes any leading batch shape: every scalar input broadcasts against
the others, and the request axis is appended last. The arithmetic runs in
float32 in the reference's exact operation order (`torch.remainder` is
the floored modulo `jnp.mod` is), so the streams come out bit-identical;
the integer address math runs in int64 instead of the reference's int32,
which gives the same values for every address below 2^31 (the range
`core.dram.check_addresses` admits).

`stream_prologue` evaluates what depends only on a stream or a region
once; `stream_slots` the rest, a slot at a time. `gemm_request_stream`
(`sorted_stream` of a prologue) sorts the slots stably by issue time;
on a card the sweep's `api.simulator.decoded_streams` instead ranks them
by the reference's 4-way merge in the streams kernel (`kernels.streams`). `gemm_trace_stats` replays the
generated streams (one replay-kernel launch on CUDA tensors); `trace_op`
and `trace_op_stats` are its entry points for one op of an
`AcceleratorConfig`, on an explicit device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core import dataflow as dfm
from ..core.accelerator import AcceleratorConfig, DramConfig
from ..core.layout import operand_linear_index
from ..core.replay import resolve_device
from ..core.workloads import Op

# One address region per operand (ifmap / filter / ofmap), 32 MiB apart.
REGION_SPAN = 1 << 25
_BIG_T = 1e15          # sort key for invalid (masked) slots
# Compressed streams are sampled in contiguous runs of this many granules
# so layout-driven row-buffer locality survives stream compression.
_SAMPLE_RUN = 64


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Static knobs of the trace generator (hashable).

    cap:          fixed request-buffer size; streams beyond it are folded
                  and the resulting stall rescaled (`scale`).
    gran_bytes:   bytes per demand request (DRAM burst granularity).
    layout:       DRAM-side operand layout — 'row' | 'col' | 'tiled' or
                  'strided' (address = stream position * stride_elems).
    """
    cap: int = 4096
    gran_bytes: int = 64
    layout: str = "row"
    tile_r: int = 32
    tile_c: int = 32
    stride_elems: int = 1

    def __post_init__(self):
        if self.cap < 1:
            raise ValueError(f"trace cap must be >= 1, got {self.cap}")
        if self.gran_bytes < 1:
            raise ValueError(
                f"gran_bytes must be >= 1, got {self.gran_bytes}")
        if self.layout not in ("row", "col", "tiled", "strided"):
            raise ValueError(
                "trace layout must be one of "
                f"('row', 'col', 'tiled', 'strided'), got {self.layout!r}")
        if self.tile_r < 1 or self.tile_c < 1:
            raise ValueError(
                f"trace tile must be >= 1x1, got "
                f"{self.tile_r}x{self.tile_c}")
        if self.stride_elems < 1:
            raise ValueError(
                f"stride_elems must be >= 1, got {self.stride_elems}")


# The one default spec shared by every entry point.
DEFAULT_SPEC = TraceSpec()

R_IFMAP, R_FILTER, R_OFMAP_RD, R_OFMAP_WR = 0, 1, 2, 3

# Per (dataflow, region): does the fast (innermost) walk dim run down the
# operand's rows?  Operand shapes: X = K x N, W = M x K, O = M x N.
_FAST_IS_ROW = {
    ("ws", R_IFMAP): True, ("ws", R_FILTER): False, ("ws", R_OFMAP_WR): True,
    ("is", R_IFMAP): True, ("is", R_FILTER): False, ("is", R_OFMAP_WR): False,
    ("os", R_IFMAP): True, ("os", R_FILTER): False, ("os", R_OFMAP_WR): False,
}


def _const(x, dev) -> torch.Tensor:
    """A float32 0-d tensor of x on `dev`."""
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def fast_is_row_of(dataflow: str):
    """Per region (ifmap, filter, spill read, write-back): does the fast
    walk run down the operand's rows? Spill reads walk like the
    write-back stream."""
    return [_FAST_IS_ROW[(dataflow, R_IFMAP)],
            _FAST_IS_ROW[(dataflow, R_FILTER)],
            _FAST_IS_ROW[(dataflow, R_OFMAP_WR)],
            _FAST_IS_ROW[(dataflow, R_OFMAP_WR)]]


def _modmul(j, a, L):
    """mod(j * a, L) without forming the full product: the exact small
    integer j is split into 6-bit halves so every intermediate stays near
    64 * L, where float32 is exact for dimension-sized L (the reference's
    operation order, kept step for step)."""
    a1, a64 = _modmul_factors(a, L)
    return _modmul_apply(j, a1, a64, L)


def _modmul_factors(a, L):
    """`_modmul`'s factors of the modulus L: (a mod L, 64 (a mod L) mod L),
    one a stream or region."""
    a1 = torch.remainder(a, L)
    a64 = torch.remainder(64.0 * a1, L)
    return a1, a64


def _modmul_apply(j, a1, a64, L):
    """mod(j * a, L) from `_modmul_factors(a, L)`, one a slot."""
    j_hi = torch.floor(j / 64.0)
    j_lo = j - 64.0 * j_hi
    return torch.remainder(j_lo * a1 + j_hi * a64, L)


def _stable_order(key):
    """Permutation that stably sorts `key` along the last axis. The
    reference computes it as a 4-way merge of per-region sorted runs,
    whose contract is exactly a stable argsort."""
    return torch.sort(key, dim=-1, stable=True).indices


@dataclasses.dataclass(frozen=True)
class StreamPrologue:
    """Everything of a batch of streams that depends only on the stream or
    on (stream, region): float32 tensors of the batch shape, or the batch
    shape + (4,) by region (ifmap, filter, spill read, write-back).

    `gemm_request_stream` and the streams kernel (`kernels.streams`) both
    start from it, so the two see the same bits."""
    dataflow: str
    word_bytes: int
    spec: TraceSpec
    n_model: torch.Tensor      # model requests (valid slots) a stream
    scale: torch.Tensor        # compression factor
    edges: torch.Tensor        # (..., 4) running sums of the model
                               # requests by region
    starts: torch.Tensor       # (..., 4) first model request by region
    rows_r: torch.Tensor       # (..., 4) operand rows by region
    cols_r: torch.Tensor       # (..., 4) operand columns by region
    fast_len: torch.Tensor     # (..., 4)
    slow_len: torch.Tensor     # (..., 4)
    step: torch.Tensor         # (..., 1) elements a request
    n_tiles: torch.Tensor      # (..., 1)
    tile_cyc: torch.Tensor     # (..., 1)
    q: torch.Tensor            # (..., 4) model requests a tile by region
    fast_a1: torch.Tensor      # (..., 4) `_modmul` factors of the fast walk
    fast_a64: torch.Tensor
    slow_a1: torch.Tensor      # (..., 4) ... and of the slow walk
    slow_a64: torch.Tensor


def stream_prologue(dataflow: str, M, N, K, R, C, comp,
                    ifmap_elems, filter_elems, ofmap_write_elems,
                    ofmap_read_elems, word_bytes: int = 2,
                    spec: TraceSpec = DEFAULT_SPEC,
                    scale=None) -> StreamPrologue:
    """The per-stream part of `gemm_request_stream` (same arguments): its
    expressions in their order, evaluated once a stream or a region."""
    f32 = torch.float32
    args = torch.broadcast_tensors(M, N, K, R, C, comp, ifmap_elems,
                                   filter_elems, ofmap_write_elems,
                                   ofmap_read_elems)
    (M, N, K, R, C, comp, ifmap_elems, filter_elems, ofmap_write_elems,
     ofmap_read_elems) = (a.to(f32) for a in args)
    dev = M.device
    wb = word_bytes
    cap = spec.cap
    # divisors as device tensors: a CUDA division by a host scalar is a
    # multiplication by its reciprocal, which need not round the same
    # (filled on the device: a copy from the host waits for the card)
    gran = _const(spec.gran_bytes, dev)
    wbt = _const(wb, dev)

    region_bytes = torch.stack([1.0 * ifmap_elems * wb,
                                1.0 * filter_elems * wb,
                                1.0 * ofmap_read_elems * wb,
                                1.0 * ofmap_write_elems * wb], dim=-1)
    # left to right, the order the reference's 4-element sum reduces in
    total_bytes = ((region_bytes[..., 0] + region_bytes[..., 1])
                   + region_bytes[..., 2]) + region_bytes[..., 3]
    n_total = total_bytes / gran                      # fractional requests
    if scale is None:
        n_model = torch.clamp(torch.ceil(n_total), min=1.0, max=float(cap))
        scale = n_total / n_model
    else:
        scale = torch.broadcast_to(
            torch.as_tensor(scale, dtype=f32, device=dev), n_total.shape)
        # n_total / scale, in XLA's form of the chained division
        safe = torch.clamp_min(scale, 1e-9)
        n_model = torch.clamp(torch.ceil(total_bytes / (gran * safe)),
                              min=1.0, max=float(cap))

    # region boundaries in model-request units (sum == n_model when the
    # GEMM picked its own scale)
    # The reference's chained divisions a / b / c are compiled by XLA as
    # a / (b * c); they are written that way here so the rounding agrees.
    safe_scale = torch.clamp_min(scale, 1e-9)
    r_model = region_bytes / (gran * safe_scale[..., None])      # (..., 4)
    # running float32 sums (torch.cumsum accumulates float32 in double on
    # the CPU, which rounds differently)
    e0 = r_model[..., 0]
    e1 = e0 + r_model[..., 1]
    e2 = e1 + r_model[..., 2]
    edges = torch.stack([e0, e1, e2, e2 + r_model[..., 3]], dim=-1)
    starts = torch.stack([torch.zeros_like(e0), e0, e1, e2], dim=-1)

    # ---- operand walk, by region ----------------------------------------
    rows_of, cols_of = (K, M, M, M), (N, K, N, N)     # X:KxN W:MxK O:MxN
    rows_r = torch.stack(rows_of, dim=-1)
    cols_r = torch.stack(cols_of, dim=-1)
    frow = fast_is_row_of(dataflow)
    fast_len = torch.clamp_min(torch.stack(
        [a if f else b for a, b, f in zip(rows_of, cols_of, frow)], -1), 1.0)
    slow_len = torch.clamp_min(torch.stack(
        [b if f else a for a, b, f in zip(rows_of, cols_of, frow)], -1), 1.0)
    step = (safe_scale * gran / wbt)[..., None]       # elements/request
    run = _const(_SAMPLE_RUN, dev)
    fast_a1, fast_a64 = _modmul_factors(step * run, fast_len)
    slow_a1, slow_a64 = _modmul_factors(step * run / fast_len, slow_len)

    # ---- double-buffered prefetch schedule ------------------------------
    Sr, Sc, T = dfm.map_gemm(dataflow, M, N, K)
    fr, fc = dfm.fold_counts(Sr, Sc, R, C)
    n_tiles = torch.clamp_min(1.0 * fr * fc, 1.0)
    tile_cyc = torch.clamp_min(1.0 * comp / (n_tiles * safe_scale), 1.0)
    n_tiles, tile_cyc = n_tiles[..., None], tile_cyc[..., None]
    q = torch.clamp_min(r_model / n_tiles, 1e-9)
    return StreamPrologue(
        dataflow=dataflow, word_bytes=wb, spec=spec, n_model=n_model,
        scale=scale, edges=edges, starts=starts, rows_r=rows_r, cols_r=cols_r,
        fast_len=fast_len, slow_len=slow_len, step=step, n_tiles=n_tiles,
        tile_cyc=tile_cyc, q=q, fast_a1=fast_a1, fast_a64=fast_a64,
        slow_a1=slow_a1, slow_a64=slow_a64)


def stream_slots(pro: StreamPrologue):
    """Every slot of every stream in stream order (before the sort):
    (t_issue float32, addr int64, is_write bool, valid bool, region int64),
    each of the batch shape + (cap,)."""
    f32 = torch.float32
    spec, wb = pro.spec, pro.word_bytes
    dev = pro.n_model.device
    gran = _const(spec.gran_bytes, dev)
    wbt = _const(wb, dev)

    i = torch.arange(spec.cap, dtype=f32, device=dev)
    valid = i < pro.n_model[..., None]
    region = (i[:, None] >= pro.edges[..., None, :]).to(torch.int64).sum(-1)
    region = torch.clamp(region, 0, 3)                           # (..., cap)

    def by_region(x):
        return torch.gather(x, -1, region)

    j = torch.clamp_min(i - by_region(pro.starts), 0.0)

    # ---- operand walk -> coordinates -> layout -> address ---------------
    rows_r = by_region(pro.rows_r)
    cols_r = by_region(pro.cols_r)
    fr_row = torch.tensor(fast_is_row_of(pro.dataflow), device=dev)[region]
    fast_len = by_region(pro.fast_len)
    slow_len = by_region(pro.slow_len)

    # stream element position, sampled in contiguous runs of _SAMPLE_RUN
    # granules (the exact uncompressed walk at scale == 1)
    run = _const(_SAMPLE_RUN, dev)
    j_b = torch.floor(j / run)                        # run id
    j_i = j - run * j_b                               # granule within run
    g_el = gran / wbt                                 # elements/granule
    f = torch.remainder(
        _modmul_apply(j_b, by_region(pro.fast_a1), by_region(pro.fast_a64),
                      fast_len) + j_i * g_el, fast_len)
    lines = (_modmul_apply(j_b, by_region(pro.slow_a1),
                           by_region(pro.slow_a64), slow_len)
             + j_i * g_el / fast_len)
    s = torch.remainder(torch.floor(lines), slow_len)  # refetches wrap
    row = torch.where(fr_row, f, s)
    col = torch.where(fr_row, s, f)

    span = _const(REGION_SPAN // wb, dev)
    if spec.layout == "strided":
        idx = _modmul(j, pro.step * spec.stride_elems, span)
    else:
        idx = operand_linear_index(row, col, rows_r, cols_r,
                                   order=spec.layout,
                                   tile_r=spec.tile_r, tile_c=spec.tile_c)
        idx = torch.remainder(idx, span)
    # exact integer address math from here on; spill reads share the
    # write-back stream's region
    addr_region = torch.clamp_max(region, R_OFMAP_RD)
    addr = (addr_region * REGION_SPAN
            + torch.floor(idx).to(torch.int64) * wb)

    # ---- double-buffered prefetch schedule ------------------------------
    n_tiles, tile_cyc = pro.n_tiles, pro.tile_cyc
    pos = j / by_region(pro.q)
    tau = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0),
                        n_tiles - 1.0)
    frac = torch.clamp(pos - tau, 0.0, 1.0)

    is_write = region == R_OFMAP_WR
    t_read = torch.clamp_min(tau - 1.0, 0.0) * tile_cyc   # prefetch burst
    if pro.dataflow == "os":
        # stationary outputs drain in a burst when the tile retires
        t_write = (tau + 1.0) * tile_cyc
    else:
        # ws/is psum write-backs interleave with the streaming compute
        t_write = (tau + frac) * tile_cyc
    t_spill = (tau + frac) * tile_cyc                 # psum read-backs
    t = torch.where(is_write, t_write,
                    torch.where(region == R_OFMAP_RD, t_spill, t_read))
    return t, addr, is_write, valid, region


def gemm_request_stream(dataflow: str, M, N, K, R, C, comp,
                        ifmap_elems, filter_elems, ofmap_write_elems,
                        ofmap_read_elems, word_bytes: int = 2,
                        spec: TraceSpec = DEFAULT_SPEC, scale=None):
    """Synthesize the demand-request streams of a batch of GEMMs.

    Every numeric argument is a float32 tensor; they broadcast against
    each other to the batch shape (e.g. designs x ops). Returns
    (t_issue, addr, is_write, valid, scale): float32, int64, bool and bool
    tensors of shape batch + (spec.cap,), sorted by issue time along the
    last axis, and the float32 compression factor of shape batch.

    `scale` overrides the compression factor (rounded to float32, as the
    reference's traced scalar is): the multi-core contention path passes
    one common scale so every core's stream is compressed coherently; by
    default each GEMM picks its own.
    """
    return sorted_stream(stream_prologue(
        dataflow, M, N, K, R, C, comp, ifmap_elems, filter_elems,
        ofmap_write_elems, ofmap_read_elems, word_bytes, spec, scale))


def sorted_stream(pro: StreamPrologue):
    """`gemm_request_stream`'s result from its prologue: every slot of
    `stream_slots(pro)` stably sorted by issue time (invalid slots last)."""
    t, addr, is_write, valid, _ = stream_slots(pro)

    # ---- sort by issue time (invalid slots last) ------------------------
    order = _stable_order(torch.where(valid, t, _BIG_T))

    def take(x):
        return torch.gather(x, -1, order)

    # the valid slots, i < n_model, are a prefix before and after the sort
    return take(t), take(addr), take(is_write), valid, pro.scale


def gemm_trace_stats(dataflow: str, M, N, K, R, C, comp,
                     ifmap_elems, filter_elems, ofmap_write_elems,
                     ofmap_read_elems, dram_cfg: DramConfig,
                     word_bytes: int = 2, spec: TraceSpec = DEFAULT_SPEC,
                     engine: Optional[str] = None, *,
                     device=None) -> Dict[str, torch.Tensor]:
    """Generate the GEMMs' streams and run them through the cycle-accurate
    DRAM replay, one replay for the whole batch. Numbers and tensors
    broadcast as in `gemm_request_stream`; every input goes to `device`
    (CUDA unless the caller asks for the CPU) as float32. engine selects
    the replay engine (`core.replay.ENGINES`; None = default)."""
    from ..core.dram import simulate_dram
    dev = resolve_device(device)
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (M, N, K, R, C, comp, ifmap_elems, filter_elems,
                      ofmap_write_elems, ofmap_read_elems)]
    t, addr, w, valid, scale = gemm_request_stream(dataflow, *args,
                                                   word_bytes, spec)
    res = simulate_dram(t, addr, w, dram_cfg, spec.gran_bytes, valid=valid,
                        engine=engine)
    nval = torch.clamp_min(valid.sum(-1).to(torch.float32), 1.0)
    refs = torch.clamp_min(res.row_hits + res.row_misses
                           + res.row_conflicts, 1)
    return dict(
        stall_cycles=res.stall_cycles * scale,
        row_hits=res.row_hits, row_misses=res.row_misses,
        row_conflicts=res.row_conflicts,
        row_hit_rate=res.row_hits / refs,
        mean_latency=res.latency.sum(-1) / nval,
        throughput_Bpc=res.throughput,
        bytes_modeled=res.bytes_moved * scale,
        scaled_by=scale)


# --------------------------------------------------------------------------
# Entry points over an AcceleratorConfig
# --------------------------------------------------------------------------

def _op_regions(cfg: AcceleratorConfig, op: Op, core_index: int = 0):
    """(core, compute cycles, capacity-model DRAM traffic) of one op: the
    cycles exact, the traffic float32 scalars on the CPU, as the
    reference's per-op math gives them."""
    from ..core.stages import host_dram_traffic
    core = cfg.cores[core_index]
    dram = host_dram_traffic(cfg, op, core)
    comp = dfm.compute_cycles(cfg.dataflow, op.M, op.N, op.K,
                              core.rows, core.cols)
    return core, comp, dram


def trace_op(cfg: AcceleratorConfig, op: Op, spec: TraceSpec = DEFAULT_SPEC,
             core_index: int = 0, *, device=None
             ) -> Tuple[torch.Tensor, ...]:
    """(t_issue, addr, is_write, valid, scale) for one op on `cfg`, on
    `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    core, comp, dram = _op_regions(cfg, op, core_index)
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (op.M, op.N, op.K, core.rows, core.cols, comp,
                      dram["dram_ifmap"], dram["dram_filter"],
                      dram["dram_ofmap_writes"], dram["dram_ofmap_reads"])]
    return gemm_request_stream(cfg.dataflow, *args, cfg.memory.word_bytes,
                               spec)


def trace_op_stats(cfg: AcceleratorConfig, op: Op,
                   spec: TraceSpec = DEFAULT_SPEC, core_index: int = 0,
                   engine: Optional[str] = None, *,
                   device=None) -> Dict[str, torch.Tensor]:
    """Row-buffer / stall statistics of one op's generated trace."""
    core, comp, dram = _op_regions(cfg, op, core_index)
    return gemm_trace_stats(
        cfg.dataflow, op.M, op.N, op.K, core.rows, core.cols, comp,
        dram["dram_ifmap"], dram["dram_filter"], dram["dram_ofmap_writes"],
        dram["dram_ofmap_reads"], cfg.dram, cfg.memory.word_bytes, spec,
        engine=engine, device=device)
