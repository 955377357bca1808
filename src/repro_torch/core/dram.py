"""Cycle-accurate main-memory timing model (paper Sec. V); PyTorch port of
`repro.core.dram`.

Address mapping (DDR-style interleave):
  burst index  b   = addr // burst_bytes
  channel          = b % channels
  within-channel r = b // channels
  bank             = (r // (row_bytes // burst_bytes)) % banks
  row              = r // ((row_bytes // burst_bytes) * banks)

Timing per request on its (channel, bank):
  ready = max(issue_ok, bank_free, bus_free[channel])
  row hit -> tCAS; empty row -> tRCD+tCAS; conflict -> tRP+tRCD+tCAS
  done  = ready + lat + busy   (busy = gran_bytes / per-channel bandwidth)

Finite queues: a request cannot issue until the request Q-back *in its
direction* has completed; the backpressure accumulates into a `shift`
that delays every later request (the accelerator stall).

Engines (`core.replay`): the chunked replay megakernel — the CUDA kernel
for CUDA tensors, its plain PyTorch version for CPU tensors — and
`"reference"`, the per-request loop `_reference_scan`, which is the
semantics oracle the tests hold the chunked replay against.

`simulate_dram` runs a raw (issue time, address, is_write) stream:
`check_addresses`, `decode_requests`, then `replay_requests`, one kernel
launch on CUDA tensors. The synthetic stream builders (`linear_trace`,
`strided_trace`, `tile_prefetch_trace`) build on an explicit device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .accelerator import DramConfig
from .replay import resolve_device

_ADDR_LIMIT = 2 ** 31


@dataclasses.dataclass(frozen=True)
class DramResult:
    latency: torch.Tensor         # per-request round-trip (cycles)
    complete: torch.Tensor        # per-request completion time
    stall_cycles: torch.Tensor    # queue backpressure + tail wait
    row_hits: torch.Tensor
    row_misses: torch.Tensor      # empty-row activations
    row_conflicts: torch.Tensor
    total_cycles: torch.Tensor    # end-to-end (incl. compute overlap window)
    bytes_moved: torch.Tensor
    throughput: torch.Tensor      # bytes / cycle over the busy window


def check_addresses(addr: torch.Tensor) -> None:
    """Loud address-space guard: every byte address must sit in [0, 2^31),
    the trace address space of the reference (a negative address is the
    tell-tale of wrapped arithmetic upstream)."""
    if addr.numel() == 0:
        return
    check_address_range(int(addr.min()), int(addr.max()))


def check_address_range(lo: int, hi: int) -> None:
    """`check_addresses` on the least and greatest address of a stream
    batch, found elsewhere (the streams kernel keeps them)."""
    if lo < 0 or hi >= _ADDR_LIMIT:
        raise ValueError(
            f"request addresses span [{lo}, {hi}], outside the trace "
            f"address space [0, 2^31). A negative bound means the address "
            f"arithmetic wrapped upstream; shrink the stream's address "
            f"span (e.g. fewer cores / smaller regions).")


def decode_requests(addr: torch.Tensor, cfg: DramConfig):
    """Byte address -> (flat_bank, channel, row), int32 each, under the
    interleaved channel/bank/row decode (int64 burst math)."""
    check_addresses(addr)
    ch_n, bk_n = cfg.channels, cfg.banks_per_channel
    bursts_per_row = max(1, cfg.row_bytes // cfg.burst_bytes)
    b = addr.to(torch.int64) // cfg.burst_bytes
    ch = b % ch_n
    r = b // ch_n
    bank = (r // bursts_per_row) % bk_n
    row = r // (bursts_per_row * bk_n)
    return ((ch * bk_n + bank).to(torch.int32), ch.to(torch.int32),
            row.to(torch.int32))


def row_buffer_latency(cfg: DramConfig, open_row_val, rw):
    """(latency, hit, empty) of one access against a bank's open row: the
    tCAS / tRCD+tCAS / tRP+tRCD+tCAS selection (int32 latency)."""
    hit = open_row_val == rw
    empty = open_row_val < 0
    lat = torch.where(
        hit, cfg.tCAS,
        torch.where(empty, cfg.tRCD + cfg.tCAS,
                    cfg.tRP + cfg.tRCD + cfg.tCAS)).to(torch.int32)
    return lat, hit, empty


def _finalize(t_issue, valid, done, rt, shift, hits, misses, conflicts,
              cfg: DramConfig, gran_bytes: int, busy: float) -> DramResult:
    """Aggregate per-request completions into a DramResult (leading batch
    dims allowed; aggregates reduce over the last axis only)."""
    ti = t_issue.to(torch.float32)
    last = torch.where(valid, done, 0.0).amax(dim=-1)
    first = torch.where(valid, ti, float("inf")).amin(dim=-1)
    span = torch.clamp_min(last - first, 1.0)
    nominal = cfg.tRCD + cfg.tCAS + busy
    last_issue = torch.where(valid, ti, 0.0).amax(dim=-1)
    tail = torch.clamp_min(last - (last_issue + shift + nominal), 0.0)
    bytes_moved = valid.sum(dim=-1).to(torch.float32) * gran_bytes
    return DramResult(
        latency=rt, complete=done,
        stall_cycles=shift + tail,
        row_hits=hits, row_misses=misses, row_conflicts=conflicts,
        total_cycles=last, bytes_moved=bytes_moved,
        throughput=bytes_moved / span)


def _reference_scan(t_issue, flat_bank, ch, row, is_write, valid,
                    cfg: DramConfig, busy: float):
    """The per-request scan, one request at a time (the semantics oracle;
    tests only). Inputs are (..., n); every leading stream is replayed
    independently, vectorized across the batch."""
    ch_n, bk_n = cfg.channels, cfg.banks_per_channel
    Qr, Qw = cfg.read_queue, cfg.write_queue
    f32, i32 = torch.float32, torch.int32
    batch = t_issue.shape[:-1]
    dev = t_issue.device
    bank_free = torch.zeros(batch + (ch_n * bk_n,), dtype=f32, device=dev)
    open_row = torch.full(batch + (ch_n * bk_n,), -1, dtype=i32, device=dev)
    bus_free = torch.zeros(batch + (ch_n,), dtype=f32, device=dev)
    ring_r = torch.zeros(batch + (Qr,), dtype=f32, device=dev)
    ring_w = torch.zeros(batch + (Qw,), dtype=f32, device=dev)
    ir = torch.zeros(batch + (1,), dtype=torch.int64, device=dev)
    iw = torch.zeros(batch + (1,), dtype=torch.int64, device=dev)
    shift = torch.zeros(batch, dtype=f32, device=dev)
    hits = torch.zeros(batch, dtype=i32, device=dev)
    misses = torch.zeros(batch, dtype=i32, device=dev)
    conflicts = torch.zeros(batch, dtype=i32, device=dev)
    done_all = torch.empty(t_issue.shape, dtype=f32, device=dev)
    rt_all = torch.empty(t_issue.shape, dtype=f32, device=dev)

    def pick(x, k):
        return torch.gather(x, -1, k[..., None].long())[..., 0]

    def put(x, k, val, m):
        upd = x.scatter(-1, k[..., None].long(), val[..., None])
        return torch.where(m[..., None], upd, x)

    ti = t_issue.to(f32)
    for n in range(t_issue.shape[-1]):
        t, fb, c, rw = ti[..., n], flat_bank[..., n], ch[..., n], row[..., n]
        w, v = is_write[..., n], valid[..., n]
        t_eff = t + shift
        head_r = pick(ring_r, ir[..., 0] % Qr)
        head_w = pick(ring_w, iw[..., 0] % Qw)
        issue_ok = torch.maximum(t_eff, torch.where(w, head_w, head_r))
        ready = torch.maximum(issue_ok, pick(bank_free, fb))
        lat, hit, empty = row_buffer_latency(cfg, pick(open_row, fb), rw)
        # RAS/CAS latency pipelines across banks; only the data burst
        # serializes on the channel bus.
        done = torch.maximum(ready + lat, pick(bus_free, c)) + busy
        bank_free = put(bank_free, fb, done, v)
        bus_free = put(bus_free, c, done, v)
        open_row = put(open_row, fb, rw.to(i32), v)
        ring_r = put(ring_r, ir[..., 0] % Qr, done, v & ~w)
        ring_w = put(ring_w, iw[..., 0] % Qw, done, v & w)
        ir = ir + (v & ~w)[..., None].long()
        iw = iw + (v & w)[..., None].long()
        # queue-full backpressure shifts everything downstream
        shift = shift + torch.where(v, torch.clamp_min(issue_ok - t_eff, 0.0),
                                    0.0)
        hits = hits + (hit & v).to(i32)
        misses = misses + (empty & v).to(i32)
        conflicts = conflicts + ((~hit) & (~empty) & v).to(i32)
        done_all[..., n] = torch.where(v, done, t)
        rt_all[..., n] = torch.where(v, done - t, 0.0)
    return done_all, rt_all, shift, hits, misses, conflicts


def replay_requests(t_issue, flat_bank, ch, row, is_write, valid,
                    cfg: DramConfig, gran_bytes: int = 64,
                    engine: Optional[str] = None,
                    chunk: Optional[int] = None) -> DramResult:
    """Run the timing model over pre-decoded request streams of shape
    (..., n): every leading index is one stream, and the whole batch goes
    through one replay (one kernel launch on CUDA tensors)."""
    from . import replay as rp
    engine = rp.resolve_engine(engine)
    if valid is None:
        valid = torch.ones(t_issue.shape, dtype=torch.bool,
                           device=t_issue.device)
    ti = t_issue.to(torch.float32)
    busy = max(1.0, gran_bytes / cfg.bandwidth_bytes_per_cycle)
    if engine == "reference":
        done, rt, shift, hits, misses, conflicts = _reference_scan(
            ti, flat_bank, ch, row, is_write, valid, cfg, busy)
    else:
        out = rp.replay_decoded(ti, flat_bank, ch, row, is_write, valid,
                                cfg, gran_bytes, chunk=chunk)
        done = torch.where(valid, out["done"], ti)
        rt = out["latency"]
        shift = out["shift"][..., 0]
        hits, misses, conflicts = out["hits"], out["misses"], out["conflicts"]
    return _finalize(ti, valid, done, rt, shift, hits, misses, conflicts,
                     cfg, gran_bytes, busy)


def simulate_dram(t_issue: torch.Tensor, addr: torch.Tensor,
                  is_write: torch.Tensor, cfg: DramConfig,
                  gran_bytes: int = 64, valid: torch.Tensor = None,
                  engine: Optional[str] = None,
                  chunk: Optional[int] = None) -> DramResult:
    """Run the timing model over request streams (..., n) sorted by
    t_issue, on the tensors' device.

    gran_bytes: bytes moved per request. valid: optional bool mask;
    invalid entries are no-ops (no state change, zero latency and bytes).
    engine: None or "megakernel" for the chunked replay (one kernel
    launch on CUDA tensors), "reference" for the per-request scan. chunk:
    requests per chunk of the chunked replay (default 64).
    """
    flat_bank, ch, row = decode_requests(addr, cfg)
    return replay_requests(t_issue, flat_bank, ch, row, is_write, valid,
                           cfg, gran_bytes, engine=engine, chunk=chunk)


def linear_trace(n_requests: int, start_addr: int = 0, gran_bytes: int = 64,
                 t0: float = 0.0, issue_gap: float = 1.0,
                 write_every: int = 0, *, device=None
                 ) -> Tuple[torch.Tensor, ...]:
    """Streaming (prefetch-like) trace: consecutive addresses, steady issue.
    (t_issue float32, addr int64, is_write bool) on `device` (CUDA unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    i = torch.arange(n_requests, dtype=torch.int64, device=dev)
    t = t0 + issue_gap * i.to(torch.float32)
    addr = start_addr + i * gran_bytes
    w = ((i % write_every == write_every - 1) if write_every
         else torch.zeros_like(i, dtype=torch.bool))
    return t, addr, w


def strided_trace(n_requests: int, stride_bytes: int, gran_bytes: int = 64,
                  t0: float = 0.0, issue_gap: float = 1.0, *, device=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Row-conflict-heavy trace: large strides thrash row buffers."""
    dev = resolve_device(device)
    i = torch.arange(n_requests, dtype=torch.int64, device=dev)
    t = t0 + issue_gap * i.to(torch.float32)
    return t, i * stride_bytes, torch.zeros_like(i, dtype=torch.bool)


def tile_prefetch_trace(tile_bytes: int, n_tiles: int,
                        compute_per_tile: float, gran_bytes: int = 512,
                        base: int = 0, ofmap_fraction: float = 0.25, *,
                        device=None) -> Tuple[torch.Tensor, ...]:
    """Double-buffered per-fold prefetch: each tile issues
    tile_bytes / gran requests at the start of its overlap window (one
    window per fold of `compute_per_tile` cycles); a trailing
    `ofmap_fraction` of each tile's requests are writes. The whole
    next-tile prefetch is posted at the window start, so small queues
    block the producer at once while large ones absorb the burst (Fig.
    10)."""
    dev = resolve_device(device)
    per = max(1, int(tile_bytes) // gran_bytes)
    i = torch.arange(per * n_tiles, dtype=torch.int64, device=dev)
    t = (i // per).to(torch.float32) * compute_per_tile
    addr = base + i * gran_bytes
    w = (i % per) >= int(per * (1 - ofmap_fraction))
    return t, addr, w
