"""Shared-DRAM multi-core contention over merged per-core traces; PyTorch
port of `repro.trace.contention`.

Every core's share of a partitioned GEMM becomes its own generated demand
trace (offset in time by its NoP hop latency, offset in address space so
cores occupy disjoint DRAM regions); the traces are merged into one
stream, and a banked-channel replay with per-channel request queues and
per-core backpressure shifts times the whole thing.

Two routing modes:
  - shared (default): every core's bursts interleave over all channels,
    so cores contend for channel buses, banks and queue slots;
  - private_channels: core c's bursts are pinned to channel
    `c % channels` (burst index b -> b * channels + c). With one core per
    channel the merged replay decomposes exactly into the isolated
    per-core runs.

The replay is `core.replay.replay_decoded` with `per_channel_queues=True`
and one core per stream (isolated) or every core in one stream (shared):
the CUDA megakernel for CUDA tensors, its plain PyTorch version for CPU
tensors. `multicore_contention` replays the isolated streams of all cores
as one batch (one kernel launch) and the merged stream as another.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import dataflow as dfm
from ..core import replay as rp
from ..core.accelerator import AcceleratorConfig, DramConfig
from ..core.dram import decode_requests, row_buffer_latency
from .generator import (_BIG_T, DEFAULT_SPEC, REGION_SPAN, TraceSpec,
                        gemm_request_stream)

_CORE_SPAN = 4 * REGION_SPAN      # address space per core (shared routing)


@dataclasses.dataclass(frozen=True)
class SharedDramResult:
    per_core_stall: torch.Tensor    # (..., n_cores)
    per_core_last: torch.Tensor     # (..., n_cores) last completion time
    row_hits: torch.Tensor          # (...)
    row_misses: torch.Tensor
    row_conflicts: torch.Tensor
    total_cycles: torch.Tensor      # (...)


def simulate_shared_dram(t_issue: torch.Tensor, addr: torch.Tensor,
                         is_write: torch.Tensor, core_id: torch.Tensor,
                         valid: torch.Tensor, n_cores: int,
                         cfg: DramConfig, gran_bytes: int = 64,
                         engine: Optional[str] = None,
                         chunk: Optional[int] = None,
                         max_passes: Optional[int] = None,
                         tol: Optional[float] = None) -> SharedDramResult:
    """The DRAM timing model over merged multi-core streams of shape
    (..., n), every leading index one stream, on the tensors' device.

    Unlike the single-stream model, request queues are per channel and
    the backpressure shift is per core (`core_id` in [0, n_cores)): one
    core's queue stalls delay that core's later requests, not its
    neighbours' issue times.

    engine: None or "megakernel" runs the chunked replay (one kernel
    launch for CUDA tensors, the plain version for CPU tensors);
    "reference" the per-request scan. tol: the fixed-point threshold
    (None: `core.replay.DEFAULT_TOL`).
    """
    engine = rp.resolve_engine(engine)
    f32 = torch.float32
    # the reference's busy and nominal are float32 scalars
    busy = torch.tensor(max(1.0, gran_bytes / cfg.bandwidth_bytes_per_cycle),
                        dtype=f32, device=t_issue.device)
    flat_bank, ch, row = decode_requests(addr, cfg)    # checks the range
    ti = t_issue.to(f32)
    v = valid.to(torch.bool)
    w = is_write.to(torch.bool)
    cid = core_id.to(torch.int64)
    if engine == "reference":
        done, shift, hits, misses, conflicts = _reference_shared_scan(
            ti, flat_bank, ch, row, w, v, cid, n_cores, cfg, busy)
    else:
        out = rp.replay_decoded(
            ti, flat_bank, ch, row, w, v, cfg, gran_bytes, chunk=chunk,
            max_passes=max_passes,
            tol=rp.DEFAULT_TOL if tol is None else float(tol),
            n_cores=n_cores, core_id=cid.to(torch.int32),
            per_channel_queues=True)
        done = torch.where(v, out["done"], 0.0)
        shift = out["shift"]
        hits, misses, conflicts = out["hits"], out["misses"], out["conflicts"]

    return shared_dram_result(ti, v, cid, done, shift, hits, misses,
                              conflicts, n_cores, cfg, busy)


def shared_dram_result(t_issue, valid, core_id, done, shift, hits, misses,
                       conflicts, n_cores: int, cfg: DramConfig,
                       busy) -> SharedDramResult:
    """A replay's per-request completions `done` (0 where invalid) and
    per-core `shift` (..., n_cores) -> the per-core stalls: the shift plus
    each core's tail past its last issue and the nominal latency."""
    nominal = (cfg.tRCD + cfg.tCAS) + busy
    cores = torch.arange(n_cores, device=core_id.device)
    onehot = (core_id[..., None, :] == cores[:, None]) & valid[..., None, :]
    last_done = torch.where(onehot, done[..., None, :], 0.0).amax(-1)
    last_issue = torch.where(onehot, t_issue[..., None, :], 0.0).amax(-1)
    tail = torch.clamp_min(last_done - (last_issue + shift + nominal), 0.0)
    return SharedDramResult(
        per_core_stall=shift + tail, per_core_last=last_done,
        row_hits=hits, row_misses=misses, row_conflicts=conflicts,
        total_cycles=torch.where(valid, done, 0.0).amax(-1))


def _reference_shared_scan(t_issue, flat_bank, ch, row, is_write, valid,
                           core_id, n_cores: int, cfg: DramConfig, busy):
    """The per-request shared-stream scan, one request at a time
    (engine="reference"; the semantics oracle), vectorized across the
    leading batch. Returns (done, shift (..., n_cores), hits, misses,
    conflicts)."""
    ch_n, bk_n = cfg.channels, cfg.banks_per_channel
    Qr, Qw = cfg.read_queue, cfg.write_queue
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    batch = t_issue.shape[:-1]
    dev = t_issue.device

    def z(n, dtype=f32, fill=0):
        return torch.full(batch + (n,), fill, dtype=dtype, device=dev)

    bank_free, open_row = z(ch_n * bk_n), z(ch_n * bk_n, i32, -1)
    bus_free = z(ch_n)
    ring_r, ring_w = z(ch_n * Qr), z(ch_n * Qw)      # (channel, slot) flat
    ir, iw = z(ch_n, i64), z(ch_n, i64)
    shift = z(n_cores)
    hits = torch.zeros(batch, dtype=i32, device=dev)
    misses, conflicts = hits.clone(), hits.clone()
    done_all = torch.empty(t_issue.shape, dtype=f32, device=dev)

    def pick(x, k):
        return torch.gather(x, -1, k[..., None])[..., 0]

    def put(x, k, val, m):
        upd = x.scatter(-1, k[..., None], val.to(x.dtype)[..., None])
        return torch.where(m[..., None], upd, x)

    for n in range(t_issue.shape[-1]):
        v = valid[..., n]
        # ids of invalid requests are never used: read index 0 instead
        t, rw, w = t_issue[..., n], row[..., n], is_write[..., n]
        fb = torch.where(v, flat_bank[..., n], 0).to(i64)
        c = torch.where(v, ch[..., n], 0).to(i64)
        k = torch.where(v, core_id[..., n], 0).to(i64)
        t_eff = t + pick(shift, k)
        sl_r = c * Qr + pick(ir, c) % Qr
        sl_w = c * Qw + pick(iw, c) % Qw
        issue_ok = torch.maximum(
            t_eff, torch.where(w, pick(ring_w, sl_w), pick(ring_r, sl_r)))
        ready = torch.maximum(issue_ok, pick(bank_free, fb))
        lat, hit, empty = row_buffer_latency(cfg, pick(open_row, fb), rw)
        done = torch.maximum(ready + lat, pick(bus_free, c)) + busy
        bank_free = put(bank_free, fb, done, v)
        bus_free = put(bus_free, c, done, v)
        open_row = put(open_row, fb, rw, v)
        ring_r = put(ring_r, sl_r, done, v & ~w)
        ring_w = put(ring_w, sl_w, done, v & w)
        ir = put(ir, c, pick(ir, c) + 1, v & ~w)
        iw = put(iw, c, pick(iw, c) + 1, v & w)
        shift = put(shift, k, pick(shift, k)
                    + torch.clamp_min(issue_ok - t_eff, 0.0), v)
        hits = hits + (hit & v).to(i32)
        misses = misses + (empty & v).to(i32)
        conflicts = conflicts + ((~hit) & (~empty) & v).to(i32)
        done_all[..., n] = torch.where(v, done, 0.0)
    return done_all, shift, hits, misses, conflicts


# --------------------------------------------------------------------------
# Per-core sub-problems and the end-to-end contention report
# --------------------------------------------------------------------------

def core_subgemm(dataflow: str, M: int, N: int, K: int, share: int,
                 scheme: str, Pr: int, Pc: int) -> Tuple[int, int, int]:
    """(M, N, K) of the sub-GEMM a core with `share` units of the split
    dimension executes under a partition scheme (mirrors the per-core
    cycle formulas in `simulate_multicore`)."""
    Sr, Sc, T = dfm.map_gemm(dataflow, M, N, K)
    if scheme == "spatial":
        sub = (share, -(-Sc // Pc), T)
    elif scheme == "st1":
        sub = (share, Sc, -(-T // Pc))
    elif scheme == "st2":
        sub = (Sr, share, -(-T // Pr))
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    m, n, k = dfm.unmap_gemm(dataflow, *sub)
    return max(1, int(m)), max(1, int(n)), max(1, int(k))


def _route(addr: torch.Tensor, core, channels: int, burst: int,
           private: bool) -> torch.Tensor:
    """Place core `core`'s local addresses in the shared address space
    (`core` an int, or an int64 tensor broadcasting against `addr`)."""
    if private:
        b = addr // burst
        # cores pinned to the same channel (more cores than channels) get
        # disjoint row regions, so they never alias onto identical rows
        b = b + (core // channels) * (_CORE_SPAN // burst)
        return (b * channels + core % channels) * burst + addr % burst
    return addr + core * _CORE_SPAN


@dataclasses.dataclass(frozen=True)
class ContentionResult:
    """Isolated vs shared-DRAM stalls per core (+ merged row stats)."""
    per_core_stall_isolated: Tuple[float, ...]
    per_core_stall_shared: Tuple[float, ...]
    per_core_compute: Tuple[float, ...]
    scheme: str
    private_channels: bool
    row_hits: int
    row_misses: int
    row_conflicts: int
    makespan_isolated: float          # max over cores: compute + NoP + stall
    makespan_shared: float
    # row stats count the scale-compressed merged stream; multiply by this
    # factor for absolute-scale estimates
    scaled_by: float = 1.0

    @property
    def stall_inflation(self) -> Tuple[float, ...]:
        """Shared / isolated stall per core (1.0 = no contention; inf when
        a core that never stalled alone is delayed by neighbours)."""
        return tuple(s / i if i > 0 else
                     (float("inf") if s > 1e-9 else 1.0)
                     for s, i in zip(self.per_core_stall_shared,
                                     self.per_core_stall_isolated))


def contention_streams(cfg: AcceleratorConfig, M: int, N: int, K: int,
                       scheme: str = "spatial",
                       private_channels: bool = False,
                       spec: Optional[TraceSpec] = None, device="cuda"):
    """The demand streams `multicore_contention` replays, on `device`:
    a dict with `isolated` and `shared`, each (t, addr, is_write, valid,
    core_id) sorted by issue time along the last axis — isolated of shape
    (n_cores, cap) with every core id 0, shared the merged (n_cores * cap,)
    stream with each request's core — and the per-core `compute` cycles,
    NoP `skew` and the `common_scale` the streams are compressed by."""
    from ..core.multicore import simulate_multicore
    from ..noc.stage import noc_arrival_skew
    spec = spec or DEFAULT_SPEC
    mc = simulate_multicore(cfg, M, N, K, scheme)
    df = cfg.dataflow
    wb = cfg.memory.word_bytes
    n_cores = cfg.num_cores
    ch = cfg.dram.channels

    # trace addresses live in [0, 2^31): refuse a core count whose
    # regions would not fit (shared routing spans n_cores regions,
    # private routing ceil(n_cores / channels) * channels)
    groups = (n_cores - 1) // ch + 1
    span_factor = groups * ch if private_channels else n_cores
    if span_factor * _CORE_SPAN > 2 ** 31:
        raise ValueError(
            f"{n_cores} cores over {ch} channels needs "
            f"{span_factor} x {_CORE_SPAN} bytes of shared address space, "
            "which overflows the int32 trace addresses; reduce the core "
            "count (<= 16 cores fit)")

    # per-core sub-GEMMs, traffic and compute windows
    subs, comps, regions = [], [], []
    for idx, core in enumerate(cfg.cores):
        m, n, k = core_subgemm(df, M, N, K, mc.per_core_share[idx],
                               scheme, mc.Pr, mc.Pc)
        subs.append((m, n, k))
        comps.append(float(dfm.compute_cycles(df, m, n, k,
                                              core.rows, core.cols)))
        dram = dfm.dram_traffic(
            df, *(torch.tensor(float(x)) for x in (m, n, k)), core.rows,
            core.cols, cfg.memory)
        regions.append(tuple(float(dram[key]) for key in
                             ("dram_ifmap", "dram_filter",
                              "dram_ofmap_writes", "dram_ofmap_reads")))

    # one common compression factor so every core's stream (and compute
    # window) is squeezed coherently before merging
    n_totals = [sum(r) * wb / spec.gran_bytes for r in regions]
    common_scale = max(1.0, max(n_totals) / spec.cap)
    skew = noc_arrival_skew(
        cfg, [sum(r) * wb for r in regions], max(comps) if comps else 0.0)

    # every core's stream in one batched generator call (the reference
    # generates one core at a time; the arithmetic is elementwise)
    def col(vals):
        return torch.tensor(vals, dtype=torch.float32, device=device)

    t, addr, w, v, _ = gemm_request_stream(
        df, col([s[0] for s in subs]), col([s[1] for s in subs]),
        col([s[2] for s in subs]), col([c.rows for c in cfg.cores]),
        col([c.cols for c in cfg.cores]), col(comps),
        *(col([r[j] for r in regions]) for j in range(4)), wb, spec,
        scale=common_scale)
    # issue times live on the scale-compressed axis, and so must the NoP
    # offset: the quotient is formed in double and added in float32
    off = col([float(skew[i]) / common_scale for i in range(n_cores)])
    t = torch.where(v, t + off[:, None], _BIG_T)
    cores = torch.arange(n_cores, device=device)
    addr = _route(addr, cores[:, None], ch, cfg.dram.burst_bytes,
                  private_channels)
    cid = cores[:, None].expand(n_cores, spec.cap)

    def by_time(*xs):
        order = torch.argsort(torch.where(xs[3], xs[0], _BIG_T), dim=-1,
                              stable=True)
        return tuple(torch.gather(x, -1, order) for x in xs)

    iso = by_time(t, addr, w, v, torch.zeros_like(cid))
    shared = by_time(*(x.reshape(-1) for x in (t, addr, w, v, cid)))
    return dict(isolated=iso, shared=shared, compute=comps,
                skew=[float(s) for s in skew], common_scale=common_scale)


def multicore_contention(cfg: AcceleratorConfig, M: int, N: int, K: int,
                         scheme: str = "spatial",
                         private_channels: bool = False,
                         spec: Optional[TraceSpec] = None,
                         engine: Optional[str] = None,
                         device="cuda") -> ContentionResult:
    """Generate per-core traces for one partitioned GEMM and compare the
    isolated DRAM model against the merged shared-channel model, on
    `device` (CUDA unless the caller asks for the CPU).

    Both numbers come from the same per-channel-queue replay
    (`simulate_shared_dram`), run to the exact fixed point (tol=0.0): the
    isolated-vs-shared comparison, and the exact private-channel
    decomposition, need it. The isolated streams of every core are one
    batch (one replay), the merged stream another.
    """
    spec = spec or DEFAULT_SPEC
    s = contention_streams(cfg, M, N, K, scheme, private_channels, spec,
                           device)
    n_cores, scale = cfg.num_cores, s["common_scale"]
    t, a, w, v, cid = s["isolated"]
    iso = simulate_shared_dram(t, a, w, cid, v, 1, cfg.dram,
                               spec.gran_bytes, engine=engine, tol=0.0)
    t, a, w, v, cid = s["shared"]
    shared = simulate_shared_dram(t, a, w, cid, v, n_cores, cfg.dram,
                                  spec.gran_bytes, engine=engine, tol=0.0)
    iso_stalls = [float(x) * scale
                  for x in iso.per_core_stall[:, 0].tolist()]
    shared_stalls = [float(x) * scale
                     for x in shared.per_core_stall.tolist()]
    comps, nop = s["compute"], s["skew"]
    return ContentionResult(
        per_core_stall_isolated=tuple(iso_stalls),
        per_core_stall_shared=tuple(shared_stalls),
        per_core_compute=tuple(comps),
        scheme=scheme, private_channels=private_channels,
        row_hits=int(shared.row_hits), row_misses=int(shared.row_misses),
        row_conflicts=int(shared.row_conflicts),
        makespan_isolated=max(c + o + x for c, o, x in
                              zip(comps, nop, iso_stalls)),
        makespan_shared=max(c + o + x for c, o, x in
                            zip(comps, nop, shared_stalls)),
        scaled_by=scale)
