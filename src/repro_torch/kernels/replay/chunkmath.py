"""Per-chunk replay math: the plain PyTorch version of the replay kernel.

A port of `repro.kernels.replay.chunkmath`, the chunk step the Pallas
megakernel runs, on tensors with a leading stream axis: inputs are
(S, C), one row per stream. The CUDA kernel
(`csrc/replay_megakernel.cu`) computes the same tables and passes with
one warp per stream, as maxima and sums along each request's links to
its same-bank and same-channel predecessors; this module is what the CPU
tests run and what the kernel is held against on the card.

Semantics (the reference per-request scans, `core.dram._reference_scan`
and, for a merged multi-core stream, `trace.contention`'s
`_reference_shared_scan`):

  head      = ring[group][dir_idx[group] % Q]   (in-flight window, per
                                       direction and queue group: one
                                       group, or one per channel)
  issue_ok  = max(t + shift[core], head)
  ready     = max(issue_ok, bank_free[bank])
  done      = max(ready + lat, bus_free[channel]) + busy
  shift[core] += max(0, issue_ok - (t + shift[core]))
                                    == running max of head - t per core

Within a chunk the serial recurrences are closed per fixed-point pass:
the channel chain as a weighted max-plus prefix (W is the inclusive
prefix of the channel edge weights; the chain closes as
`rowmax(mchan, s - W) + W`), the same-bank chain as a masked row
reduction over the bank-latency prefix V, queue heads and previous
same-bank completions as gathers of the previous iterate. The pass
operator is monotone from below, so its least fixed point is the serial
result.

Masks follow the row = consumer / column = producer convention:
`mask[s, i, j]` is True when request j (column) feeds request i.

Every request carries a core id in [0, n_cores): its issue shift is its
core's, seeded by the carried `shift[core]` and raised by the earlier
requests of the same core. The in-flight rings are per queue group:
`n_qg = 1` (one ring pair per stream, the sweep's case) or
`n_qg = channels` (one per channel, the shared-DRAM contention path). With
`n_cores = n_qg = 1` every table and pass is the single-core replay's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.accelerator import DramConfig
from ...core.dram import row_buffer_latency

_NEG = float("-inf")


def rowmax(mask, x, fill=_NEG):
    """max over the last axis of `x` broadcast against `mask`'s rows."""
    return torch.where(mask, x[..., None, :], fill).amax(dim=-1)


def rowsum(mask, x):
    return torch.where(mask, x[..., None, :], 0).sum(dim=-1)


def _pick(x, idx, fill):
    """x[..., idx] along the last axis; `fill` where idx < 0."""
    got = torch.gather(x, -1, idx.clamp_min(0).long())
    return torch.where(idx >= 0, got, torch.as_tensor(fill, dtype=x.dtype,
                                                      device=x.device))


class ChunkTables(NamedTuple):
    """Order-only per-chunk tables (no carried state involved)."""
    mbank: torch.Tensor      # (S, C, C) same-bank & valid-j & j <= i
    mchan: torch.Tensor      # (S, C, C) same-channel & valid-j & j <= i
    mshift: torch.Tensor     # (S, C, C) same-core & valid-j & j < i
    gprev: torch.Tensor      # (S, C)    pruned prev same-bank index, or -1
    ghead: torch.Tensor      # (S, C)    in-chunk queue-head source, or -1
    intra: torch.Tensor      # (S, C)    has a same-bank predecessor here
    row_prev: torch.Tensor   # (S, C)    its row (-1 where ~intra)
    lat_intra: torch.Tensor  # (S, C)    its row-buffer latency, else 0
    W: torch.Tensor          # (S, C)    inclusive channel weight prefix
    qg: torch.Tensor         # (S, C)    queue group (0 for invalid)
    core: torch.Tensor       # (S, C)    core id (0 for invalid)
    rdx: torch.Tensor        # (S, C)    read index within (chunk, group)
    wdx: torch.Tensor        # (S, C)
    nr: torch.Tensor         # (S, n_qg) reads per group in this chunk
    nw: torch.Tensor         # (S, n_qg)
    surv_r: torch.Tensor     # (S, C)    last writer of its ring slot
    surv_w: torch.Tensor     # (S, C)
    last_b: torch.Tensor     # (S, C)    last valid request of its bank
    last_c: torch.Tensor     # (S, C)    last valid request of its channel


def chunk_tables(fb, ch, row, w, v, cid=None, *, cfg: DramConfig,
                 busy: float, n_cores: int = 1, n_qg: int = 1
                 ) -> ChunkTables:
    """Everything about one chunk that depends only on stream order.
    `cid` (S, C) holds the core ids (None: all core 0); `n_qg` is 1 or
    `cfg.channels` (the queue group is then the channel)."""
    C = fb.shape[-1]
    dev = fb.device
    idx = torch.arange(C, device=dev)
    ii = idx[:, None]                    # row index i (consumer)
    jj = idx[None, :]                    # col index j (producer)
    vj = v[..., None, :]
    low = jj <= ii
    strict = jj < ii
    later = jj > ii

    same_bank = fb[..., None, :] == fb[..., :, None]
    mbank = same_bank & vj & low
    prev = rowmax(same_bank & vj & strict, idx.expand_as(fb), -1)
    intra = prev >= 0
    row_prev = _pick(row, prev, -1)
    lat_intra, _, _ = row_buffer_latency(
        cfg, torch.where(intra, row_prev, -1), row)
    lat_intra = torch.where(intra, lat_intra, 0).to(torch.float32)

    same_ch = ch[..., None, :] == ch[..., :, None]
    mchan = same_ch & vj & low
    # channel max-plus edge: the bus burst, plus the row latency folded
    # in when the previous channel request sits on the same bank
    pin = rowmax(same_ch & vj & strict, idx.expand_as(fb), -1)
    linked = intra & (_pick(fb, pin, -1) == fb)
    we = torch.where(v, busy + torch.where(linked, lat_intra, 0.0), 0.0)
    W = rowsum(mchan, we).to(torch.float32)
    # prune the iterated same-bank gather: links whose channel path
    # already outweighs their latency are provably dominated
    W_prev = _pick(W, prev, 0.0)
    gprev = torch.where(intra & (lat_intra + busy > W - W_prev), prev, -1)

    core = (torch.zeros_like(fb) if cid is None
            else torch.where(v, cid.to(fb.dtype), 0))
    mshift = (core[..., None, :] == core[..., :, None]) & vj & strict

    # queue groups, and per-direction indices within (chunk, group)
    qg = torch.where(v, ch, 0) if n_qg > 1 else torch.zeros_like(fb)
    same_g = qg[..., None, :] == qg[..., :, None]
    rm = v & ~w
    wm = v & w
    rdx = (same_g & rm[..., None, :] & strict).sum(-1).to(torch.int32)
    wdx = (same_g & wm[..., None, :] & strict).sum(-1).to(torch.int32)
    g_oh = qg[..., None, :] == torch.arange(n_qg, device=dev)[:, None]
    nr = (g_oh & rm[..., None, :]).sum(-1).to(torch.int32)
    nw = (g_oh & wm[..., None, :]).sum(-1).to(torch.int32)

    # in-chunk queue-head source: the same-(group, direction) request
    # exactly Q back, when it falls inside this chunk
    Qr, Qw = cfg.read_queue, cfg.write_queue
    if Qr < C or Qw < C:
        eq_r = (rdx[..., None, :] == rdx[..., :, None] - Qr) & \
            rm[..., None, :] & rm[..., :, None] & same_g
        eq_w = (wdx[..., None, :] == wdx[..., :, None] - Qw) & \
            wm[..., None, :] & wm[..., :, None] & same_g
        src = torch.where(w[..., :, None], eq_w, eq_r)
        ghead = rowmax(src, idx.expand_as(fb), -1)
    else:
        ghead = torch.full_like(fb, -1)

    # ring survivors: a request is the last writer of its slot iff it is
    # among the last Q of its (group, direction) in the chunk
    surv_r = rm & (rdx + Qr >= torch.gather(nr, -1, qg.long()))
    surv_w = wm & (wdx + Qw >= torch.gather(nw, -1, qg.long()))

    # the last valid request of each bank / channel writes its state
    last_b = v & ~(same_bank & vj & later).any(-1)
    last_c = v & ~(same_ch & vj & later).any(-1)

    return ChunkTables(
        mbank=mbank, mchan=mchan, mshift=mshift, gprev=gprev, ghead=ghead,
        intra=intra, row_prev=row_prev, lat_intra=lat_intra, W=W, qg=qg,
        core=core, rdx=rdx, wdx=wdx, nr=nr, nw=nw,
        surv_r=surv_r, surv_w=surv_w, last_b=last_b, last_c=last_c)


class ChunkState(NamedTuple):
    """Architectural state carried across chunks (per stream)."""
    bank_free: torch.Tensor   # (S, B)
    open_row: torch.Tensor    # (S, B) int32, -1 = no open row
    bus_free: torch.Tensor    # (S, ch_n)
    ring_r: torch.Tensor      # (S, n_qg, Qr) in-flight read completions
    ring_w: torch.Tensor      # (S, n_qg, Qw)
    ir: torch.Tensor          # (S, n_qg) reads admitted so far
    iw: torch.Tensor          # (S, n_qg)
    shift: torch.Tensor       # (S, n_cores) queue backpressure


def init_state(S: int, *, n_banks: int, ch_n: int, Qr: int, Qw: int,
               device, n_cores: int = 1, n_qg: int = 1) -> ChunkState:
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros((S,) + shape, dtype=dtype, device=device)

    return ChunkState(
        bank_free=z(n_banks),
        open_row=torch.full((S, n_banks), -1, dtype=i32, device=device),
        bus_free=z(ch_n), ring_r=z(n_qg, Qr), ring_w=z(n_qg, Qw),
        ir=z(n_qg, dtype=i32), iw=z(n_qg, dtype=i32), shift=z(n_cores))


def iterate_fixed_point(one_pass, zero, *, cap: int, tol: float):
    """The fixed-point contract of the reference, per stream: two passes
    unconditionally (one if cap == 1); then, while a stream's last pass
    moved any of its completions by more than `tol` and it has run fewer
    than `cap` passes, that stream takes another pass. Returns the final
    iterate and the number of passes each stream took."""
    S = zero.shape[0]
    passes = torch.ones(S, dtype=torch.int32, device=zero.device)
    d1 = one_pass(zero)
    if cap <= 1:
        return d1, passes
    d0, d1 = d1, one_pass(d1)
    passes = passes + 1
    if cap <= 2:
        return d1, passes
    active = (d1 - d0 > tol).any(-1)
    while bool(active.any()):
        dn = one_pass(d1)
        a = active[:, None]
        d0, d1 = torch.where(a, d1, d0), torch.where(a, dn, d1)
        passes = passes + active.to(torch.int32)
        active = active & (d1 - d0 > tol).any(-1) & (passes < cap)
    return d1, passes


def chunk_resolve(state: ChunkState, tab: ChunkTables, t, row, w, v, fb,
                  ch, *, cfg: DramConfig, busy: float,
                  max_passes: Optional[int], tol: float):
    """Classify one chunk against the carried open rows, resolve its
    completion times and advance the state.

    Returns (new_state, done, counts, passes): `done` is 0 where ~valid,
    `counts` the chunk's (S, 3) hit/empty/conflict counts, `passes` the
    fixed-point passes each stream took.
    """
    Qr, Qw = cfg.read_queue, cfg.write_queue
    C = t.shape[-1]
    f32 = torch.float32
    S, n_qg = state.ir.shape

    # carried-state gathers (0 for invalid requests, whose ids are never
    # used as indices)
    def gather0(x, k):
        got = torch.gather(x, -1, torch.where(v, k, 0).long())
        return torch.where(v, got, torch.zeros_like(got))

    # classify: intra-chunk links are order-only; first-per-bank requests
    # consult the carried open-row view
    open_at = gather0(state.open_row, fb)
    seen = torch.where(tab.intra, tab.row_prev, open_at)
    lat, hit, empty = row_buffer_latency(cfg, seen, row)
    counts = torch.stack([(hit & v).sum(-1), (empty & v).sum(-1),
                          ((~hit) & (~empty) & v).sum(-1)], dim=-1)
    lat = lat.to(f32)

    bank0 = gather0(state.bank_free, fb)
    bus0 = gather0(state.bus_free, ch)
    shift0 = gather0(state.shift, tab.core)
    qg = tab.qg.long()
    sl_r = ((tab.rdx + torch.gather(state.ir, -1, qg)) % Qr).long()
    sl_w = ((tab.wdx + torch.gather(state.iw, -1, qg)) % Qw).long()
    at_r, at_w = qg * Qr + sl_r, qg * Qw + sl_w     # (group, slot), flat
    ring_r, ring_w = state.ring_r.reshape(S, -1), state.ring_w.reshape(S, -1)
    head0 = torch.where(w, torch.gather(ring_w, -1, at_w),
                        torch.gather(ring_r, -1, at_r))
    intra_heads = Qr < C or Qw < C
    W = tab.W
    V = rowsum(tab.mbank, torch.where(v, lat + busy, 0.0))

    def heads(done):
        if intra_heads:
            return torch.maximum(head0, _pick(done, tab.ghead, _NEG))
        return head0

    def one_pass(done):
        head = heads(done)
        g = torch.where(v, head - t, _NEG)
        ss = torch.maximum(shift0, rowmax(tab.mshift, g))
        issue_ok = torch.maximum(t + ss, head)
        bankp = torch.maximum(bank0, _pick(done, tab.gprev, _NEG))
        # seed with the previous iterate so bank-raised completions of
        # other banks propagate down the channel chain across passes
        s = torch.maximum(torch.maximum(issue_ok, bankp) + lat + busy, done)
        u = torch.maximum(rowmax(tab.mchan, torch.where(v, s - W, _NEG)) + W,
                          bus0 + W)
        d = rowmax(tab.mbank, torch.where(v, u - V, _NEG)) + V
        return torch.where(v, d, 0.0)

    cap = (C + 2) if max_passes is None else max_passes
    done, passes = iterate_fixed_point(one_pass, torch.zeros_like(t),
                                       cap=cap, tol=tol)

    # final derived state: each core's shift takes the maximum of its
    # requests' head - t (-inf where invalid, so they change nothing)
    g = torch.where(v, heads(done) - t, _NEG)
    shift = state.shift.scatter_reduce(-1, tab.core.long(), g, "amax")

    def put(x, k, val, m):
        """x[k] = val where m (the writers of one slot are unique)."""
        pad = torch.cat([x, x[:, :1]], dim=-1)         # a dump slot
        dst = torch.where(m, k.long(), x.shape[-1])
        return pad.scatter(-1, dst, val.to(x.dtype))[:, :-1]

    bank_free = put(state.bank_free, fb, done, tab.last_b)
    open_row = put(state.open_row, fb, row, tab.last_b)
    bus_free = put(state.bus_free, ch, done, tab.last_c)
    ring_r = put(ring_r, at_r, done, tab.surv_r).reshape(S, n_qg, Qr)
    ring_w = put(ring_w, at_w, done, tab.surv_w).reshape(S, n_qg, Qw)

    new_state = ChunkState(
        bank_free=bank_free, open_row=open_row, bus_free=bus_free,
        ring_r=ring_r, ring_w=ring_w, ir=state.ir + tab.nr,
        iw=state.iw + tab.nw, shift=shift)
    return new_state, done, counts, passes
