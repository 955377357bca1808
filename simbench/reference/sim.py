"""The plain reference of a trace-fidelity design sweep.

A frozen copy, in plain PyTorch, of the semantics the benchmarked sweep
(`Study(...).fidelity("trace").run()`) computes for dense, single-core,
layout-off designs: the stage math (mapping, SRAM and DRAM traffic,
energy), the demand-stream generator, the address decode, and the
chunked DRAM replay in its plain form, with the same float32 operations
in the same order. It imports nothing of the program: the designs and
the op lists come in as plain numbers, and every derived quantity (the
design columns, the streams, the decode, the stalls, the energies) is
worked out again here. It is the yardstick that decides `correct`, so it
is never edited to follow a change of the program.

`reference_frame` returns, per design key, the frame's metric columns.
Its `dtype` is the precision of every floating-point quantity: float32
is the reference; a lower one is the control of the comparison.

What it does differently from the program, none of which changes a
value: one stream per (design, op) instead of one per unique stream
design; streams replayed in buckets by valid length, each cut after
its last valid request (invalid requests are no-ops); the replay
without the program's kernel or its chunk-size and engine options.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# ---- frozen constants ------------------------------------------------------

# The energy reference table, pJ per action (the program's `ERT` defaults).
ERT = dict(mac_random=0.10, mac_wire=0.90, mac_gated=0.006, pe_leak=0.03,
           spad_read=0.03, spad_write=0.045, sram_read_random=3.1,
           sram_read_repeat=1.2, sram_write_random=3.5,
           sram_write_repeat=1.4, sram_idle_kib_cycles=0.0005,
           l2_read=6.0, l2_write=6.8, dram_bytes=8.0, noc_byte_hops=0.35)
ENERGY_GROUPS = {
    "energy_mac_pj": ("mac_random", "mac_wire", "spad_read", "spad_write"),
    "energy_sram_pj": ("sram_read_random", "sram_read_repeat",
                       "sram_write_random", "sram_write_repeat",
                       "sram_idle_kib_cycles", "l2_read", "l2_write"),
    "energy_dram_pj": ("dram_bytes", "noc_byte_hops"),
    "energy_static_pj": ("mac_gated", "pe_leak"),
}
# The frame's metric columns, in the frame's order.
METRIC_COLUMNS = ("total_cycles", "compute_cycles", "stall_cycles",
                  "dram_bytes", "energy_pj", "utilization", "edp",
                  "energy_mac_pj", "energy_sram_pj", "energy_dram_pj",
                  "energy_static_pj")

REGION_SPAN = 1 << 25          # one DRAM region per operand, 32 MiB apart
BIG_T = 1e15                   # sort key of invalid request slots
SAMPLE_RUN = 64                # granules per contiguous sampled run
CHUNK = 64                     # requests per replay chunk
TOL = 0.25                     # fixed-point stopping threshold (cycles)
R_IFMAP, R_FILTER, R_OFMAP_RD, R_OFMAP_WR = 0, 1, 2, 3
FAST_IS_ROW = {
    ("ws", R_IFMAP): True, ("ws", R_FILTER): False, ("ws", R_OFMAP_WR): True,
    ("is", R_IFMAP): True, ("is", R_FILTER): False, ("is", R_OFMAP_WR): False,
    ("os", R_IFMAP): True, ("os", R_FILTER): False, ("os", R_OFMAP_WR): False,
}
# Requests (stream slots) generated at once: bounds the generator's
# intermediates, about 150 bytes a slot at their peak.
GEN_SLOTS = 1 << 25


def tpu_like(array: int, sram_mb: float) -> Dict[str, float]:
    """The `tpu-like` preset's numbers for one core: an array x array
    core with 128 SIMD lanes of latency 1, the SRAM split evenly over the
    three operand buffers, no L2, 2-byte words."""
    sram = int(sram_mb * (1 << 20) / 3)
    return dict(R=array, C=array, lanes=128, lat=1.0, if_b=sram, f_b=sram,
                o_b=sram, l2_b=0, word_bytes=2)


# ---- stage math ------------------------------------------------------------

def cdiv(a, b):
    return -(-a // b)


def map_gemm(dataflow: str, M, N, K):
    return {"is": (K, N, M), "ws": (K, M, N), "os": (M, N, K)}[dataflow]


def compute_cycles(dataflow, M, N, K, R, C):
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    return (2 * R + C + T - 2) * cdiv(Sr, R) * cdiv(Sc, C)


def sram_traffic(dataflow, M, N, K, R, C):
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    fr, fc = cdiv(Sr, R), cdiv(Sc, C)
    WK, XK, O = 1.0 * M * K, 1.0 * K * N, 1.0 * M * N
    if dataflow == "ws":
        return dict(ifmap_reads=fc * XK, filter_reads=WK,
                    ofmap_writes=fr * O, ofmap_reads=(fr - 1) * O)
    if dataflow == "is":
        return dict(ifmap_reads=XK, filter_reads=fc * WK,
                    ofmap_writes=fr * O, ofmap_reads=(fr - 1) * O)
    return dict(ifmap_reads=fr * XK, filter_reads=fc * WK, ofmap_writes=O,
                ofmap_reads=0.0 * O)


def dram_traffic(dataflow, M, N, K, R, C, mem):
    """Capacity-model DRAM traffic (elements): the cheaper of the two loop
    orders over the operand SRAMs, plus psum spills past the ofmap SRAM."""
    wb = mem["word_bytes"]
    WK, XK, O = 1.0 * M * K, 1.0 * K * N, 1.0 * M * N

    def cap(nbytes):
        return torch.clamp_min(nbytes / wb, 1.0)

    cap_if, cap_f, cap_o = cap(mem["if_b"]), cap(mem["f_b"]), cap(mem["o_b"])
    n_t = torch.minimum(torch.clamp_min(cap_if // torch.clamp_min(K, 1), 1),
                        N)
    total_a = XK + WK * cdiv(N, n_t)
    m_t = torch.minimum(torch.clamp_min(cap_f // torch.clamp_min(K, 1), 1),
                        M)
    total_b = WK + XK * cdiv(M, m_t)
    a_better = total_a <= total_b
    dram_x = torch.where(a_better, XK, XK * cdiv(M, m_t))
    dram_w = torch.where(a_better, WK * cdiv(N, n_t), WK)
    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    fr = cdiv(Sr, R)
    spill = 1.0 * C * T > cap_o
    if dataflow == "os":
        spill = torch.zeros_like(spill)
    spills = torch.where(spill, (fr - 1) * O, 0.0 * O)
    return dict(dram_ifmap=dram_x, dram_filter=dram_w,
                dram_ofmap_writes=O + spills, dram_ofmap_reads=spills)


def action_energy(*, pes, dim32, sram_kib, cycles, macs, ifmap_reads,
                  filter_reads, ofmap_writes, ofmap_reads, dram_bytes,
                  l2_reads=0.0) -> Dict[str, object]:
    """Action counts times the ERT, per action, plus their "total"."""
    util = torch.clamp(macs / torch.clamp_min(pes * cycles, 1.0), 0.0, 1.0)
    rf = 1.0 - 1.0 / 32          # 64-byte rows of 2-byte words
    sram_reads = ifmap_reads + filter_reads + ofmap_reads
    counts = dict(
        mac_random=pes * cycles * util,
        mac_wire=pes * cycles * util * dim32,
        mac_gated=pes * cycles * (1.0 - util),
        pe_leak=pes * cycles,
        spad_read=3.0 * macs,
        spad_write=ifmap_reads + filter_reads + macs,
        sram_read_random=sram_reads * (1 - rf),
        sram_read_repeat=sram_reads * rf,
        sram_write_random=ofmap_writes * (1 - rf),
        sram_write_repeat=ofmap_writes * rf,
        sram_idle_kib_cycles=cycles * sram_kib,
        l2_read=l2_reads, l2_write=0.0, dram_bytes=dram_bytes,
        noc_byte_hops=0.0)
    out = {k: v * ERT[k] for k, v in counts.items()}
    out["total"] = sum(out.values())
    return out


# ---- demand streams and decode ---------------------------------------------

def _modmul(j, a, L):
    """mod(j * a, L), j split into 6-bit halves (exact for small L)."""
    j_hi = torch.floor(j / 64.0)
    j_lo = j - 64.0 * j_hi
    a1 = torch.remainder(a, L)
    a64 = torch.remainder(64.0 * a1, L)
    return torch.remainder(j_lo * a1 + j_hi * a64, L)


def request_stream(dataflow, M, N, K, R, C, comp, ifmap_elems, filter_elems,
                   ofmap_write_elems, ofmap_read_elems, *, word_bytes: int,
                   cap: int, gran_bytes: int, dtype):
    """The demand streams of a batch of GEMMs in row-major operand layout:
    (t, addr, is_write, valid, scale), sorted by issue time, invalid
    slots last."""
    f = dtype
    args = torch.broadcast_tensors(M, N, K, R, C, comp, ifmap_elems,
                                   filter_elems, ofmap_write_elems,
                                   ofmap_read_elems)
    (M, N, K, R, C, comp, ifmap_elems, filter_elems, ofmap_write_elems,
     ofmap_read_elems) = (a.to(f) for a in args)
    dev = M.device
    wb = word_bytes
    gran = torch.tensor(float(gran_bytes), dtype=f, device=dev)
    wbt = torch.tensor(float(wb), dtype=f, device=dev)
    region_bytes = torch.stack([1.0 * ifmap_elems * wb,
                                1.0 * filter_elems * wb,
                                1.0 * ofmap_read_elems * wb,
                                1.0 * ofmap_write_elems * wb], dim=-1)
    total_bytes = ((region_bytes[..., 0] + region_bytes[..., 1])
                   + region_bytes[..., 2]) + region_bytes[..., 3]
    n_total = total_bytes / gran
    n_model = torch.clamp(torch.ceil(n_total), min=1.0, max=float(cap))
    scale = n_total / n_model
    safe_scale = torch.clamp_min(scale, 1e-9)
    r_model = region_bytes / (gran * safe_scale[..., None])
    e0 = r_model[..., 0]
    e1 = e0 + r_model[..., 1]
    e2 = e1 + r_model[..., 2]
    edges = torch.stack([e0, e1, e2, e2 + r_model[..., 3]], dim=-1)
    starts = torch.stack([torch.zeros_like(e0), e0, e1, e2], dim=-1)

    i = torch.arange(cap, dtype=f, device=dev)
    valid = i < n_model[..., None]
    region = (i[:, None] >= edges[..., None, :]).to(torch.int64).sum(-1)
    region = torch.clamp(region, 0, 3)
    j = torch.clamp_min(i - torch.gather(starts, -1, region), 0.0)

    rows_of = torch.stack([K, M, M, M], dim=-1)
    cols_of = torch.stack([N, K, N, N], dim=-1)
    fast_is_row = torch.tensor(
        [FAST_IS_ROW[(dataflow, R_IFMAP)], FAST_IS_ROW[(dataflow, R_FILTER)],
         FAST_IS_ROW[(dataflow, R_OFMAP_WR)],
         FAST_IS_ROW[(dataflow, R_OFMAP_WR)]], device=dev)
    rows_r = torch.gather(rows_of, -1, region)
    cols_r = torch.gather(cols_of, -1, region)
    fr_row = fast_is_row[region]
    fast_len = torch.clamp_min(torch.where(fr_row, rows_r, cols_r), 1.0)
    slow_len = torch.clamp_min(torch.where(fr_row, cols_r, rows_r), 1.0)

    step = (safe_scale * gran / wbt)[..., None]
    run = torch.tensor(float(SAMPLE_RUN), dtype=f, device=dev)
    j_b = torch.floor(j / run)
    j_i = j - run * j_b
    g_el = gran / wbt
    fpos = torch.remainder(_modmul(j_b, step * run, fast_len) + j_i * g_el,
                           fast_len)
    lines = (_modmul(j_b, step * run / fast_len, slow_len)
             + j_i * g_el / fast_len)
    s = torch.remainder(torch.floor(lines), slow_len)
    row = torch.where(fr_row, fpos, s)
    col = torch.where(fr_row, s, fpos)
    span = torch.tensor(float(REGION_SPAN // wb), dtype=f, device=dev)
    idx = torch.remainder(row * cols_r + col, span)
    addr_region = torch.clamp_max(region, R_OFMAP_RD)
    addr = (addr_region * REGION_SPAN
            + torch.floor(idx).to(torch.int64) * wb)

    Sr, Sc, T = map_gemm(dataflow, M, N, K)
    n_tiles = torch.clamp_min(1.0 * cdiv(Sr, R) * cdiv(Sc, C), 1.0)
    tile_cyc = torch.clamp_min(1.0 * comp / (n_tiles * safe_scale), 1.0)
    n_tiles, tile_cyc = n_tiles[..., None], tile_cyc[..., None]
    q = torch.clamp_min(torch.gather(r_model, -1, region) / n_tiles, 1e-9)
    pos = j / q
    tau = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0),
                        n_tiles - 1.0)
    frac = torch.clamp(pos - tau, 0.0, 1.0)
    is_write = region == R_OFMAP_WR
    t_read = torch.clamp_min(tau - 1.0, 0.0) * tile_cyc
    if dataflow == "os":
        t_write = (tau + 1.0) * tile_cyc
    else:
        t_write = (tau + frac) * tile_cyc
    t_spill = (tau + frac) * tile_cyc
    t = torch.where(is_write, t_write,
                    torch.where(region == R_OFMAP_RD, t_spill, t_read))
    order = torch.sort(torch.where(valid, t, BIG_T), dim=-1,
                       stable=True).indices

    def take(x):
        return torch.gather(x, -1, order)

    return take(t), take(addr), take(is_write), take(valid), scale


def decode(addr, dram):
    """Byte address -> (flat bank, channel, row) under the interleaved
    channel / bank / row map."""
    ch_n, bk_n = dram["channels"], dram["banks_per_channel"]
    bursts_per_row = max(1, dram["row_bytes"] // dram["burst_bytes"])
    b = addr.to(torch.int64) // dram["burst_bytes"]
    ch = b % ch_n
    r = b // ch_n
    bank = (r // bursts_per_row) % bk_n
    row = r // (bursts_per_row * bk_n)
    return ((ch * bk_n + bank).to(torch.int32), ch.to(torch.int32),
            row.to(torch.int32))


# ---- the chunked DRAM replay, plain ----------------------------------------

def _row_latency(dram, open_row, rw):
    """tCAS on a row hit, tRCD + tCAS on an empty bank, tRP + tRCD +
    tCAS on a conflict."""
    return torch.where(open_row == rw, dram["tCAS"],
                       torch.where(open_row < 0, dram["tRCD"] + dram["tCAS"],
                                   dram["tRP"] + dram["tRCD"] + dram["tCAS"])
                       ).to(torch.int32)


def _rowmax(mask, x, fill=float("-inf")):
    return torch.where(mask, x[..., None, :], fill).amax(dim=-1)


def _rowsum(mask, x):
    return torch.where(mask, x[..., None, :], 0).sum(dim=-1)


def _pick(x, idx, fill):
    got = torch.gather(x, -1, idx.clamp_min(0).long())
    return torch.where(idx >= 0, got, torch.as_tensor(fill, dtype=x.dtype,
                                                      device=x.device))


def _chunk(state, t, fb, ch, row, w, v, *, dram, busy, dtype):
    """One chunk of C requests of S streams (one core, one queue pair):
    the order-only tables, the fixed point of the completion times, the
    carried state. Returns (state, done)."""
    NEG = float("-inf")
    C = fb.shape[-1]
    dev = fb.device
    S = fb.shape[0]
    idx = torch.arange(C, device=dev)
    ii, jj = idx[:, None], idx[None, :]
    vj = v[..., None, :]
    low, strict, later = jj <= ii, jj < ii, jj > ii
    Qr, Qw = dram["read_queue"], dram["write_queue"]

    same_bank = fb[..., None, :] == fb[..., :, None]
    mbank = same_bank & vj & low
    prev = _rowmax(same_bank & vj & strict, idx.expand_as(fb), -1)
    intra = prev >= 0
    row_prev = _pick(row, prev, -1)
    lat_intra = _row_latency(dram, torch.where(intra, row_prev, -1), row)
    lat_intra = torch.where(intra, lat_intra, 0).to(dtype)
    same_ch = ch[..., None, :] == ch[..., :, None]
    mchan = same_ch & vj & low
    pin = _rowmax(same_ch & vj & strict, idx.expand_as(fb), -1)
    linked = intra & (_pick(fb, pin, -1) == fb)
    we = torch.where(v, busy + torch.where(linked, lat_intra, 0.0), 0.0)
    W = _rowsum(mchan, we).to(dtype)
    W_prev = _pick(W, prev, 0.0)
    gprev = torch.where(intra & (lat_intra + busy > W - W_prev), prev, -1)
    mshift = vj & strict
    rm, wm = v & ~w, v & w
    rdx = (rm[..., None, :] & strict).sum(-1).to(torch.int32)
    wdx = (wm[..., None, :] & strict).sum(-1).to(torch.int32)
    nr = rm.sum(-1, keepdim=True).to(torch.int32)
    nw = wm.sum(-1, keepdim=True).to(torch.int32)
    if Qr < C or Qw < C:
        eq_r = ((rdx[..., None, :] == rdx[..., :, None] - Qr)
                & rm[..., None, :] & rm[..., :, None])
        eq_w = ((wdx[..., None, :] == wdx[..., :, None] - Qw)
                & wm[..., None, :] & wm[..., :, None])
        ghead = _rowmax(torch.where(w[..., :, None], eq_w, eq_r),
                        idx.expand_as(fb), -1)
    else:
        ghead = torch.full_like(fb, -1)
    surv_r = rm & (rdx + Qr >= nr)
    surv_w = wm & (wdx + Qw >= nw)
    last_b = v & ~(same_bank & vj & later).any(-1)
    last_c = v & ~(same_ch & vj & later).any(-1)

    def gather0(x, k):
        got = torch.gather(x, -1, torch.where(v, k, 0).long())
        return torch.where(v, got, torch.zeros_like(got))

    bank_free, open_row, bus_free, ring_r, ring_w, ir, iw, shift = state
    open_at = gather0(open_row, fb)
    seen = torch.where(intra, row_prev, open_at)
    lat = _row_latency(dram, seen, row).to(dtype)
    bank0 = gather0(bank_free, fb)
    bus0 = gather0(bus_free, ch)
    shift0 = torch.where(v, shift, torch.zeros_like(shift))
    sl_r = ((rdx + ir) % Qr).long()
    sl_w = ((wdx + iw) % Qw).long()
    head0 = torch.where(w, torch.gather(ring_w, -1, sl_w),
                        torch.gather(ring_r, -1, sl_r))
    intra_heads = Qr < C or Qw < C
    V = _rowsum(mbank, torch.where(v, lat + busy, 0.0))

    def heads(done):
        if intra_heads:
            return torch.maximum(head0, _pick(done, ghead, NEG))
        return head0

    def one_pass(done):
        head = heads(done)
        g = torch.where(v, head - t, NEG)
        ss = torch.maximum(shift0, _rowmax(mshift, g))
        issue_ok = torch.maximum(t + ss, head)
        bankp = torch.maximum(bank0, _pick(done, gprev, NEG))
        s = torch.maximum(torch.maximum(issue_ok, bankp) + lat + busy, done)
        u = torch.maximum(_rowmax(mchan, torch.where(v, s - W, NEG)) + W,
                          bus0 + W)
        d = _rowmax(mbank, torch.where(v, u - V, NEG)) + V
        return torch.where(v, d, 0.0)

    # two passes, then more while a stream's completions move by more
    # than TOL, at most C + 2 in all
    zero = torch.zeros_like(t)
    passes = torch.ones(S, dtype=torch.int32, device=dev)
    d0, d1 = one_pass(zero), None
    d1 = one_pass(d0)
    passes = passes + 1
    active = (d1 - d0 > TOL).any(-1)
    while bool(active.any()):
        dn = one_pass(d1)
        a = active[:, None]
        d0, d1 = torch.where(a, d1, d0), torch.where(a, dn, d1)
        passes = passes + active.to(torch.int32)
        active = active & (d1 - d0 > TOL).any(-1) & (passes < C + 2)
    done = d1

    g = torch.where(v, heads(done) - t, NEG)
    shift = torch.maximum(shift, g.amax(-1, keepdim=True))

    def put(x, k, val, m):
        pad = torch.cat([x, x[:, :1]], dim=-1)
        dst = torch.where(m, k.long(), x.shape[-1])
        return pad.scatter(-1, dst, val.to(x.dtype))[:, :-1]

    state = (put(bank_free, fb, done, last_b), put(open_row, fb, row, last_b),
             put(bus_free, ch, done, last_c), put(ring_r, sl_r, done, surv_r),
             put(ring_w, sl_w, done, surv_w), ir + nr, iw + nw, shift)
    return state, done


def replay_stall(t, fb, ch, row, w, v, *, dram, gran_bytes: int, dtype):
    """Per stream (S, n): the accelerator stall of the DRAM replay, queue
    backpressure plus the tail wait. The streams' valid requests come
    first."""
    S, n = t.shape
    dev = t.device
    busy = max(1.0, gran_bytes / dram["bandwidth_bytes_per_cycle"])
    nb = dram["channels"] * dram["banks_per_channel"]
    i32 = torch.int32
    state = (torch.zeros((S, nb), dtype=dtype, device=dev),
             torch.full((S, nb), -1, dtype=i32, device=dev),
             torch.zeros((S, dram["channels"]), dtype=dtype, device=dev),
             torch.zeros((S, dram["read_queue"]), dtype=dtype, device=dev),
             torch.zeros((S, dram["write_queue"]), dtype=dtype, device=dev),
             torch.zeros((S, 1), dtype=i32, device=dev),
             torch.zeros((S, 1), dtype=i32, device=dev),
             torch.zeros((S, 1), dtype=dtype, device=dev))
    done = torch.zeros_like(t)
    for k in range(0, n, CHUNK):
        sl = slice(k, k + CHUNK)
        state, done[:, sl] = _chunk(state, t[:, sl], fb[:, sl], ch[:, sl],
                                       row[:, sl], w[:, sl], v[:, sl],
                                       dram=dram, busy=busy, dtype=dtype)
    shift = state[-1][:, 0]
    done = torch.where(v, done, t)
    last = torch.where(v, done, 0.0).amax(-1)
    last_issue = torch.where(v, t, 0.0).amax(-1)
    nominal = dram["tRCD"] + dram["tCAS"] + busy
    tail = torch.clamp_min(last - (last_issue + shift + nominal), 0.0)
    return shift + tail


def replay_buckets(t, fb, ch, row, w, v, *, dram, gran_bytes: int, dtype):
    """`replay_stall` of many streams, in buckets by valid length: up to a
    sixteenth, up to a quarter, and the rest of the longest stream's. Each
    bucket is cut after its longest stream's last valid request, rounded
    up to a whole chunk, so chunk boundaries fall where the program's do;
    the chunk steps, each a few hundred small launches, are what the
    replay's time goes by."""
    nval = v.sum(-1)
    top = int(nval.max())
    edges = [0, top // 16, top // 4, top]
    S = t.shape[0]
    stall = torch.zeros(S, dtype=dtype, device=t.device)
    for lo, hi in zip(edges[:-1], edges[1:]):
        part = torch.nonzero((nval > lo) & (nval <= hi)).reshape(-1)
        if part.numel() == 0:
            continue
        n = max(CHUNK, -(-int(nval[part].max()) // CHUNK) * CHUNK)
        sel = [x[part, :n] for x in (t, fb, ch, row, w, v)]
        stall[part] = replay_stall(*sel, dram=dram,
                                                 gran_bytes=gran_bytes,
                                                 dtype=dtype)
    return stall


# ---- the sweep -------------------------------------------------------------

def design_columns(designs, dtype, device):
    """Design columns (n, 1) of the `tpu-like` designs of one dataflow."""
    cols = [tpu_like(d["array"], d["sram_mb"]) for d in designs]
    return {k: torch.tensor(np.asarray([c[k] for c in cols], np.float32),
                            device=device).to(dtype)[:, None]
            for k in ("R", "C", "lanes", "lat", "if_b", "f_b", "o_b",
                      "l2_b")}


def op_arrays(ops, dtype, device):
    gemms = [o for o in ops if o["kind"] == "gemm"]
    vecs = [o for o in ops if o["kind"] == "vector"]

    def col(vals):
        return torch.tensor(np.asarray(vals, np.float32).reshape(-1),
                            device=device).to(dtype)

    return dict(M=col([o["M"] for o in gemms]), N=col([o["N"] for o in gemms]),
                K=col([o["K"] for o in gemms]),
                cnt=col([o["count"] for o in gemms]),
                velems=col([o["vector_elems"] for o in vecs]),
                vcnt=col([o["count"] for o in vecs]))


def streams(dataflow, d, g, *, spec, dram, dtype):
    """The decoded demand streams of every (design, gemm op) of one
    dataflow, generated a block of designs at a time: six (designs x ops,
    cap) tensors (t, flat bank, channel, row, is_write, valid) and the
    (designs x ops,) compression scale."""
    M, N, K = g["M"], g["N"], g["K"]
    wb = 2
    n_d, n_g = d["R"].shape[0], M.shape[0]
    cap = int(spec["cap"])
    per = max(1, GEN_SLOTS // max(1, n_g * cap))
    parts: List[Tuple[torch.Tensor, ...]] = []
    scales = []
    for lo in range(0, n_d, per):
        sl = slice(lo, lo + per)
        R, C = d["R"][sl], d["C"][sl]
        mem = dict(if_b=d["if_b"][sl], f_b=d["f_b"][sl], o_b=d["o_b"][sl],
                   word_bytes=wb)
        comp = compute_cycles(dataflow, M, N, K, R, C)
        dr = dram_traffic(dataflow, M, N, K, R, C, mem)
        t, addr, w, v, scale = request_stream(
            dataflow, M, N, K, R, C, comp, dr["dram_ifmap"],
            dr["dram_filter"], dr["dram_ofmap_writes"],
            dr["dram_ofmap_reads"], word_bytes=wb, cap=cap,
            gran_bytes=int(spec["gran_bytes"]), dtype=dtype)
        fb, ch, row = decode(addr, dram)
        del addr
        parts.append(tuple(x.reshape(-1, cap) for x in (t, fb, ch, row, w, v)))
        scales.append(scale.reshape(-1))
    return ([torch.cat([p[i] for p in parts]) for i in range(6)],
            torch.cat(scales))


def design_metrics(dataflow, d, g, trace_stall) -> Dict[str, torch.Tensor]:
    """Per-design totals over the workload (the frame's columns but
    `edp`), from the design columns, the op arrays and the trace stall."""
    n_designs = d["R"].shape[0]
    M, N, K, cnt = g["M"], g["N"], g["K"], g["cnt"]
    velems, vcnt = g["velems"], g["vcnt"]
    R, C = d["R"], d["C"]
    wb = 2
    mem = dict(if_b=d["if_b"], f_b=d["f_b"], o_b=d["o_b"], word_bytes=wb)

    def total(x):
        if not isinstance(x, torch.Tensor):
            return torch.zeros(n_designs, device=R.device, dtype=R.dtype) + x
        return torch.broadcast_to(x, (n_designs, x.shape[-1])).sum(-1)

    comp = compute_cycles(dataflow, M, N, K, R, C)
    sram = sram_traffic(dataflow, M, N, K, R, C)
    dr = dram_traffic(dataflow, M, N, K, R, C, mem)
    dram_elems = (dr["dram_ifmap"] + dr["dram_filter"]
                  + dr["dram_ofmap_writes"] + dr["dram_ofmap_reads"])
    comp_t = comp * cnt
    stall_t = trace_stall * cnt
    dram_t = dram_elems * wb * cnt
    macs = M * N * K * cnt
    pes = R * C
    dim32 = torch.maximum(R, C) / 32.0
    sram_kib = (d["if_b"] + d["f_b"] + d["o_b"]) / 1024.0
    e = action_energy(
        pes=pes, dim32=dim32, sram_kib=sram_kib, cycles=comp_t, macs=macs,
        ifmap_reads=sram["ifmap_reads"] * cnt,
        filter_reads=sram["filter_reads"] * cnt,
        ofmap_writes=sram["ofmap_writes"] * cnt,
        ofmap_reads=sram["ofmap_reads"] * cnt, dram_bytes=dram_t,
        l2_reads=torch.where(d["l2_b"] > 0, dram_elems * cnt, 0.0))
    vcyc = cdiv(velems, d["lanes"]) * d["lat"] * vcnt
    vdram = velems * wb * vcnt
    vel_t = velems * vcnt
    zeros_v = torch.zeros_like(vcyc)
    ve = action_energy(
        pes=pes, dim32=dim32, sram_kib=sram_kib, cycles=vcyc, macs=zeros_v,
        ifmap_reads=vel_t, filter_reads=zeros_v, ofmap_writes=vel_t,
        ofmap_reads=zeros_v, dram_bytes=vdram)
    energy = total(e["total"]) + total(ve["total"])
    groups = {grp: sum(total(e[a]) + total(ve[a]) for a in acts)
              for grp, acts in ENERGY_GROUPS.items()}
    comp_s = total(comp_t) + total(vcyc)
    stall_s = total(stall_t)
    cycles = comp_s + stall_s
    util = torch.clamp_max(total(macs) / torch.clamp_min(pes[:, 0] * cycles,
                                                         1.0), 1.0)
    return dict(total_cycles=cycles, compute_cycles=comp_s,
                stall_cycles=stall_s, dram_bytes=total(dram_t) + total(vdram),
                energy_pj=energy, utilization=util, **groups)


def design_key(d) -> Tuple[int, float, str]:
    return (int(d["array"]), float(d["sram_mb"]), str(d["dataflow"]))


def reference_frame(designs: Sequence[dict], ops: Sequence[dict], *,
                    spec: dict, dram: dict, device, dtype=torch.float32
                    ) -> Dict[Tuple, Dict[str, float]]:
    """{design key: {metric column: value}} of a trace-fidelity sweep of
    `ops` over the distinct `designs` (dicts with array, sram_mb and
    dataflow), computed in `dtype` on `device`. The streams of every
    dataflow go through one bucketed replay."""
    uniq = {design_key(d): d for d in designs}
    groups = {}
    for df in ("ws", "os", "is"):
        group = [d for k, d in uniq.items() if k[2] == df]
        if group:
            groups[df] = (group, design_columns(group, dtype, device))
    g = op_arrays(ops, dtype, device)
    n_g = g["M"].shape[0]
    parts, scales = [], []
    for df, (group, d) in groups.items():
        st, sc = streams(df, d, g, spec=spec, dram=dram, dtype=dtype)
        parts.append(st)
        scales.append(sc)
    all_streams = [torch.cat([p[i] for p in parts]) for i in range(6)]
    del parts
    stall = replay_buckets(*all_streams, dram=dram,
                              gran_bytes=int(spec["gran_bytes"]), dtype=dtype)
    del all_streams
    stall = stall * torch.cat(scales)
    out: Dict[Tuple, Dict[str, float]] = {}
    lo = 0
    for df, (group, d) in groups.items():
        n = len(group) * n_g
        m = design_metrics(df, d, g, stall[lo:lo + n].reshape(len(group),
                                                              n_g))
        lo += n
        cols = {k: v.detach().to(torch.float64).cpu().numpy()
                for k, v in m.items()}
        cols["edp"] = cols["energy_pj"] * 1e-9 * cols["total_cycles"]
        for i, des in enumerate(group):
            out[design_key(des)] = {c: float(cols[c][i])
                                    for c in METRIC_COLUMNS}
    return out
