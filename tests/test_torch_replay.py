"""The plain PyTorch version of the replay kernel against the JAX
reference's per-request scan (`repro.core.dram.replay_requests(...,
engine="reference")`, which dispatches to `_reference_scan`; the
reference's `replay_decoded(engine="reference")` would run its chunked
XLA driver instead).

Row hit/miss/conflict counts are order-only and must match exactly;
completion times agree within rtol 1e-3 / atol 5e-2, the tolerance of the
reference's own fuzz suite: the chunk closures re-associate float32 sums.
One stream also runs against the literal Pallas megakernel in interpret
mode, which shares the port's chunk formulation pass for pass.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.accelerator as racc
import repro.core.dram as rdram
import repro_torch.core.accelerator as tacc
import repro_torch.core.dram as tdram
from repro.kernels.replay import replay_megakernel as jax_megakernel
from repro_torch.core import replay as trp
from repro_torch.kernels.replay import megakernel as tmk

RTOL, ATOL = 1e-3, 5e-2


def fuzz_stream(seed, n, *, span=1 << 22, p_write=0.3, p_valid=0.9,
                burst=None, batch=()):
    """Random mixed read/write streams (numpy); `burst` pins every request
    into a `burst`-burst address window (queue and bank pressure)."""
    rng = np.random.default_rng(seed)
    shape = tuple(batch) + (n,)
    t = np.sort(rng.uniform(0.0, 3.0 * n, shape), axis=-1).astype(np.float32)
    if burst is not None:
        addr = (rng.integers(0, burst, shape) * 64).astype(np.int64)
    else:
        addr = ((rng.integers(0, span, shape) // 64) * 64).astype(np.int64)
    return t, addr, rng.random(shape) < p_write, rng.random(shape) < p_valid


def reference(t, addr, w, v, cfg, gran=64):
    """The JAX per-request scan, one 1-D stream at a time."""
    if t.ndim > 1:
        outs = [reference(t[i], addr[i], w[i], v[i], cfg, gran)
                for i in range(t.shape[0])]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}
    fb, ch, row = rdram.decode_requests(jnp.asarray(addr), cfg)
    r = rdram.replay_requests(jnp.asarray(t), fb, ch, row, jnp.asarray(w),
                              jnp.asarray(v), cfg, gran, engine="reference")
    return dict(done=np.asarray(r.complete), stall=np.asarray(r.stall_cycles),
                hits=np.asarray(r.row_hits), misses=np.asarray(r.row_misses),
                conflicts=np.asarray(r.row_conflicts))


def port(t, addr, w, v, cfg, *, chunk=None, tol=None, max_passes=None,
         engine=None):
    tcfg = tacc.DramConfig(**dataclasses.asdict(cfg))
    fb, ch, row = tdram.decode_requests(torch.from_numpy(addr), tcfg)
    args = (torch.from_numpy(t), fb, ch, row, torch.from_numpy(w),
            torch.from_numpy(v), tcfg)
    if tol is None and max_passes is None:
        r = tdram.replay_requests(*args, engine=engine, chunk=chunk)
        return dict(done=r.complete.numpy(), stall=r.stall_cycles.numpy(),
                    hits=r.row_hits.numpy(), misses=r.row_misses.numpy(),
                    conflicts=r.row_conflicts.numpy())
    out = trp.replay_decoded(*args, chunk=chunk, max_passes=max_passes,
                             tol=trp.DEFAULT_TOL if tol is None else tol)
    return {k: x.numpy() for k, x in out.items()}


def assert_matches(ref, out, v):
    for k in ("hits", "misses", "conflicts"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_allclose(np.where(v, out["done"], 0.0),
                               np.where(v, ref["done"], 0.0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_streams(seed):
    t, a, w, v = fuzz_stream(seed, 512)
    cfg = racc.DramConfig()
    ref, out = reference(t, a, w, v, cfg), port(t, a, w, v, cfg)
    assert_matches(ref, out, v)
    np.testing.assert_allclose(out["stall"], ref["stall"], rtol=RTOL,
                               atol=ATOL)


def test_same_bank_chain():
    """Alternating rows in one bank: an unbroken conflict chain."""
    n = 384
    t = np.arange(n, dtype=np.float32) * 0.5
    a = (np.arange(n) % 2).astype(np.int64) * (1 << 21)
    w, v = np.zeros(n, bool), np.ones(n, bool)
    cfg = racc.DramConfig(channels=1, banks_per_channel=1)
    ref = reference(t, a, w, v, cfg)
    assert int(ref["conflicts"]) > n // 2
    assert_matches(ref, port(t, a, w, v, cfg), v)


@pytest.mark.parametrize("burst,queues", [(4, (8, 8)), (64, (8, 8)),
                                          (4, (4, 2))])
def test_queue_saturation(burst, queues):
    """In-flight rings shorter than the chunk plus arrivals far faster than
    service: requests wait on ring heads that sit inside their own chunk
    (the in-chunk queue heads), and the backpressure shift grows."""
    t, a, w, v = fuzz_stream(7 + burst, 512, burst=burst, p_valid=0.95)
    t = t * np.float32(0.01)
    cfg = racc.DramConfig(read_queue=queues[0], write_queue=queues[1])
    ref = reference(t, a, w, v, cfg)
    assert float(ref["stall"]) > 0.0
    out = port(t, a, w, v, cfg)
    assert_matches(ref, out, v)
    np.testing.assert_allclose(out["stall"], ref["stall"], rtol=RTOL)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_chunk_boundaries(n, chunk):
    """Streams that end mid-chunk, fit one chunk, or underfill it."""
    t, a, w, v = fuzz_stream(n * 1000 + chunk, n)
    cfg = racc.DramConfig()
    assert_matches(reference(t, a, w, v, cfg),
                   port(t, a, w, v, cfg, chunk=chunk), v)


def test_batched_streams():
    """A (3, n) batch replays in one call and equals the per-stream scans."""
    t, a, w, v = fuzz_stream(10, 256, batch=(3,))
    cfg = racc.DramConfig()
    ref, out = reference(t, a, w, v, cfg), port(t, a, w, v, cfg)
    assert out["done"].shape == (3, 256) and out["hits"].shape == (3,)
    assert_matches(ref, out, v)


def test_tol_zero_reaches_exact_fixed_point_and_cap_binds():
    """tol=0.0 iterates to the exact fixed point (a higher cap changes
    nothing); max_passes=1 caps the iteration below it."""
    t, a, w, v = fuzz_stream(5, 256, burst=2, p_valid=1.0)
    cfg = racc.DramConfig(channels=1, banks_per_channel=1)
    ref = reference(t, a, w, v, cfg)
    full = port(t, a, w, v, cfg, tol=0.0)
    capped = port(t, a, w, v, cfg, tol=0.0, max_passes=512)
    one = port(t, a, w, v, cfg, tol=0.0, max_passes=1)
    assert_matches(ref, full, v)
    np.testing.assert_allclose(capped["done"], full["done"], rtol=1e-6)
    # the pass operator is monotone from below: one pass underestimates
    assert np.all(one["done"] <= full["done"] + 1e-3)
    assert not np.array_equal(one["done"], full["done"])


@pytest.mark.parametrize("max_passes", [None, 1])
def test_against_interpret_mode_pallas_megakernel(max_passes):
    """The Pallas megakernel body, interpreted on the CPU, and the port's
    plain version run the same chunk formulation: counts match exactly and
    completions agree, also when a pass cap stops both short of the fixed
    point."""
    t, a, w, v = fuzz_stream(21, 128, burst=32, p_valid=0.9)
    t = t * np.float32(0.05)
    cfg = racc.DramConfig(read_queue=8, write_queue=8)
    fb, ch, row = rdram.decode_requests(jnp.asarray(a), cfg)
    ref = jax_megakernel(jnp.asarray(t), fb, ch, row,
                         jnp.asarray(w.astype(np.int32)),
                         jnp.asarray(v.astype(np.int32)), cfg,
                         max_passes=max_passes, tol=0.25, interpret=True)
    out = port(t, a, w, v, cfg, tol=0.25, max_passes=max_passes)
    for k in ("hits", "misses", "conflicts"):
        assert int(out[k]) == int(ref[k]), k
    np.testing.assert_allclose(out["done"], np.asarray(ref["done"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["shift"], np.asarray(ref["shift"]),
                               rtol=RTOL, atol=ATOL)


def test_port_reference_scan_matches_jax_reference_scan():
    """The port's own per-request oracle equals the JAX one."""
    t, a, w, v = fuzz_stream(3, 200, burst=16)
    cfg = racc.DramConfig(read_queue=4, write_queue=4)
    ref = reference(t, a, w, v, cfg)
    out = port(t, a, w, v, cfg, engine="reference")
    for k in ("hits", "misses", "conflicts"):
        np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_allclose(out["done"], ref["done"], rtol=1e-6)


def test_engine_labels_and_validation():
    assert trp.resolve_engine_runtime(None, "cpu") == "torch:plain"
    assert trp.resolve_engine_runtime("megakernel", "cuda") == "cuda"
    assert trp.resolve_engine_runtime("reference", "cpu") == "reference"
    with pytest.raises(ValueError):
        trp.resolve_engine("xla")


def test_cpu_tensors_take_the_plain_version_without_launching():
    t, a, w, v = fuzz_stream(4, 100)
    before = tmk.LAUNCHES
    port(t, a, w, v, racc.DramConfig())
    assert tmk.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA launch path checks its inputs; a CPU tensor never reaches
    the kernel (and never falls back)."""
    ins = tmk.prepare(torch.zeros(64), *(torch.zeros(64, dtype=torch.int32)
                                         for _ in range(5)), 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmk.launch_cuda(ins, cfg=tacc.DramConfig(), busy=3.3, C=64,
                        max_passes=None, tol=0.25)


# ---- the CUDA kernel's formulation, in plain PyTorch (tests only) --------
# `csrc/replay_megakernel.cu` runs one warp per stream: each chunk's links
# come from warp votes, 32 requests (one slot) at a time, with stamped
# per-bank and per-channel tables carrying them across slots; sums and
# maxima along the links are taken by pointer jumping. The functions below
# do the same, so the formulation is held against `chunkmath`'s masked
# forms and against `run_plain` on the CPU.

def links_by_slots(fb, ch, v, w, last_b, last_c, base):
    """The kernel's step 1 for one chunk of 1-D tensors: per 32-request
    slot, the highest valid same-bank (same-channel) request below each
    valid request is its `prev` (`pin`), else the last one an earlier slot
    recorded in `last_b` (`last_c`), whose stamps are `base + index`
    (older stamps mean "none"); the last valid peer of each key in a slot
    records itself. Direction ranks count the valid reads (writes) below.
    Updates the tables in place; returns (prev, pin, didx, nr, nw)."""
    C = fb.shape[0]
    prev = torch.full((C,), -1, dtype=torch.int64)
    pin = prev.clone()
    didx = torch.zeros(C, dtype=torch.int64)
    cr = cw = 0
    for q0 in range(0, C, 32):
        idx = torch.arange(q0, min(q0 + 32, C))
        vs, ws = v[idx], w[idx]
        lower = idx[None, :] < idx[:, None]          # [i, j]: j below i
        upper = idx[None, :] > idx[:, None]
        for key, table, out in ((fb, last_b, prev), (ch, last_c, pin)):
            k = torch.where(vs, key[idx].long(), 0)
            peers = (k[None, :] == k[:, None]) & vs[None, :] & vs[:, None]
            below = torch.where(peers & lower, idx[None, :], -1).amax(1)
            stamp = table[k]
            carried = torch.where(stamp >= base, stamp - base, -1)
            out[idx] = torch.where(
                vs, torch.where(below >= 0, below, carried), -1)
            last = vs & ~(peers & upper).any(1)
            table[k[last]] = base + idx[last]
        rm, wm = (vs & ~ws).long(), (vs & ws).long()
        rdx = cr + torch.cumsum(rm, 0) - rm
        wdx = cw + torch.cumsum(wm, 0) - wm
        didx[idx] = torch.where(ws, wdx, rdx)
        cr, cw = cr + int(rm.sum()), cw + int(wm.sum())
    return prev, pin, didx, cr, cw


def queue_heads(didx, v, w, *, Qr, Qw, C):
    """`ghead` through the kernel's rank -> request table: reads fill it
    from the front, writes from the back (nr + nw <= C slots)."""
    idx = torch.arange(C)
    rank = torch.full((C,), -1, dtype=torch.int64)
    rm, wm = v & ~w, v & w
    rank[didx[rm]] = idx[rm]
    rank[C - 1 - didx[wm]] = idx[wm]
    Q = torch.where(w, Qw, Qr)
    want = didx - Q
    at = torch.where(w, C - 1 - want, want).clamp(0, C - 1)
    on = v & (want >= 0) & (Qr < C or Qw < C)
    return torch.where(on, rank[at], -1)


def jump_sum(x, link, levels):
    """Inclusive sums along the links by pointer jumping: each round adds
    the value its pointer holds and jumps the pointer to that node's. Also
    returns the rounds' pointers (the jump tables of the maxima)."""
    val, ptr, jumps = x.clone(), link.clone(), []
    for _ in range(levels):
        if not bool((ptr >= 0).any()):
            break
        jumps.append(ptr)
        has, p = ptr >= 0, ptr.clamp_min(0)
        val = torch.where(has, val + val[p], val)
        ptr = torch.where(has, ptr[p], -1)
    return val, jumps


def jump_max(x, jumps):
    """Inclusive maxima along the links, over recorded jump pointers."""
    for J in jumps:
        x = torch.where(J >= 0, torch.maximum(x, x[J.clamp_min(0)]), x)
    return x


def replay_by_links(ins, *, cfg, busy, C, max_passes, tol):
    """`run_plain`'s function in the kernel's formulation, one stream and
    one chunk at a time (float32 throughout). Returns (done, shift (S, 1),
    cnt)."""
    t_all, fb_all, ch_all, row_all, w_all, v_all, _ = ins
    S, npad = t_all.shape
    f32 = torch.float32
    busy32 = torch.tensor(busy, dtype=f32)
    nb = cfg.channels * cfg.banks_per_channel
    Qr, Qw = cfg.read_queue, cfg.write_queue
    levels = max(1, (C - 1).bit_length())
    cap = C + 2 if max_passes is None else max_passes
    idx = torch.arange(C)
    done_all = torch.zeros_like(t_all)
    shifts = torch.zeros((S, 1), dtype=f32)
    cnt = torch.zeros((S, 4), dtype=torch.int32)
    for s in range(S):
        bank_free = torch.zeros(nb)
        open_row = torch.full((nb,), -1, dtype=torch.int32)
        last_b = torch.full((nb,), -1, dtype=torch.int64)
        bus_free = torch.zeros(cfg.channels)
        last_c = torch.full((cfg.channels,), -1, dtype=torch.int64)
        ring_r, ring_w = torch.zeros(Qr), torch.zeros(Qw)
        ir = iw = 0
        shift = torch.zeros((), dtype=f32)
        for c in range(npad // C):
            sl = slice(c * C, (c + 1) * C)
            t, fb, ch = t_all[s, sl], fb_all[s, sl].long(), ch_all[s, sl].long()
            row, w, v = row_all[s, sl], w_all[s, sl] != 0, v_all[s, sl] != 0
            prev, pin, didx, nr, nw = links_by_slots(fb, ch, v, w, last_b,
                                                     last_c, c * C)
            gh = queue_heads(didx, v, w, Qr=Qr, Qw=Qw, C=C)
            slot = (didx + torch.where(w, iw, ir)) % torch.where(w, Qw, Qr)
            surv = v & (didx + torch.where(w, Qw, Qr) >= torch.where(w, nw,
                                                                      nr))
            head0 = torch.where(w, ring_w[slot.clamp_max(Qw - 1)],
                                ring_r[slot.clamp_max(Qr - 1)])
            fbv, chv = torch.where(v, fb, 0), torch.where(v, ch, 0)
            intra = prev >= 0
            seen = torch.where(intra, row[prev.clamp_min(0)], open_row[fbv])
            lat, hit, empty = tdram.row_buffer_latency(cfg, seen, row)
            cnt[s, 0] += int((hit & v).sum())
            cnt[s, 1] += int((empty & v).sum())
            cnt[s, 2] += int((~hit & ~empty & v).sum())
            lat = torch.where(v, lat.to(f32), 0.0)
            linked = intra & (pin >= 0) & (fb[pin.clamp_min(0)] == fb)
            we = torch.where(v, busy32 + torch.where(linked, lat, 0.0), 0.0)
            lb = torch.where(v, lat + busy32, 0.0)
            W, jc = jump_sum(we, pin, levels)
            V, jb = jump_sum(lb, prev, levels)
            gprev = torch.where(
                intra & (lat + busy32 > W - W[prev.clamp_min(0)]), prev, -1)
            bank0 = torch.where(v, bank_free[fbv], 0.0)
            bus0 = torch.where(v, bus_free[chv], 0.0)

            def heads(done):
                return torch.where(gh >= 0, torch.maximum(
                    head0, done[gh.clamp_min(0)]), head0)

            def one_pass(done):
                head = heads(done)
                g = torch.where(v, head - t, -torch.inf)
                excl = torch.cat([torch.full((1,), -torch.inf),
                                  torch.cummax(g, 0).values[:-1]])
                ss = torch.maximum(shift, excl)
                issue_ok = torch.maximum(t + ss, head)
                bankp = torch.where(gprev >= 0, torch.maximum(
                    bank0, done[gprev.clamp_min(0)]), bank0)
                sv = torch.maximum(torch.maximum(issue_ok, bankp) + lat
                                   + busy32, done)
                m = jump_max(torch.where(v, sv - W, -torch.inf), jc)
                u = torch.maximum(m + W, bus0 + W)
                m = jump_max(torch.where(v, u - V, -torch.inf), jb)
                return torch.where(v, m + V, 0.0)

            d = one_pass(torch.zeros(C))
            if cap >= 2:
                before, d = d, one_pass(d)
                passes, moved = 2, bool((d - before > tol).any())
                while cap > 2 and passes < cap and moved:
                    before, d = d, one_pass(d)
                    passes, moved = passes + 1, bool((d - before > tol).any())
            done_all[s, sl] = d
            g = torch.where(v, heads(d) - t, -torch.inf)
            shift = torch.maximum(shift, g.max())
            lbf = v & (last_b[fbv] == c * C + idx)
            lcf = v & (last_c[chv] == c * C + idx)
            bank_free[fb[lbf]] = d[lbf]
            open_row[fb[lbf]] = row[lbf]
            bus_free[ch[lcf]] = d[lcf]
            ring_r[slot[surv & ~w]] = d[surv & ~w]
            ring_w[slot[surv & w]] = d[surv & w]
            ir, iw = ir + nr, iw + nw
        shifts[s, 0] = shift
    return done_all, shifts, cnt


def _chunk(seed, C, cfg, *, burst=None, p_valid=0.9):
    t, a, w, v = fuzz_stream(seed, C, burst=burst, p_valid=p_valid)
    tcfg = tacc.DramConfig(**dataclasses.asdict(cfg))
    fb, ch, row = tdram.decode_requests(torch.from_numpy(a), tcfg)
    return (tcfg, torch.from_numpy(t), fb.long(), ch.long(), row,
            torch.from_numpy(w), torch.from_numpy(v))


@pytest.mark.parametrize("C", [1, 16, 31, 32, 33, 64, 65, 128])
@pytest.mark.parametrize("dram", ["default", "few_banks", "queues_4_2"])
def test_link_formulation_matches_masked_forms(C, dram):
    """Links, ranks, queue heads and last-of-key flags from the slot-wise
    votes equal `chunk_tables`; maxima along the links over the jump
    pointers equal the masked `rowmax` exactly, and sums by pointer
    jumping equal the masked `rowsum` within 1e-6 relative. The second of
    two chunks runs through the same stamped tables, so stale stamps are
    exercised."""
    from repro_torch.kernels.replay import chunkmath as cm
    cfg = {"default": racc.DramConfig(),
           "few_banks": racc.DramConfig(channels=2, banks_per_channel=2),
           "queues_4_2": racc.DramConfig(read_queue=4, write_queue=2)}[dram]
    burst = None if dram == "default" else 16
    last_b = torch.full((cfg.channels * cfg.banks_per_channel,), -1,
                        dtype=torch.int64)
    last_c = torch.full((cfg.channels,), -1, dtype=torch.int64)
    levels = max(1, (C - 1).bit_length())
    for chunk in range(2):
        tcfg, _, fb, ch, row, w, v = _chunk(C * 10 + chunk, C, cfg,
                                            burst=burst)
        prev, pin, didx, nr, nw = links_by_slots(fb, ch, v, w, last_b,
                                                 last_c, chunk * C)
        tab = cm.chunk_tables(fb[None], ch[None], row[None], w[None], v[None],
                              cfg=tcfg, busy=64 / 19.2)
        idx = torch.arange(C)
        ii, jj = idx[:, None], idx[None, :]
        same_b = (fb[None, :] == fb[:, None]) & v[None, :]
        same_c = (ch[None, :] == ch[:, None]) & v[None, :]
        want_prev = cm.rowmax(same_b & (jj < ii), idx, -1)
        want_pin = cm.rowmax(same_c & (jj < ii), idx, -1)
        assert torch.equal(prev[v], want_prev[v])
        assert torch.equal(pin[v], want_pin[v])
        assert (nr, nw) == (int(tab.nr), int(tab.nw))
        assert torch.equal(didx[v & ~w], tab.rdx[0][v & ~w].long())
        assert torch.equal(didx[v & w], tab.wdx[0][v & w].long())
        gh = queue_heads(didx, v, w, Qr=cfg.read_queue, Qw=cfg.write_queue,
                         C=C)
        assert torch.equal(gh[v], tab.ghead[0][v].long())
        base = chunk * C
        assert torch.equal(v & (last_b[torch.where(v, fb, 0)] == base + idx),
                           tab.last_b[0])
        assert torch.equal(v & (last_c[torch.where(v, ch, 0)] == base + idx),
                           tab.last_c[0])
        g = torch.Generator().manual_seed(C + chunk)
        x = torch.randn(C, generator=g) * 100
        pos = torch.rand(C, generator=g) * 40 + 3
        for link, mask in ((prev, tab.mbank[0]), (pin, tab.mchan[0])):
            sums, jumps = jump_sum(torch.where(v, pos, 0.0), link, levels)
            assert len(jumps) <= levels
            got = jump_max(torch.where(v, x, -torch.inf), jumps)
            assert torch.equal(got[v], cm.rowmax(mask, x)[v])
            want = cm.rowsum(mask, torch.where(v, pos, 0.0))
            torch.testing.assert_close(sums[v], want[v], rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", [
    "random_c64", "random_c1", "random_c31", "random_c33", "random_c65",
    "random_c128", "queues_8_c16", "queues_4_2_c64", "one_bank_tol0",
    "one_bank_tol0_cap1", "one_bank_tol0_cap2"])
def test_link_formulation_replays_like_the_plain_version(case):
    """The whole replay in the kernel's formulation (links by slots,
    pointer-jumping sums and maxima, the unchanged fixed point) against
    `run_plain`: counts exact, completions and shifts within 1e-5
    relative (the two sum W and V in different orders)."""
    cfg, burst, t_scale, tol, cap = racc.DramConfig(), None, 1.0, 0.25, None
    C = 64
    if case.startswith("random_c"):
        C = int(case[len("random_c"):])
    elif case.startswith("queues"):
        q = (8, 8) if case == "queues_8_c16" else (4, 2)
        C = 16 if case == "queues_8_c16" else 64
        cfg = racc.DramConfig(read_queue=q[0], write_queue=q[1])
        burst, t_scale = 64, 0.01
    else:
        cfg = racc.DramConfig(channels=1, banks_per_channel=1)
        burst, tol = 2, 0.0
        cap = {"one_bank_tol0": None, "one_bank_tol0_cap1": 1,
               "one_bank_tol0_cap2": 2}[case]
    t, a, w, v = fuzz_stream(len(case) * 7 + C, 200, burst=burst,
                             batch=(2,))
    t = t * np.float32(t_scale)
    tcfg = tacc.DramConfig(**dataclasses.asdict(cfg))
    fb, ch, row = tdram.decode_requests(torch.from_numpy(a), tcfg)
    ins = tmk.prepare(torch.from_numpy(t), fb, ch, row, torch.from_numpy(w),
                      torch.from_numpy(v), C)
    kw = dict(cfg=tcfg, busy=64 / 19.2, C=C, max_passes=cap, tol=tol)
    dl, sl, cl = replay_by_links(ins, **kw)
    dp, sp, cp, _ = tmk.run_plain(ins, **kw)
    assert torch.equal(cl, cp)
    torch.testing.assert_close(dl, dp, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(sl, sp, rtol=1e-5, atol=1e-3)
