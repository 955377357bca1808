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
