"""The PyTorch port's cycle-level fold plane on the CPU against the JAX
reference: `simulate_fold`, the per-cycle scan, the fold matmul,
`batched_fold_activity` and the power trace built on them. The same
seeded numpy operands go to both; the Pallas kernels run in interpret
mode, as `tests/test_kernels.py` runs them. Tolerances: activity and
cycles exact; the functional output 1e-5 relative (atol 1e-5) in float32
and 2e-2 (atol 1e-4) in bfloat16, where both sides accumulate in float32
but may sum in another order; utilisation and power 1e-6 (float32 math
on both sides). The CUDA kernels themselves are held against these plain
versions on the card (`test_torch_cuda.py`, `chip_smoke.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as ren
from repro.core.accelerator import tpu_like_config as r_tpu_like
from repro.kernels import systolic as rsys
from repro_torch.core import energy as ten
from repro_torch.core.accelerator import tpu_like_config
from repro_torch.kernels import systolic as tsys

SHAPES = [(16, 8, 8), (37, 16, 8), (64, 32, 16), (100, 32, 32)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=1e-4)}


def _operands(seed, T, R, C, dt="f32"):
    """The same seeded numpy operands as a JAX and a torch pair."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, R)).astype(np.float32)
    w = rng.standard_normal((R, C)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    # one rounding on each side gives the same bits
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.to(torch.float32).numpy())
    return (jx, jw), (tx, tw)


def _f32(a):
    return np.asarray(a.to(torch.float32) if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("T,R,C", SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_simulate_fold_matches_reference(T, R, C, dt):
    (jx, jw), (tx, tw) = _operands(T * 31 + R, T, R, C, dt)
    ref = rsys.simulate_fold(jx, jw, interpret=True)
    got = tsys.simulate_fold(tx, tw)
    assert got.out.dtype == tx.dtype and got.out.shape == (T, C)
    np.testing.assert_allclose(_f32(got.out), _f32(ref.out), **TOL[dt])
    assert got.active.dtype == torch.int32
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    assert got.cycles == ref.cycles == tsys.total_cycles_ws(T, R, C)
    assert got.utilization.dtype == torch.float32
    np.testing.assert_allclose(float(got.utilization),
                               float(ref.utilization), rtol=1e-6)


@pytest.mark.parametrize("T,R,C", SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_per_cycle_scan_matches_reference(T, R, C, dt):
    """The port's per-cycle scan against the reference's: the same
    products summed in the same order, so both outputs and the activity
    agree; the scan's activity equals the fold's after the preload."""
    (jx, jw), (tx, tw) = _operands(T + R + C, T, R, C, dt)
    r_out, r_act = rsys.systolic_ws_reference(jx, jw)
    t_out, t_act = tsys.systolic_ws_reference(tx, tw)
    assert t_out.dtype == tx.dtype
    np.testing.assert_allclose(_f32(t_out), _f32(r_out), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(r_act))
    fold = tsys.simulate_fold(tx, tw)
    np.testing.assert_array_equal(fold.active[R:].numpy(), t_act.numpy())
    np.testing.assert_allclose(_f32(fold.out), _f32(t_out), **TOL[dt])


@pytest.mark.parametrize("T,R,C", [(256, 64, 256), (300, 32, 130)])
def test_systolic_matmul_blocked_shapes(T, R, C):
    """The reference kernel's blocked shapes (128 tiles, a ragged edge)."""
    (jx, jw), (tx, tw) = _operands(T, T, R, C)
    want = rsys.systolic_matmul(jx, jw, blk_t=128, blk_c=128, interpret=True)
    got = tsys.fold_output(tx, tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["f32"])


@pytest.mark.parametrize("xd,wd", [("float32", "bfloat16"),
                                   ("bfloat16", "float16"),
                                   ("float16", "float16"),
                                   ("bfloat16", "float32")])
def test_systolic_matmul_promotes_like_the_reference(xd, wd):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    w = rng.standard_normal((24, 20)).astype(np.float32)
    jx, jw = jnp.asarray(x, getattr(jnp, xd)), jnp.asarray(w, getattr(jnp, wd))
    tx = torch.from_numpy(x).to(getattr(torch, xd))
    tw = torch.from_numpy(w).to(getattr(torch, wd))
    want = rsys.systolic_matmul(jx, jw, interpret=True)
    got = tsys.fold_output(tx, tw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = TOL["f32"] if got.dtype == torch.float32 else dict(rtol=2e-2,
                                                            atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_integer_operands_are_refused():
    """64-bit integers (and float64) are refused, saying why: JAX's default
    config makes them 32-bit, so the reference has no such path; bool and
    complex are refused too. int8 .. int32 are taken (below)."""
    x = torch.ones((4, 4), dtype=torch.int8)
    with pytest.raises(TypeError, match="64-bit"):
        tsys.fold_output(x.to(torch.int64), x)
    with pytest.raises(TypeError, match="64-bit"):
        tsys.simulate_fold(x.to(torch.float64), x.to(torch.float64))
    with pytest.raises(TypeError, match="bool"):
        tsys.fold_output(x, x.to(torch.bool))
    with pytest.raises(TypeError, match="complex"):
        tsys.fold_output(x.to(torch.complex64), x.to(torch.complex64))


ACCEPTED = ["float32", "bfloat16", "float16", "int8", "uint8", "int16",
            "int32"]


def test_promotion_equals_the_reference_on_every_accepted_pair():
    for a in ACCEPTED:
        for b in ACCEPTED:
            got = tsys.ref.check_matmul_dtypes(
                torch.empty(0, dtype=getattr(torch, a)),
                torch.empty(0, dtype=getattr(torch, b)))
            want = jnp.promote_types(getattr(jnp, a), getattr(jnp, b))
            assert str(got).split(".")[-1] == str(want), (a, b)


def _ints(rng, shape, dt):
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dt)


# integer pairs, and integer x float pairs (the float operand has one
# +-1 a row of x or a column of w, so each output is one product and exact
# in any summation order: the casts of the integers to the float type,
# which round, are what is held)
INT_PAIRS = [("int8", "int8"), ("uint8", "uint8"), ("int16", "int16"),
             ("int32", "int32"), ("int8", "uint8"), ("uint8", "int16"),
             ("int8", "int32"), ("int16", "int32"), ("uint8", "int32"),
             ("int8", "float32"), ("float32", "int8"), ("int32", "float32"),
             ("uint8", "bfloat16"), ("int16", "bfloat16"),
             ("int16", "float16"), ("bfloat16", "int32"),
             ("float16", "uint8")]


@pytest.mark.parametrize("xd,wd", INT_PAIRS, ids=["-".join(p)
                                                  for p in INT_PAIRS])
def test_integer_matmul_matches_the_reference_exactly(xd, wd):
    """Integer and integer x float folds against the Pallas kernel in
    interpret mode, bit for bit, full-range integers (the integer sums
    wrap modulo 2^bits of the promoted type on both sides)."""
    rng = np.random.default_rng(len(xd) * 31 + len(wd))
    T, R, C = 37, 24, 20
    ops = []
    for dt, shape in ((xd, (T, R)), (wd, (R, C))):
        if dt.startswith(("int", "uint")):
            ops.append(_ints(rng, shape, np.dtype(dt)))
        elif shape == (T, R):       # one nonzero a row of x
            one = np.zeros(shape, np.float32)
            one[np.arange(T), rng.integers(0, R, T)] = 1.0
            ops.append(one * rng.choice([-1.0, 1.0], shape))
        else:                       # one nonzero a column of w
            one = np.zeros(shape, np.float32)
            one[rng.integers(0, R, C), np.arange(C)] = 1.0
            ops.append(one * rng.choice([-1.0, 1.0], shape))
    jx = jnp.asarray(ops[0]).astype(getattr(jnp, xd))
    jw = jnp.asarray(ops[1]).astype(getattr(jnp, wd))
    tx = torch.from_numpy(ops[0]).to(getattr(torch, xd))
    tw = torch.from_numpy(ops[1]).to(getattr(torch, wd))
    want = rsys.systolic_matmul(jx, jw, interpret=True)
    got = tsys.fold_output(tx, tw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if got.is_floating_point():
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt,want", [("int8", 0), ("int32", 19200)])
def test_integer_matmul_wraps_as_the_reference(dt, want):
    """100 x 3 summed over 64 rows: 19,200, which int8 keeps modulo 256."""
    jx = jnp.full((2, 64), 100, getattr(jnp, dt))
    jw = jnp.full((64, 3), 3, getattr(jnp, dt))
    ref = np.asarray(rsys.systolic_matmul(jx, jw, interpret=True))
    got = tsys.fold_output(torch.full((2, 64), 100, dtype=getattr(torch, dt)),
                           torch.full((64, 3), 3, dtype=getattr(torch, dt)))
    np.testing.assert_array_equal(ref, np.full((2, 3), want))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("Ts,R,C,n_cycles", [
    ([16, 32, 64], 8, 8, 64 + 8 + 8 - 2),
    ([1, 5, 100, 40, 0], 8, 4, 60),       # 100 and 40 overrun n_cycles
    ([7], 16, 32, 200),                   # past the fold's end: zeros
])
def test_batched_fold_activity_matches_reference(Ts, R, C, n_cycles):
    want = np.asarray(rsys.batched_fold_activity(
        jnp.asarray(Ts), R=R, C=C, n_cycles=n_cycles, interpret=True))
    got = tsys.batched_fold_activity(torch.tensor(Ts), R=R, C=C,
                                     n_cycles=n_cycles)
    assert got.dtype == torch.int32 and got.shape == (len(Ts), n_cycles)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, t in enumerate(Ts):
        full = tsys.wavefront_activity_reference(t, R, C)
        k = min(n_cycles, full.shape[0])
        np.testing.assert_array_equal(got[i, :k].numpy(), full[:k].numpy())
        assert int(got[i, k:].abs().sum()) == 0
        if k == full.shape[0]:
            assert int(got[i].sum()) == t * R * C


@pytest.mark.parametrize("T,R,C", SHAPES)
def test_wavefront_closed_form_matches_reference(T, R, C):
    got = tsys.wavefront_activity_reference(T, R, C)
    want = np.asarray(rsys.wavefront_activity_reference(T, R, C))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == T * R * C and int(got.max()) <= R * C


@pytest.mark.parametrize("T,R,C,n_cycles", [
    (0, 8, 8, 20), (1, 8, 8, 20), (1, 1, 1, 3), (37, 16, 8, 70),
    (37, 1, 8, 50), (37, 16, 1, 40),                  # R = 1, C = 1
    (100, 32, 16, 60),                                # n_cycles < T + R + C - 2
    (100, 8, 32, 400),                                # n_cycles > T + R + C - 2
    (60_000, 2, 3, 70_000)])                          # terms past int32
def test_wavefront_closed_form_equals_pallas_kernel(T, R, C, n_cycles):
    """The CUDA kernel's closed form against the interpret-mode Pallas
    kernel and the plain row sum, exactly."""
    got = tsys.wavefront_closed_form(torch.tensor([T], dtype=torch.int32),
                                     R=R, C=C, n_cycles=n_cycles)
    assert got.dtype == torch.int32 and got.shape == (1, n_cycles)
    # long windows in 8,192-cycle blocks: fewer interpreted grid steps
    want = np.asarray(rsys.wavefront_activity(
        jnp.int32(T), R=R, C=C, n_cycles=n_cycles,
        blk_n=256 if n_cycles <= 4096 else 8192, interpret=True))
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tsys.wavefront_activity_plain(
            torch.tensor([T], dtype=torch.int32), R=R, C=C,
            n_cycles=n_cycles).numpy())
    assert int(got.sum()) == T * R * C or n_cycles < T + R + C - 2


def test_wavefront_closed_form_batched_and_negative_T():
    """A batch of folds, T < 0 among them (the row sum counts it as 0)."""
    Ts = torch.tensor([-5, 0, 1, 16, 300, 7], dtype=torch.int32)
    got = tsys.wavefront_closed_form(Ts, R=12, C=5, n_cycles=97)
    np.testing.assert_array_equal(
        got.numpy(), tsys.wavefront_activity_plain(Ts, R=12, C=5,
                                                   n_cycles=97).numpy())
    assert int(got[:2].abs().sum()) == 0


@pytest.mark.parametrize("array,T", [(16, 64), (8, 37)])
def test_instantaneous_power_trace_matches_reference(array, T):
    (jx, jw), (tx, tw) = _operands(array + T, T, array, array)
    ert = dict(mac_random=0.2, pe_leak_per_cycle=0.05)
    for kw in ({}, {"ert": ert}):
        r_kw = {"ert": ren.ERT(**kw["ert"])} if kw else {}
        t_kw = {"ert": ten.ERT(**kw["ert"])} if kw else {}
        sim = rsys.simulate_fold(jx, jw, interpret=True)
        want = np.asarray(ren.instantaneous_power_trace(
            sim.active, r_tpu_like(array=array), clock_ghz=1.5, **r_kw))
        fold = tsys.simulate_fold(tx, tw)
        got = ten.instantaneous_power_trace(
            fold.active, tpu_like_config(array=array), clock_ghz=1.5, **t_kw)
        assert got.dtype == torch.float32 and got.shape == (fold.cycles,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # elementwise: a stack of folds' activity gives each fold's trace
    stacked = ten.instantaneous_power_trace(
        torch.stack([fold.active, fold.active.flip(0)]),
        tpu_like_config(array=array))
    np.testing.assert_array_equal(
        stacked[0].numpy(),
        ten.instantaneous_power_trace(fold.active,
                                      tpu_like_config(array=array)).numpy())


def test_action_counts_and_power_w_match_reference():
    stats = dict(cycles=1.5e6, macs=3.0e8, ifmap_reads=2e5,
                 filter_reads=1e5, ofmap_writes=5e4, ofmap_reads=1e4,
                 dram_bytes=4e6, l2_reads=10.0, noc_byte_hops=3.0)
    for array, cores in ((32, 1), (128, 4)):
        want = ren.action_counts(r_tpu_like(array=array, cores=cores),
                                 **stats)
        got = ten.action_counts(tpu_like_config(array=array, cores=cores),
                                **stats)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, err_msg=k)
        e_r = ren.energy_pj(want)["total"]
        e_t = ten.energy_pj(got)["total"]
        np.testing.assert_allclose(float(ten.power_w(e_t, 1.5e6, 0.7)),
                                   float(ren.power_w(e_r, 1.5e6, 0.7)),
                                   rtol=1e-6)
    assert ten.power_w(10.0, 0.0) == ren.power_w(10.0, 0.0)
