"""The port's optimizer and checkpointing (`repro_torch.optim`,
`repro_torch.checkpoint`) against the JAX reference (`repro.optim`,
`repro.checkpoint`) on the same seeded numpy trees: AdamW over three steps
with a cosine schedule, global-norm clipping, the schedule itself and
int8 compression with error feedback, in float32 and bfloat16, each
within 1e-6 of the leaf's largest magnitude (the reference jitted, as its
callers run it); the reference's own optimizer and checkpoint oracles
(`tests/test_substrates.py`) on the port; checkpoints written by either
package restored by the other, bfloat16 leaves included, with equal
manifests."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.optim import clip_by_global_norm as rclip
from repro.optim import cosine_schedule as rcosine
from repro.optim.compress import compress_decompress as rcompress
from repro_torch.checkpoint import CheckpointManager, PreemptionHandler
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, compress_decompress,
                               cosine_schedule, int8_compress,
                               int8_decompress)

TOL = 1e-6
DTYPES = ["float32", "bfloat16"]


def make_tree(seed, dtype, scale=1.0):
    """A parameter-shaped tree: a stacked block weight, a small leaf, a
    nested group, keys out of sorted order."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 8, 16), "b": (16,),
              "blocks": {"wq": (2, 16, 4), "bq": (2, 4)}}

    def leaf(shape):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16).astype(np.float32) \
            if dtype == "bfloat16" else a
    return _map(leaf, shapes)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_torch(tree, dtype):
    return _map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)), tree)


def to_jax(tree, dtype):
    return _map(lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree)


def pairs(port, ref):
    if isinstance(port, dict):
        assert set(port) == set(ref)
        return [p for k in port for p in pairs(port[k], ref[k])]
    return [(port, ref)]


def rel(port, ref) -> float:
    a = port.detach().to(torch.float64).numpy()
    b = np.asarray(ref, np.float32).astype(np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-30))


def assert_close(port, ref, tol=TOL):
    for a, b in pairs(port, ref):
        assert rel(a, b) <= tol


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_three_steps_with_a_schedule(dtype):
    params = make_tree(0, dtype)
    grads = [make_tree(1 + i, dtype, scale=0.1) for i in range(3)]
    sched = dict(base_lr=1e-2, warmup=2, total=3)
    rstep = jax.jit(lambda g, s, p: radamw_update(
        g, s, p, lr=rcosine(**sched)))
    rp = to_jax(params, dtype)
    rs = radamw_init(rp)
    tp = to_torch(params, dtype)
    ts = adamw_init(tp)
    lr = cosine_schedule(**sched)
    for g in grads:
        rp, rs = rstep(to_jax(g, dtype), rs, rp)
        tp2, ts = adamw_update(to_torch(g, dtype), ts, tp, lr=lr)
        assert tp2 is tp                           # updated in place
    assert int(ts.step) == int(rs.step) == 3
    assert ts.step.dtype == torch.int32
    assert all(a.dtype == getattr(torch, dtype) for a, _ in pairs(tp, rp))
    assert all(a.dtype == torch.float32 for a, _ in pairs(ts.m, rs.m))
    assert_close(tp, rp)
    assert_close(ts.m, rs.m)
    assert_close(ts.v, rs.v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_norm", [1.0, 1e3])       # clips / does not
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    g = make_tree(5, dtype)
    rg, rgn = jax.jit(lambda t: rclip(t, max_norm))(to_jax(g, dtype))
    tg = to_torch(g, dtype)
    out, gn = clip_by_global_norm(tg, max_norm)
    assert out is tg                               # in place
    assert gn.dtype == torch.float32
    assert abs(float(gn) - float(rgn)) <= TOL * float(rgn)
    assert all(a.dtype == getattr(torch, dtype) for a, _ in pairs(out, rg))
    assert_close(out, rg)


def test_cosine_schedule_matches_reference():
    for warmup, total in ((0, 10), (5, 50), (2, 3)):
        r = jax.jit(rcosine(3e-4, warmup, total))
        t = cosine_schedule(3e-4, warmup, total)
        for s in range(total + 3):
            got = t(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            want = float(r(jnp.int32(s)))
            assert abs(float(got) - want) <= TOL * 3e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_decompress_two_steps_with_a_residual(dtype):
    """The dequantized gradients within 1e-6 of the leaf's largest
    magnitude; the residuals within 1e-6 of the gradient leaf's: a
    residual is the rounding remainder, 1/254 of the gradient's scale,
    and XLA fuses its `gf - q * scale` into one rounding."""
    g1, g2 = make_tree(7, dtype, 0.01), make_tree(8, dtype, 0.01)
    rfn = jax.jit(rcompress)
    rd1, rr1 = rfn(to_jax(g1, dtype), None)
    rd2, rr2 = rfn(to_jax(g2, dtype), rr1)
    t1 = to_torch(g1, dtype)
    td1, tr1 = compress_decompress(t1)
    td2, tr2 = compress_decompress(to_torch(g2, dtype), tr1)
    assert_close(t1, g1, 0.0)                       # inputs untouched
    for got, want in ((td1, rd1), (td2, rd2)):
        assert all(a.dtype == getattr(torch, dtype)
                   for a, _ in pairs(got, want))
        assert_close(got, want)
    for got, want, g in ((tr1, rr1, g1), (tr2, rr2, g2)):
        for (a, b), (_, gl) in zip(pairs(got, want), pairs(got, g)):
            assert a.dtype == torch.float32
            err = np.max(np.abs(a.double().numpy() - np.asarray(b)))
            assert err <= TOL * np.max(np.abs(gl))


def test_int8_scale_is_one_per_leaf():
    """A stacked leaf shares one scale over its layers: the small layer
    quantizes on the large one's grid."""
    g = torch.stack([torch.full((4,), 100.0), torch.full((4,), 0.3)])
    q, s = int8_compress(g)
    assert s.shape == () and q.dtype == torch.int8
    assert float(s) == pytest.approx(100.0 / 127.0, rel=1e-6)
    assert torch.equal(q[1], torch.zeros(4, dtype=torch.int8))
    back = int8_decompress(q, s, torch.bfloat16)
    assert back.dtype == torch.bfloat16 and float(back[0, 0]) == 100.0


# --------------------------------------------------------------------------
# the reference's oracles (tests/test_substrates.py) on the port
# --------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt = adamw_update(grads, opt, params, lr=0.05,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_clip_global_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-3)
    assert float(gn) == pytest.approx(100.0 * np.sqrt(10), rel=1e-3)


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(lr(torch.tensor(10, dtype=torch.int32))) == pytest.approx(
        1e-3, rel=1e-2)
    assert float(lr(torch.tensor(100, dtype=torch.int32))) < 1e-5


def test_int8_compression_error_feedback():
    g = {"w": torch.randn(256, generator=torch.Generator().manual_seed(0))}
    deq, resid = compress_decompress(g)
    err1 = float((deq["w"] - g["w"]).abs().max())
    assert err1 < 0.05                       # 8-bit quantization error
    # error feedback: residual carries the lost mass
    deq2, _ = compress_decompress(g, resid)
    two_step = (deq["w"] + deq2["w"]) / 2
    assert float((two_step - g["w"]).abs().max()) < err1 + 1e-6


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(8, dtype=torch.float32),
            "b": {"c": torch.ones((2, 2))}}
    for step in (1, 2, 3):
        mgr.save(step, tree, blocking=True)
    assert mgr.all_steps() == [2, 3]          # retention GC
    out = mgr.restore(tree)
    assert torch.equal(out["a"], torch.arange(8, dtype=torch.float32))
    assert list(out) == ["a", "b"] and torch.equal(out["b"]["c"],
                                                   torch.ones((2, 2)))


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.zeros((128, 128))}
    mgr.save(5, tree, blocking=False)
    tree["w"].add_(1.0)        # the caller may write its tensors at once
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(tree)["w"], torch.zeros((128, 128)))


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)}, blocking=True)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)}, blocking=True)
    with pytest.raises(ValueError, match="another tree"):
        mgr.restore({"v": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": 0})


def test_preemption_handler_saves_once_requested():
    saved = []
    pre = PreemptionHandler(lambda: saved.append(1))
    assert not pre.checkpoint_if_preempted() and not saved
    pre._handler(None, None)
    assert pre.preempted and pre.checkpoint_if_preempted() and saved == [1]


# --------------------------------------------------------------------------
# either package restores the other's checkpoint
# --------------------------------------------------------------------------

def opt_tree(dtype):
    """{"params": p, "opt": AdamW state after one step}, as the train CLI
    saves it."""
    p = make_tree(11, dtype)
    g = make_tree(12, dtype, 0.1)
    rp, rs = radamw_update(to_jax(g, dtype), radamw_init(to_jax(p, dtype)),
                           to_jax(p, dtype), lr=1e-2)
    tp = to_torch(p, dtype)
    _, ts = adamw_update(to_torch(g, dtype), adamw_init(tp), tp, lr=1e-2)
    return {"params": rp, "opt": rs}, {"params": tp, "opt": ts}


def manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_package_restore_both_ways(tmp_path, dtype):
    rtree, ttree = opt_tree(dtype)
    rdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    RManager(rdir).save(4, rtree, blocking=True)
    CheckpointManager(tdir).save(4, ttree, blocking=True)
    mr, mt = manifest(rdir, 4), manifest(tdir, 4)
    assert mt == mr
    assert "opt/.step" in mt["names"] and "opt/.m/blocks/bq" in mt["names"]
    with np.load(os.path.join(rdir, "step_00000004", "arrays.npz")) as zr, \
            np.load(os.path.join(tdir, "step_00000004", "arrays.npz")) as zt:
        assert sorted(zr.files) == sorted(zt.files)
        assert all(zr[k].dtype == zt[k].dtype for k in zr.files)

    # the reference's checkpoint in the port
    got = CheckpointManager(rdir).restore(ttree, device="cpu")
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 1
    assert got["opt"].step.shape == ()
    assert all(a.dtype == getattr(torch, dtype)
               for a, _ in pairs(got["params"], rtree["params"]))
    assert_close(got["params"], rtree["params"], 0.0)
    assert_close(got["opt"].m, rtree["opt"].m, 0.0)
    assert_close(got["opt"].v, rtree["opt"].v, 0.0)

    # the port's checkpoint in the reference
    back = RManager(tdir).restore(rtree)
    assert str(np.asarray(jax.tree.leaves(back["params"])[0]).dtype) == dtype
    assert int(back["opt"].step) == 1
    for a, b in ((back["params"], ttree["params"]),
                 (back["opt"].m, ttree["opt"].m),
                 (back["opt"].v, ttree["opt"].v)):
        assert_close(b, a, 0.0)
