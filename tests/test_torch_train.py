"""One training step of the port (`ModelBundle.train_step`: the loss, its
gradients through the remat'd stacks, global-norm clipping, AdamW)
against the reference's jitted `train_step(None, lr=1e-2)` on all 10
SMOKE architectures in float32, the reference's own initial weights
carried across by `params_from_reference`, on the same seeded batch.

Tolerances (relative to the reference's value, or to a leaf's largest
magnitude): loss and gradient norm 1e-4; both AdamW moments 1e-4; the
updated parameters 1e-4 wherever the reference's clipped gradient is at
least 1e-6. AdamW's first step moves a parameter by lr * g / (|g| + 1e-8),
which turns the float32 rounding of a gradient near 1e-8 into any move in
[-lr, lr]; there the parameters are held to the bound 2 lr, which every
update keeps. (`tests/test_torch_train_loop.py` holds accumulation,
bfloat16, longer sequences, loss reduction and a restart.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import list_archs as rlist
from repro.models.zoo import ModelBundle as RBundle
from repro.optim import adamw_init as radamw_init
from repro_torch.configs import get_config as tget
from repro_torch.models.params import params_from_reference
from repro_torch.models.zoo import ModelBundle as TBundle
from repro_torch.models.zoo import params_tree
from repro_torch.optim import AdamWState

ARCHS = rlist()
B, L = 2, 40
LR = 1e-2
TOL = 1e-4
B1, EPS = 0.9, 1e-8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the smoke-sized models: the suite runs
    several workers on the same cores, and small ops spread over all of
    them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(cfg, seq=L, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
           "loss_mask": (rng.random((B, seq)) < 0.9).astype(np.float32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def paired(port, ref):
    if isinstance(port, dict):
        assert set(port) == set(ref)
        return [p for k in port for p in paired(port[k], ref[k])]
    return [(port, ref)]


def rel(port, ref) -> float:
    a = port.detach().to(torch.float64).numpy()
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-30))


def reference_step(arch, dtype="float32", *, seq=L, accum=1):
    """The reference's initial weights, batch and one jitted train step,
    as numpy float32 trees."""
    cfg = dataclasses.replace(rget(arch, smoke=True), param_dtype=dtype)
    rb = RBundle(cfg)
    params = rb.init(jax.random.PRNGKey(0))
    x = inputs(cfg, seq)
    batch = {k: (jnp.asarray(v) if v.dtype == np.int32
                 else jnp.asarray(v, jnp.dtype(dtype))) for k, v in x.items()}
    p2, o2, m = jax.jit(rb.train_step(None, lr=LR, accum=accum))(
        params, radamw_init(params), batch)
    return dict(params=np32(params), x=x, p2=np32(p2), m=np32(o2.m),
                v=np32(o2.v), step=int(o2.step), loss=float(m["loss"]),
                gnorm=float(m["grad_norm"]))


def port_step(arch, ref, dtype="float32", *, accum=1):
    cfg = dataclasses.replace(tget(arch, smoke=True), param_dtype=dtype)
    bundle = TBundle(cfg)
    model = params_from_reference(cfg, ref["params"], device="cpu")
    batch = {k: (torch.from_numpy(v) if v.dtype == np.int32
                 else torch.from_numpy(v).to(getattr(torch, dtype)))
             for k, v in ref["x"].items()}
    out, opt, metrics = bundle.train_step(lr=LR, accum=accum)(
        model, bundle.opt_init(model), batch)
    assert out is model
    return model, opt, metrics


def check_params(port, ref, ref_m, tol=TOL):
    """The updated parameters against the reference's (see the module
    docstring): within `tol` of the leaf's largest magnitude where the
    reference's clipped gradient (its first moment / (1 - b1)) is at
    least 100 eps, within 2 lr elsewhere."""
    for (a, b), (_, m) in zip(paired(port, ref), paired(port, ref_m)):
        err = np.abs(a.detach().double().numpy() - np.asarray(b, np.float64))
        sure = np.abs(np.asarray(m, np.float64)) / (1 - B1) >= 100 * EPS
        scale = max(np.max(np.abs(b)), 1e-30)
        assert np.max(err[sure], initial=0.0) <= tol * scale
        assert np.max(err[~sure], initial=0.0) <= 2 * LR


def check_step(model, opt, metrics, ref, tol=TOL):
    assert abs(float(metrics["loss"]) - ref["loss"]) <= tol * abs(ref["loss"])
    assert abs(float(metrics["grad_norm"]) - ref["gnorm"]) \
        <= tol * ref["gnorm"]
    assert isinstance(opt, AdamWState)
    assert opt.step.dtype == torch.int32 and int(opt.step) == ref["step"]
    for tree, want in ((opt.m, ref["m"]), (opt.v, ref["v"])):
        for a, b in paired(tree, want):
            assert a.dtype == torch.float32 and rel(a, b) <= tol
    check_params(params_tree(model), ref["p2"], ref["m"], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    ref = reference_step(arch)
    model, opt, metrics = port_step(arch, ref)
    check_step(model, opt, metrics, ref)
    tree = params_tree(model)
    # every leaf moved (weight decay moves even a zero-gradient leaf)
    for a, b in paired(tree, ref["params"]):
        assert not np.array_equal(a.numpy(), b)
    # the blocks' parameters still view the stacked leaves, and take no
    # gradient outside the step
    leaves = {a.untyped_storage().data_ptr() for a, _ in paired(tree, tree)}
    for p in model.parameters():
        assert p.untyped_storage().data_ptr() in leaves
        assert not p.requires_grad and p.grad is None
