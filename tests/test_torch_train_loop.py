"""The port's training path beyond one float32 step: gradient
accumulation (`accum=2`) and bfloat16 against the reference's jitted
step, the SSM stacks across chunks, remat changing memory and not
numbers, the loss falling over 30 steps and a checkpoint restart that
replays exactly (the reference's `tests/test_system.py` on the port).

Tolerances: accumulation as `tests/test_torch_train.py` (1e-4); bfloat16
loss, gradient norm and moments 3e-2 (bfloat16 gradients)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.models.attention as tattn
import repro_torch.models.common as tcommon
import repro_torch.models.ssm as tssm
import repro_torch.models.transformer as ttr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models.params import tree_map
from repro_torch.models.zoo import ModelBundle as TBundle
from repro_torch.models.zoo import params_tree, value_and_grad
from test_torch_train import (check_step, one_thread, paired,  # noqa: F401
                              port_step, reference_step, rel)

BF16_TOL = 3e-2


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_accumulated_step_matches_reference(arch):
    ref = reference_step(arch, accum=2)
    model, opt, metrics = port_step(arch, ref, accum=2)
    check_step(model, opt, metrics, ref)


def test_bfloat16_step_matches_reference():
    ref = reference_step("qwen2-1.5b", "bfloat16")
    model, opt, metrics = port_step("qwen2-1.5b", ref, "bfloat16")
    assert abs(float(metrics["loss"]) - ref["loss"]) <= BF16_TOL * ref["loss"]
    assert abs(float(metrics["grad_norm"]) - ref["gnorm"]) \
        <= BF16_TOL * ref["gnorm"]
    # the second moment is the gradient's square: twice its error
    for tree, want, tol in ((opt.m, ref["m"], BF16_TOL),
                            (opt.v, ref["v"], 2 * BF16_TOL)):
        for a, b in paired(tree, want):
            assert a.dtype == torch.float32 and rel(a, b) <= tol
    for a, _ in paired(params_tree(model), ref["p2"]):
        assert a.dtype == torch.bfloat16


def test_ssm_step_across_chunks():
    """xLSTM at 256 tokens: two mLSTM chunks of 128 (the reference's
    chunked scan needs L <= 128 or L % 128 == 0)."""
    ref = reference_step("xlstm-1.3b", seq=256)
    model, opt, metrics = port_step("xlstm-1.3b", ref)
    check_step(model, opt, metrics, ref)


def test_mamba_gradient_is_nan_at_a_full_chunk_as_in_the_reference():
    """zamba2 at 128 tokens: one full SSD chunk. The reference's
    upper-triangle exp(cums_i - cums_j) overflows; its where() hides it
    from the loss, not from the backward (0 x inf), so the gradient norm
    and every updated parameter are NaN. The port copies the fault."""
    ref = reference_step("zamba2-7b", seq=128)
    model, opt, metrics = port_step("zamba2-7b", ref)
    assert abs(float(metrics["loss"]) - ref["loss"]) <= 1e-4 * ref["loss"]
    assert np.isnan(ref["gnorm"]) and np.isnan(float(metrics["grad_norm"]))
    for a, b in paired(params_tree(model), ref["p2"]):
        np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(b))


def test_remat_changes_memory_not_numbers(monkeypatch):
    """The same loss, bit for bit, and the same gradients within 1e-6
    (the backward may add a leaf's contributions in another order: xLSTM's
    recurrent weight takes one a token) with every remat a plain call, on
    families that reach each site: attention chunks (300 tokens), SSM
    chunks, cross-entropy chunks, blocks, groups, an encoder-decoder."""
    bundle_inputs = {}
    for arch, seq in (("qwen2-1.5b", 300), ("zamba2-7b", 40),
                      ("xlstm-1.3b", 256), ("whisper-base", 40)):
        cfg = dataclasses.replace(tget(arch, smoke=True),
                                  param_dtype="float32")
        bundle = TBundle(cfg)
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                         (2, seq))),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                         (2, seq)))}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, seq, cfg.d_model)).astype(np.float32))
        bundle_inputs[arch] = (bundle, batch)
    runs = {}
    for plain in (False, True):
        if plain:
            for mod in (tattn, tcommon, tssm, ttr):
                monkeypatch.setattr(mod, "remat",
                                    lambda fn, *a, **kw: fn(*a, **kw))
        for arch, (bundle, batch) in bundle_inputs.items():
            model = bundle.init(torch.Generator().manual_seed(0))
            runs[arch, plain] = value_and_grad(model, batch)
    for arch in bundle_inputs:
        (l1, g1), (l2, g2) = runs[arch, False], runs[arch, True]
        assert torch.equal(l1, l2)
        for a, b in paired(g1, g2):
            assert rel(a, b.numpy()) <= 1e-6


def test_accumulation_needs_whole_microbatches():
    bundle = TBundle(tget("qwen2-1.5b", smoke=True))
    model = bundle.init(torch.Generator().manual_seed(0))
    x = torch.zeros((3, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="microbatches"):
        value_and_grad(model, {"tokens": x, "labels": x}, accum=2)


def test_a_mesh_context_waits_for_the_sharding_slice():
    """A step under a mesh context runs only on a model sharded on that
    context's mesh (`ModelBundle.shard`): a whole model is refused, never
    run on one device quietly."""
    from repro_torch.dist.sharding import Mesh, make_mesh_ctx
    bundle = TBundle(tget("qwen2-1.5b", smoke=True))
    model = bundle.init(torch.Generator().manual_seed(0))
    ctx = make_mesh_ctx(Mesh((2, 2), ("data", "model")))
    x = torch.zeros((2, 8), dtype=torch.int64)
    batch = {"tokens": x, "labels": x}
    opt = bundle.opt_init(model)
    for call in (lambda: bundle.loss_fn(ctx)(model, batch),
                 lambda: bundle.train_step(ctx, lr=1e-3)(model, opt, batch),
                 lambda: bundle.prefill_step(ctx)(model, {"tokens": x})):
        with pytest.raises(ValueError, match="not sharded"):
            call()


# --------------------------------------------------------------------------
# the reference's end-to-end training checks on the port
# --------------------------------------------------------------------------

def _tiny_bundle():
    cfg = dataclasses.replace(tget("qwen2-1.5b", smoke=True),
                              layers=2, d_model=64, heads=4, kv_heads=2,
                              d_ff=128, vocab=256)
    return TBundle(cfg)


def _batch(ds, i):
    return {k: torch.from_numpy(v) for k, v in ds.global_batch_at(i).items()}


def test_training_reduces_loss():
    b = _tiny_bundle()
    model = b.init(torch.Generator().manual_seed(0))
    opt = b.opt_init(model)
    step = b.train_step(lr=5e-3)
    ds = SyntheticLMDataset(DataConfig(vocab=b.cfg.vocab, seq_len=64,
                                       global_batch=8, seed=1))
    losses = []
    for i in range(30):
        model, opt, m = step(model, opt, _batch(ds, i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_checkpoint_restart_exact(tmp_path):
    b = _tiny_bundle()
    model = b.init(torch.Generator().manual_seed(0))
    opt = b.opt_init(model)
    step = b.train_step(lr=1e-3)
    ds = SyntheticLMDataset(DataConfig(vocab=b.cfg.vocab, seq_len=32,
                                       global_batch=4, seed=2))
    mgr = CheckpointManager(str(tmp_path))
    for i in range(6):
        if i == 3:       # async: the step below writes the tensors at once
            mgr.save(3, {"p": params_tree(model), "o": opt})
        model, opt, _ = step(model, opt, _batch(ds, i))
    want = tree_map(torch.clone, params_tree(model))

    # restart from step 3 into fresh weights, replay the same stream
    model2 = b.init(torch.Generator().manual_seed(5))
    state = mgr.restore({"p": params_tree(model2), "o": b.opt_init(model2)})
    params_tree(model2, state["p"])
    opt2 = state["o"]
    assert opt2.step.shape == () and int(opt2.step) == 3
    for i in range(3, 6):
        model2, opt2, _ = step(model2, opt2, _batch(ds, i))
    for a, b_ in paired(params_tree(model2), want):
        assert torch.equal(a, b_)
    assert torch.equal(opt2.step, opt.step)
    assert torch.equal(opt2.m["embed"], opt.m["embed"])
