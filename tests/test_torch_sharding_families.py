"""The sharded steps of the other SMOKE families against the single-device
port, and the sharded optimizer, collectives and elastic checkpoints.

The port runs as 4 gloo processes on the CPU, a 2 x 2 (data, model) mesh
(`tests/torch_sharding_worker.py`), on seeded float32 weights; this
process runs the same weights and batch with `ctx=None`. zamba2 (hybrid:
mamba blocks and a windowed shared attention block), xLSTM (mLSTM state
sharded over `model` in the cache), whisper (encoder-decoder, cross
attention), internvl2 (patches prepended), granite-moe (the local MoE
path under a mesh: the global batch's tokens dispatched together) and
glm4: `loss_fn(ctx)`, one `train_step(ctx)`, a prefill and two decode
steps. Tolerances: loss and gradient norm 1e-5 relative; parameters as
`tests/test_torch_sharding.py` (1e-4 where the gradient is at least 1e-6,
2 lr elsewhere); logits 1e-5 of their largest magnitude; tokens equal.
The unit checks: the sharded global norm and int8 scales equal the whole
tree's exactly (integer-valued squares; a replicated leaf counted once),
the collectives' adjoints, `melt_batch`, and a checkpoint saved from a
(data,) mesh of 4 restored on a 2 x 2 mesh as ("model", "data"), and
whole by the port and by the reference."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_sharding_worker as tw
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.models.zoo import ModelBundle

LR = 1e-2
FAMILIES = ["zamba2-7b", "xlstm-1.3b", "whisper-base", "internvl2-1b",
            "granite-moe-3b-a800m", "glm4-9b"]
GEN = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("families"))
    cases = [tw.write_inputs(dict(name=a, arch=a, B=4, L=32, gen=GEN,
                                  lr=LR), d) for a in FAMILIES]
    cases.append(dict(name="units", kind="units",
                      ckpt_dir=os.path.join(d, "ckpt")))
    port = tw.launch(cases, d)
    try:
        local = {c["name"]: single_device(c) for c in cases
                 if c.get("kind") != "units"}
        out, _ = port.communicate(timeout=600)
    finally:
        if port.poll() is None:
            port.kill()
    assert port.returncode == 0, out[-4000:]
    got = {c["name"]: np.load(os.path.join(d, c["name"] + ".npz"))
           for c in cases}
    return got, local, d


def single_device(case):
    """The worker's outputs with ctx=None, in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tw.case_config(case)
        bundle = ModelBundle(cfg)
        tree = tw.load_tree(cfg, case["weights"])
        with np.load(case["batch"]) as z:
            batch = {k: torch.from_numpy(z[k].copy()) for k in z.files}
        from repro_torch.models.transformer import LanguageModel
        from repro_torch.models.zoo import value_and_grad
        out = {}
        model = LanguageModel(cfg, tw.load_tree(cfg, case["weights"]))
        out["loss_fn"] = float(bundle.loss_fn(None)(model, batch))
        _, grads = value_and_grad(model, batch)
        out["grads"] = {n_: g.numpy().copy()
                        for n_, g in flatten_with_paths(grads)}
        opt = bundle.opt_init(model)
        model, opt, m = bundle.train_step(None, lr=LR)(model, opt, batch)
        out["loss"], out["grad_norm"] = float(m["loss"]), float(
            m["grad_norm"])
        out["params"] = {n_: t.numpy() for n_, t in
                         flatten_with_paths(model.tree)}
        model = LanguageModel(cfg, tree)
        pre = {k: v for k, v in batch.items()
               if k not in ("labels", "loss_mask")}
        with torch.no_grad():
            logits, cache = bundle.prefill(model, pre)
            out["prefill_logits"] = logits.numpy()
            L = pre["tokens"].shape[1] + (cfg.frontend_tokens
                                          if cfg.family == "vlm" else 0)
            cache = tw.grown(cfg, cache, GEN)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
                torch.int32)
            dl, toks = [], []
            for i in range(GEN):
                logits, cache = bundle.decode(model, cache, tok, L + i)
                dl.append(logits.numpy())
                tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
                    torch.int32)
                toks.append(tok.numpy()[:, 0])
        out["decode_logits"] = np.stack(dl)
        out["tokens"] = np.stack(toks)
        return out
    finally:
        torch.set_num_threads(n)


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_loss_and_step_match_the_single_device_port(runs, arch):
    got, local, _ = runs
    g, ref = got[arch], local[arch]
    assert rel(g["loss_fn"], ref["loss_fn"]) < 1e-5
    assert rel(g["loss"], ref["loss"]) < 1e-5
    assert rel(g["grad_norm"], ref["grad_norm"]) < 1e-5
    for name, b in ref["params"].items():
        a = g["param/" + name]
        big = np.abs(ref["grads"][name]) >= 1e-6
        scale = np.abs(b).max()
        assert np.abs(a - b)[big].max(initial=0) <= 1e-4 * scale, name
        assert np.abs(a - b)[~big].max(initial=0) <= 2 * LR, name


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_and_decode_match_the_single_device_port(runs, arch):
    got, local, _ = runs
    g, ref = got[arch], local[arch]
    for key in ("prefill_logits", "decode_logits"):
        scale = np.abs(ref[key]).max()
        assert np.abs(g[key] - ref[key]).max() <= 1e-5 * scale, key
    np.testing.assert_array_equal(g["tokens"], ref["tokens"])


def test_sharded_global_norm_and_int8_scale_equal_the_whole_trees(runs):
    u = runs[0]["units"]
    assert float(u["norm2_sharded"]) == float(u["norm2_whole"])
    assert float(u["gnorm_sharded"]) == float(u["gnorm_whole"])
    assert bool(u["int8_a"]) and bool(u["int8_d"]) and bool(u["int8_res_a"])


def test_collectives_adjoints_and_melt_batch(runs):
    u = runs[0]["units"]
    assert float(u["ag_adjoint"]) == 0.0
    assert list(u["a2a_shape"]) == [1, 16]
    # rank 0 holds row 0 of every process's block, in block order
    np.testing.assert_array_equal(
        u["a2a_value"], np.arange(4.)[None].repeat(4, 0).ravel()[None]
        + np.repeat(100. * np.arange(4), 4)[None])
    assert bool(u["a2a_roundtrip"]) and bool(u["a2a_grad"])
    np.testing.assert_array_equal(u["melt_rows"], [0, 1])
    assert bool(u["melt_none"])


def test_elastic_restore_across_mesh_shapes(runs):
    """The CPU twin of `tests/test_sharding.py::
    test_elastic_restore_across_mesh_shapes`: saved from (data,) x 4,
    restored on 2 x 2 as ("model", "data"); the saved checkpoint restores
    whole in the port and in the reference."""
    got, _, d = runs
    u = got["units"]
    assert list(u["elastic_local_shape"]) == [4, 4]
    assert bool(u["elastic_equal"])
    from repro.checkpoint import CheckpointManager as RManager
    from repro_torch.checkpoint import CheckpointManager
    arr = np.arange(64, dtype=np.float32).reshape(8, 8)
    ck = os.path.join(d, "ckpt")
    whole = CheckpointManager(ck).restore({"w": torch.zeros(8, 8)})
    np.testing.assert_array_equal(whole["w"].numpy(), arr)
    ref = RManager(ck).restore({"w": np.zeros((8, 8), np.float32)})
    np.testing.assert_array_equal(np.asarray(ref["w"]), arr)


def test_train_cli_on_a_2x2_world_equals_the_single_process_run(tmp_path):
    """`launch/train.py --tp 2` under a 4-process launch: the same losses
    as the single process on the same seed (1e-5). The SMOKE config is
    bfloat16, whose gradients the world sums in another order: the
    gradient norms agree to bfloat16's rounding (3e-3), and the final
    checkpoint's leaves to 2e-2 of each leaf's largest magnitude or, for
    a parameter, to AdamW's bound of 2 lr a step (a near-zero bfloat16
    gradient's sign decides a move of lr, `tests/test_torch_train.py`)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(tw.ROOT, "src"))
    args = ["-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b",
            "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "32", "--ckpt-every", "0", "--log-every", "1"]
    runs_ = {}
    for name, pre in (("world", ["-m", "repro_torch.launch.spawn",
                                 "--nprocs", "4", "--timeout", "300", "--"]),
                      ("single", [])):
        ck = str(tmp_path / name)
        met = str(tmp_path / f"{name}.json")
        out = subprocess.run([sys.executable] + pre + args + [
            "--tp", "2", "--ckpt-dir", ck, "--metrics", met],
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "done." in out.stdout
        with open(met) as f:
            runs_[name] = json.load(f)
        runs_[name]["stdout"] = out.stdout
        runs_[name]["ck"] = ck
    assert "mesh {'data': 2, 'model': 2} on gloo" in runs_["world"]["stdout"]
    assert runs_["world"]["stdout"].count("done.") == 1     # rank 0 alone
    for k, tol in (("losses", 1e-5), ("grad_norms", 3e-3)):
        assert len(runs_["world"][k]) == len(runs_["single"][k]) == 3
        for a, b in zip(runs_["world"][k], runs_["single"][k]):
            assert abs(a - b) <= tol * abs(b), (k, a, b)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.zoo import get_bundle, params_tree
    bundle = get_bundle("qwen2-1.5b", smoke=True)
    model = bundle.init(torch.Generator().manual_seed(0))
    like = {"params": params_tree(model), "opt": bundle.opt_init(model)}
    w = CheckpointManager(runs_["world"]["ck"]).restore(like)
    s = CheckpointManager(runs_["single"]["ck"]).restore(like)
    for (n, a), (_, b) in zip(flatten_with_paths(w), flatten_with_paths(s)):
        a, b = a.float(), b.float()
        bound = 2e-2 * float(b.abs().max())
        if n.startswith("params/"):
            bound = max(bound, 2 * 3e-3 * 3)      # 2 lr a step, 3 steps
        assert float((a - b).abs().max()) <= bound, n


def test_a_world_of_one_equals_one_device(tmp_path):
    """A 1 x 1 gloo mesh in this process: the sharded steps take the
    single-device code paths, so a bfloat16 train step, a prefill and a
    decode step equal `ctx=None`'s bit for bit."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_mesh_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.zoo import params_tree
    bundle = ModelBundle(get_config("qwen2-1.5b", smoke=True))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 512, (2, 32)).astype(np.int64))
    batch = {"tokens": x, "labels": x.roll(1, 1)}
    mesh = make_host_mesh(2, backend="gloo", rank=0, world_size=1,
                          init_method="file://" + str(tmp_path / "store"))
    try:
        assert mesh.shape == {"data": 1, "model": 1}    # tp clamped to 1
        ctx = make_mesh_ctx(mesh)
        out = {}
        for name, c in (("one", None), ("mesh", ctx)):
            model = bundle.init(torch.Generator().manual_seed(0), c)
            opt = bundle.opt_init(model)
            _, opt, m = bundle.train_step(c, lr=1e-3)(model, opt, batch)
            logits, cache = bundle.prefill_step(c)(model, {"tokens": x})
            nxt, _ = bundle.decode_step(c)(model, cache, x[:, :1], 31)
            out[name] = (m, params_tree(model), logits, nxt)
    finally:
        dist.destroy_process_group()
    (m1, p1, l1, n1), (m2, p2, l2, n2) = out["one"], out["mesh"]
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for (n, a), (_, b) in zip(flatten_with_paths(p1), flatten_with_paths(p2)):
        assert torch.equal(a, b), n
    assert torch.equal(l1, l2) and torch.equal(n1, n2)
