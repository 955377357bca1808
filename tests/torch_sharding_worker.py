"""One rank of the sharded parity runs in `tests/test_torch_sharding*.py`.

Run as a world by `repro_torch.launch.spawn` (gloo on the CPU):

  python -m repro_torch.launch.spawn --nprocs 4 -- \\
      tests/torch_sharding_worker.py CASES.json OUT_DIR

CASES.json is a list of cases: {"name", "arch", "mesh": [dp, tp],
"dtype", "sp_mode", "weights": an npz of the whole parameter tree by
checkpoint names, "batch": an npz of the global batch, "lr", "accum",
"train": bool, "gen": decode steps after a prefill (0: none),
"serve": bool}. Rank 0 writes OUT_DIR/<name>.npz: the loss, the gradient
norm and the whole updated parameters of one `train_step(ctx)`, the
prefill logits and each decode step's logits and greedy tokens, and the
collective counts of the rank.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.checkpoint.manager import flatten_with_paths, unflatten_like
from repro_torch.configs import get_config
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import make_mesh_ctx
from repro_torch.launch.mesh import bind_mesh, init_world
from repro_torch.launch.spawn import world_from_env
from repro_torch.models.params import from_numpy_tree, torch_dtype
from repro_torch.models.transformer import model_defs
from repro_torch.models.zoo import ModelBundle


def load_tree(cfg, path):
    defs = model_defs(cfg)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    names = [n for n, _ in flatten_with_paths(defs)]
    tree = unflatten_like(defs, iter(arrays[n] for n in names))
    return from_numpy_tree(defs, tree, "cpu")


def run_case(case, mesh, out_dir):
    cfg = case_config(case)
    bundle = ModelBundle(cfg)
    ctx = make_mesh_ctx(mesh)
    tree = load_tree(cfg, case["weights"])
    with np.load(case["batch"]) as z:
        batch = {k: torch.from_numpy(z[k].copy()) for k in z.files}
    dt = torch_dtype(cfg.param_dtype)
    for k in ("frames", "patches"):
        if k in batch:
            batch[k] = batch[k].to(dt)
    out = {}
    col.stats(mesh).reset()
    if case.get("train", True):
        model = bundle.shard(tree, ctx)
        out["loss_fn"] = float(bundle.loss_fn(ctx)(model, batch))
        opt = bundle.opt_init(model)
        step = bundle.train_step(ctx, lr=case.get("lr", 1e-2),
                                 accum=case.get("accum", 1))
        model, opt, m = step(model, opt, batch)
        out["loss"] = float(m["loss"])
        out["grad_norm"] = float(m["grad_norm"])
        whole = bundle.unshard(model)
        for n, t in flatten_with_paths(whole):
            out["param/" + n] = t.to(torch.float32).numpy()
    if case.get("gen", 0):
        model = bundle.shard(tree, ctx, serve=case.get("serve", False))
        pre = {k: v for k, v in batch.items() if k != "labels"
               and k != "loss_mask"}
        logits, cache = bundle.prefill_step(ctx)(model, pre)
        out["prefill_logits"] = logits.numpy()
        L = pre["tokens"].shape[1] + (cfg.frontend_tokens
                                      if cfg.family == "vlm" else 0)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(torch.int32)
        cache = grow(bundle, cfg, ctx, cache, pre["tokens"].shape[0], L,
                     case["gen"])
        toks, dl = [], []
        for i in range(case["gen"]):
            logits, cache = bundle.decode_step(ctx)(model, cache, tok, L + i)
            dl.append(logits.numpy())
            tok = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].to(
                torch.int32)
            toks.append(tok.numpy()[:, 0])
        out["decode_logits"] = np.stack(dl)
        out["tokens"] = np.stack(toks)
    st = col.stats(mesh)
    out["collective_calls"] = st.calls
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, case["name"] + ".npz"), **out)


def grows(cfg):
    """Whether a prefill cache gets room for the decoded positions (a
    windowed one is a ring buffer already; the other families' decode
    writes the last slot, as the reference's)."""
    return cfg.family in ("dense", "moe", "vlm") and not cfg.attn_window


def grown(cfg, cache, gen):
    """A whole prefill cache with room for `gen` more positions."""
    if not grows(cfg):
        return cache
    return {k: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, gen))
            for k, t in cache.items()}


def grow(bundle, cfg, ctx, cache, B, L, gen):
    """`grown` for a sharded cache: through its whole leaves, into a
    sharded zero cache of length L + gen."""
    if not grows(cfg):
        return cache
    from repro_torch.models.params import gather_tree, shard_tree
    whole = grown(cfg, gather_tree(dict(cache), cache.specs, ctx.mesh), gen)
    big = bundle.init_cache(batch=B, cache_len=L + gen, device="cpu", ctx=ctx)
    local = shard_tree(whole, big.specs, ctx.mesh)
    for k in big:
        big[k].copy_(local[k])
    return big


def run_units(case, out_dir):
    """The optimizer's and the checkpoint's sharded pieces on the world of
    4: the global norm and the int8 scales of a tree sharded on a 2 x 2
    mesh against the whole tree's, the collectives' adjoints, melt_batch,
    and an elastic checkpoint saved from a (data,) mesh of 4 and restored
    on a 2 x 2 mesh with spec ("model", "data")."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.sharding import NamedSharding, P
    from repro_torch.models.params import gather_leaf, shard_tree
    from repro_torch.models.spmd import melt_batch
    from repro_torch.optim import clip_by_global_norm, compress_decompress
    from repro_torch.optim.adamw import global_sq_norm
    mesh = bind_mesh((2, 2), ("data", "model"))
    ctx = make_mesh_ctx(mesh)
    out = {}
    g = torch.Generator().manual_seed(0)
    # integer-valued gradients: every sum of squares is exact in float32
    whole = {"a": torch.randint(-50, 50, (8, 6), generator=g).float(),
             "b": torch.randint(-50, 50, (6,), generator=g).float(),
             "c": {"d": torch.randint(-9, 9, (4, 8, 2), generator=g).float()}}
    specs = {"a": P("data", "model"), "b": P(None),
             "c": {"d": P(None, "model", None)}}
    local = shard_tree(whole, specs, mesh)
    out["norm2_whole"] = float(global_sq_norm(whole))
    out["norm2_sharded"] = float(global_sq_norm(local, specs, mesh))
    _, gn = clip_by_global_norm(shard_tree(whole, specs, mesh), 1.0, specs,
                                mesh)
    out["gnorm_sharded"] = float(gn)
    _, gn1 = clip_by_global_norm({k: (v.clone() if not isinstance(v, dict)
                                      else {"d": v["d"].clone()})
                                  for k, v in whole.items()}, 1.0)
    out["gnorm_whole"] = float(gn1)
    # float gradients: the int8 round trip, leaf scales over the whole leaf
    f = {"a": torch.randn(8, 6, generator=g), "b": torch.randn(6, generator=g),
         "c": {"d": torch.randn(4, 8, 2, generator=g) * 3}}
    deq1, res1 = compress_decompress(f)
    deq, res = compress_decompress(shard_tree(f, specs, mesh), specs=specs,
                                   mesh=mesh)
    for name, sp, a, b in (("a", specs["a"], deq1["a"], deq["a"]),
                           ("d", specs["c"]["d"], deq1["c"]["d"],
                            deq["c"]["d"])):
        out["int8_" + name] = bool(torch.equal(gather_leaf(b, sp, mesh), a))
    out["int8_res_a"] = bool(torch.equal(
        gather_leaf(res["a"], specs["a"], mesh), res1["a"]))
    # adjoints: <AG(x), y> = <x, RS(y)>, and all-to-all's backward
    x = torch.randn(3, 4, generator=g).requires_grad_(True)
    y = torch.randn(6, 4, generator=g)
    ag = col.all_gather(x, mesh, "model", 0)
    (ag * y).sum().backward()
    out["ag_adjoint"] = float((x.grad - col.reduce_scatter(
        y, mesh, "model", 0)).abs().max())
    z = torch.arange(16.).reshape(4, 4) + 100 * mesh.rank
    t = col.all_to_all(z.requires_grad_(True), mesh, ("data", "model"), 0, 1)
    out["a2a_shape"] = np.array(t.shape)
    out["a2a_value"] = t.detach().numpy()
    back = col.all_to_all(t, mesh, ("data", "model"), 1, 0)
    out["a2a_roundtrip"] = bool(torch.equal(back, z))
    (t * 2).sum().backward()
    out["a2a_grad"] = bool(torch.equal(z.grad, torch.full_like(z, 2.0)))
    mb = melt_batch(torch.arange(8 * 2 * 3.).reshape(8, 2, 3), ctx)
    out["melt_rows"] = mb[:, 0, 0].numpy() / 6
    out["melt_none"] = melt_batch(torch.zeros(6, 2, 3), ctx) is None
    # elastic checkpoint
    mesh_a = bind_mesh((4,), ("data",))
    arr = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mgr = CheckpointManager(case["ckpt_dir"])
    sh_a = {"w": NamedSharding(mesh_a, P("data", None))}
    tree_a = {"w": shard_tree({"w": arr}, {"w": P("data", None)}, mesh_a)["w"]}
    mgr.save(1, tree_a, blocking=True, shardings=sh_a)
    sh_b = {"w": NamedSharding(mesh, P("model", "data"))}
    got = mgr.restore(tree_a, shardings=sh_b)["w"]
    out["elastic_local_shape"] = np.array(got.shape)
    out["elastic_equal"] = bool(torch.equal(
        gather_leaf(got, P("model", "data"), mesh), arr))
    if mesh.rank == 0:
        np.savez(os.path.join(out_dir, case["name"] + ".npz"), **out)


# ---- the test side: inputs and the launch ----------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def case_config(case):
    return dataclasses.replace(get_config(case["arch"], smoke=True),
                               param_dtype=case.get("dtype", "float32"),
                               sp_mode=case.get("sp_mode", "megatron"))


def write_inputs(case, d, seed=0):
    """Seeded numpy weights (every leaf drawn, biases and norm gains too)
    and a global batch for `case`, as npz files in `d`; returns the case
    with their paths."""
    cfg = case_config(case)
    rng = np.random.default_rng(seed)
    w = {}
    for n, pd in flatten_with_paths(model_defs(cfg)):
        z = rng.standard_normal(pd.shape)
        w[n] = (0.02 * z if pd.init == "zeros" else 1 + 0.1 * z
                if pd.init == "ones" else pd.scale * z).astype(np.float32)
    B, L = case["B"], case["L"]
    b = {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
         "loss_mask": (rng.random((B, L)) < 0.9).astype(np.float32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, L, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    case = dict(case, weights=os.path.join(d, case["name"] + "_w.npz"),
                batch=os.path.join(d, case["name"] + "_b.npz"))
    np.savez(case["weights"], **w)
    np.savez(case["batch"], **b)
    return case


def launch(cases, d, nprocs=4):
    """Start the world of `nprocs` ranks on `cases` (a Popen; the caller
    waits). One intra-op thread a rank."""
    import subprocess
    path = os.path.join(d, "cases.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.spawn", "--nprocs",
         str(nprocs), "--timeout", "300", "--",
         os.path.abspath(__file__), path, d],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    cases_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    w = world_from_env()
    init_world(backend="gloo", init_method=w["init_method"], rank=w["rank"],
               world_size=w["world_size"], timeout_s=120)
    with open(cases_path) as f:
        cases = json.load(f)
    meshes = {}
    for case in cases:
        if case.get("kind") == "units":
            run_units(case, out_dir)
            continue
        shape = tuple(case.get("mesh", (2, 2)))
        if shape not in meshes:
            meshes[shape] = bind_mesh(shape, ("data", "model"))
        run_case(case, meshes[shape], out_dir)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
