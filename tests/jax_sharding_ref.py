"""The reference's sharded steps for `tests/test_torch_sharding*.py`: run
in a fresh process with 4 forced host devices (the device count locks at
jax's first use).

  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python tests/jax_sharding_ref.py CASES.json OUT_DIR

The cases are `tests/torch_sharding_worker.py`'s. The mesh is built with
`AxisType.Auto` axes: under jax 0.9 `jax.make_mesh` defaults to
`Explicit` axes, where `with_sharding_constraint` acts as an assert
(which is why `tests/test_sharding.py`'s two sharded tests fail there);
with `Auto` axes the reference's sharded step runs unchanged. Writes
OUT_DIR/<name>_ref.npz with the same keys as the worker; a case with
"local_control" also holds the reference's local path (`ctx=None`) on
the same inputs under "local/".
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import get_config
from repro.dist.sharding import make_mesh_ctx
from repro.models.zoo import ModelBundle
from repro.optim import adamw_init


def run_case(case, out_dir):
    cfg = get_config(case["arch"], smoke=True)
    cfg = dataclasses.replace(cfg, param_dtype=case.get("dtype", "float32"),
                              sp_mode=case.get("sp_mode", "megatron"))
    bundle = ModelBundle(cfg)
    names, _, treedef = _flatten_with_paths(bundle.param_sds())
    with np.load(case["weights"]) as z:
        dt = jnp.dtype(cfg.param_dtype)
        sds = jax.tree.leaves(bundle.param_sds())
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[n]).astype(s.dtype)
                      for n, s in zip(names, sds)])
    with np.load(case["batch"]) as z:
        batch = {k: jnp.asarray(z[k]) for k in z.files}
    for k in ("frames", "patches"):
        if k in batch:
            batch[k] = batch[k].astype(dt)
    dp, tp = case.get("mesh", (2, 2))
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = make_mesh_ctx(mesh)
    out = {}
    with jax.set_mesh(mesh):
        if case.get("train", True):
            out["loss_fn"] = float(jax.jit(bundle.loss_fn(ctx))(params, batch))
            step = jax.jit(bundle.train_step(ctx, lr=case.get("lr", 1e-2),
                                             accum=case.get("accum", 1)))
            new, _, m = step(params, adamw_init(params), batch)
            out["loss"] = float(m["loss"])
            out["grad_norm"] = float(m["grad_norm"])
            # the step's gradient: the mean of the microbatches' (accum)
            gfn = jax.jit(jax.grad(bundle.loss_fn(ctx)))
            n = case.get("accum", 1)
            mb = batch["tokens"].shape[0] // n
            parts = [gfn(params, {k: v[i * mb:(i + 1) * mb]
                                  for k, v in batch.items()})
                     for i in range(n)]
            grads = jax.tree.map(lambda *g: sum(g) / n, *parts)
            for n, v, g in zip(names, jax.tree.leaves(new),
                               jax.tree.leaves(grads)):
                out["param/" + n] = np.asarray(v, np.float32)
                out["grad/" + n] = np.asarray(g, np.float32)
            if case.get("local_control"):
                # the local path on the same inputs (ctx=None: one
                # dispatch over the whole batch's tokens)
                out["local/loss_fn"] = float(
                    jax.jit(bundle.loss_fn(None))(params, batch))
                lstep = jax.jit(bundle.train_step(None,
                                                  lr=case.get("lr", 1e-2)))
                lnew, _, lm = lstep(params, adamw_init(params), batch)
                out["local/loss"] = float(lm["loss"])
                out["local/grad_norm"] = float(lm["grad_norm"])
                for n, v in zip(names, jax.tree.leaves(lnew)):
                    out["local/param/" + n] = np.asarray(v, np.float32)
        gen = case.get("gen", 0)
        if gen:
            pre = {k: v for k, v in batch.items()
                   if k not in ("labels", "loss_mask")}
            logits, cache = jax.jit(bundle.prefill_step(ctx))(params, pre)
            out["prefill_logits"] = np.asarray(logits, np.float32)
            L = pre["tokens"].shape[1]
            if cfg.family in ("dense", "moe", "vlm") and not cfg.attn_window:
                pad = ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))
                cache = jax.tree.map(lambda t: jnp.pad(t, pad), cache)
            dec = jax.jit(bundle.decode_step(ctx))
            tok = jnp.argmax(logits[:, :cfg.vocab], -1)[:, None].astype(
                jnp.int32)
            toks, dl = [], []
            for i in range(gen):
                logits, cache = dec(params, cache, tok, L + i)
                dl.append(np.asarray(logits, np.float32))
                tok = jnp.argmax(logits[:, :cfg.vocab], -1)[:, None].astype(
                    jnp.int32)
                toks.append(np.asarray(tok)[:, 0])
            out["decode_logits"] = np.stack(dl)
            out["tokens"] = np.stack(toks)
    np.savez(os.path.join(out_dir, case["name"] + "_ref.npz"), **out)


def main():
    with open(sys.argv[1]) as f:
        cases = json.load(f)
    for case in cases:
        run_case(case, sys.argv[2])


if __name__ == "__main__":
    main()
