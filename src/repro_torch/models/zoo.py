"""ModelBundle: one object per architecture exposing what the launchers,
the tests and the simulation plane need (the reference's
`repro/models/zoo.py`): parameters, the loss and the training step,
prefill and decode, caches and specs, and the sharding trees.

With a mesh context (`ctx`, `dist/sharding.py`) the steps run sharded
over its bound mesh, one process per device: the model holds this
process's blocks of every leaf (`shard` or `init(ctx=...)`, cut by
`param_shardings`), and each step takes the global batch on every
process, keeps its rows (`spmd.shard_batch`) and returns global values
(the loss, the gradient norm, the logits). A train step sums each
parameter's gradient over the mesh axes it is not sharded on, clips by
the norm of the logical leaves and updates the blocks in place."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..data.pipeline import make_batch_specs
from ..dist import collectives as col
from ..dist.sharding import MeshCtx, NamedSharding, P, entry_axes
from ..optim import (AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm)
from . import decode as decode_mod
from . import params as pm
from .config import ModelConfig
from .spmd import shard_batch
from .transformer import LanguageModel, bind_grads, lm_loss, model_defs

ATTN_KEYS = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                       "x_wq", "x_wk", "x_wv", "x_wo"})

PyTree = Any


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig

    def __post_init__(self):
        self.defs = model_defs(self.cfg)

    # ---- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator, ctx: Optional[MeshCtx] = None,
             *, serve=False, device=None):
        """Random weights drawn from `generator` (`params.init_params`),
        on `device` (default the generator's). With `ctx`, each process
        (its generator seeded as every other's) draws only what its
        blocks cut by `param_shardings(ctx, serve=serve)` take, one layer
        at most at a time: its blocks are those of the one-device draw
        from the same seed, and no process holds a whole leaf. `serve` a
        tuple of flags, e.g. (True, False): one draw cut into a model for
        each, returned as a tuple."""
        if ctx is None:
            return LanguageModel(self.cfg, pm.init_params(
                self.defs, generator, device=device))
        flags = serve if isinstance(serve, tuple) else (serve,)
        specs = [self.param_specs(ctx, serve=f) for f in flags]
        trees = pm.init_params(self.defs, generator, specs=specs,
                               mesh=ctx.mesh, device=device)
        models = tuple(LanguageModel(self.cfg, t, specs=sp, mesh=ctx.mesh)
                       for t, sp in zip(trees, specs))
        return models if isinstance(serve, tuple) else models[0]

    def shard(self, model, ctx: MeshCtx, *, serve: bool = False
              ) -> LanguageModel:
        """A model of this process's blocks of `model`'s leaves (a whole
        model or tree, e.g. `params_from_reference`'s), cut by
        `param_shardings(ctx, serve=serve)`."""
        tree = model.tree if isinstance(model, LanguageModel) else model
        specs = self.param_specs(ctx, serve=serve)
        return LanguageModel(self.cfg, pm.shard_tree(tree, specs, ctx.mesh),
                             specs=specs, mesh=ctx.mesh)

    def unshard(self, model: LanguageModel) -> PyTree:
        """The whole tree of a sharded model, on every process."""
        return pm.gather_tree(model.tree, model.specs, model.mesh)

    def param_defs(self, ctx: MeshCtx, *, serve: bool = False) -> PyTree:
        """serve=True drops the FSDP axis (weights TP-resident, replicated
        over data), and replicates attention weights when the heads do
        not split over `model` (the S-sharded cache then never moves
        during decode), as the reference's `param_shardings`."""
        if not serve:
            return self.defs
        heads_tp = self.cfg.heads % ctx.tp == 0

        def remap(defs):
            out = {}
            for k, d in defs.items():
                if isinstance(d, dict):
                    out[k] = remap(d)
                    continue
                if k in ATTN_KEYS and not heads_tp:
                    logical = (None,) * len(d.logical)
                else:
                    logical = tuple(None if a == "fsdp" else a
                                    for a in d.logical)
                out[k] = dataclasses.replace(d, logical=logical)
            return out
        return remap(self.defs)

    def param_specs(self, ctx: MeshCtx, *, serve: bool = False) -> PyTree:
        return pm.tree_specs(self.param_defs(ctx, serve=serve), ctx)

    def param_shardings(self, ctx: MeshCtx, *, serve: bool = False
                        ) -> PyTree:
        return pm.tree_shardings(self.param_defs(ctx, serve=serve), ctx)

    def opt_shardings(self, ctx: MeshCtx) -> AdamWState:
        sh = self.param_shardings(ctx)
        return AdamWState(NamedSharding(ctx.mesh, P()), sh, sh)

    def param_count(self) -> int:
        return pm.param_count(self.defs)

    def param_bytes(self) -> int:
        return pm.param_bytes(self.defs)

    # ---- steps -------------------------------------------------------------
    def prefill(self, model: LanguageModel, batch):
        return decode_mod.prefill(model, batch)

    def decode(self, model: LanguageModel, cache, token, cache_len: int):
        return decode_mod.decode(model, cache, token, cache_len)

    def loss(self, model: LanguageModel, batch) -> torch.Tensor:
        return lm_loss(model, batch)

    def loss_fn(self, ctx: Optional[MeshCtx] = None) -> Callable:
        """f(model, batch) -> the mean loss. With `ctx`: the global
        batch on every process, the global loss on every process,
        differentiable when every process differentiates it."""
        if ctx is None:
            return lm_loss
        return functools.partial(step_loss, ctx=ctx)

    def prefill_step(self, ctx: Optional[MeshCtx] = None) -> Callable:
        """step(model, batch) -> (last-position logits (B, Vpad), cache);
        with `ctx` the global logits and this process's `Sharded`
        cache."""
        def step(model, batch):
            if ctx is None:
                return decode_mod.prefill(model, batch)
            run = step_ctx(ctx, model, batch)
            return decode_mod.prefill(model, shard_batch(batch, run), run)
        return torch.no_grad()(step)

    def decode_step(self, ctx: Optional[MeshCtx] = None) -> Callable:
        """step(model, cache, token (B, 1), cache_len) -> (logits (B, Vpad),
        cache), the cache written in place."""
        def step(model, cache, token, cache_len):
            if ctx is None:
                return decode_mod.decode(model, cache, token, cache_len)
            run = step_ctx(ctx, model, {"tokens": token})
            tok = shard_batch({"tokens": token}, run)["tokens"]
            return decode_mod.decode(model, cache, tok, cache_len, run)
        return torch.no_grad()(step)

    def opt_init(self, model: LanguageModel) -> AdamWState:
        """Zero AdamW state over the model's reference tree."""
        return adamw_init(params_tree(model))

    def train_step(self, ctx: Optional[MeshCtx] = None, *, lr=3e-4,
                   max_grad_norm: float = 1.0, accum: int = 1) -> Callable:
        """step(model, opt_state, batch) -> (model, opt_state, {"loss",
        "grad_norm"}): the loss and its gradients, global-norm clipping,
        one AdamW step, the parameters and moments updated in place.
        accum > 1: gradient accumulation over microbatches. With `ctx`
        the model, the moments and the gradients are this process's
        blocks and the batch is the global one."""
        def step(model, opt_state, batch):
            loss, grads = value_and_grad(model, batch, accum=accum, ctx=ctx)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm,
                                               model.specs, model.mesh)
            _, opt_state = adamw_update(grads, opt_state, params_tree(model),
                                        lr=lr)
            return model, opt_state, {"loss": loss, "grad_norm": gnorm}
        return step

    # ---- caches and specs --------------------------------------------------
    def batch_specs(self, *, seq: int, batch: int, mode: str) -> Dict:
        return make_batch_specs(self.cfg, seq=seq, batch=batch, mode=mode)

    def cache_defs(self, *, batch: int, cache_len: int):
        return decode_mod.cache_defs(self.cfg, batch, cache_len)

    def batch_shardings(self, ctx: MeshCtx, *, seq: int, batch: int,
                        mode: str) -> Dict:
        """Every input's leading axis over the dp axes when they divide the
        batch, replicated otherwise."""
        specs = self.batch_specs(seq=seq, batch=batch, mode=mode)
        lead = ctx.batch_entry(batch)
        return {k: NamedSharding(ctx.mesh,
                                 P(lead, *([None] * (v.ndim - 1))))
                for k, v in specs.items()}

    def cache_shardings(self, ctx: MeshCtx, *, batch: int, cache_len: int):
        """The cache's placements; batch 1 (long_500k) drops the batch
        sharding and keeps kv_len on `model`."""
        return pm.tree_map(lambda sp: NamedSharding(ctx.mesh, sp),
                           decode_mod.cache_specs(self.cfg, ctx, batch,
                                                  cache_len))

    def init_cache(self, *, batch: int, cache_len: int, device=None,
                   ctx: Optional[MeshCtx] = None) -> PyTree:
        """A zero cache on `device` (CUDA unless the caller asks for the
        CPU; raises without a card); with `ctx`, this process's blocks of
        it as a `Sharded` cache."""
        from ..core.replay import resolve_device
        defs = self.cache_defs(batch=batch, cache_len=cache_len)
        if ctx is None:
            return decode_mod.zeros_cache(defs, resolve_device(device))
        specs = decode_mod.cache_specs(self.cfg, ctx, batch, cache_len)
        local = pm.tree_map(
            lambda d, sp: pm.ParamDef(local_shape(d.shape, sp, ctx.mesh),
                                      d.logical, d.init, d.scale, d.dtype),
            defs, specs)
        return pm.Sharded(decode_mod.zeros_cache(local,
                                                 resolve_device(device)),
                          specs)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one process's block of a leaf of `shape`."""
    return tuple(n // mesh.axes_size(entry_axes(e)) if e is not None else n
                 for n, e in zip(shape, spec))


def step_ctx(ctx: MeshCtx, model: LanguageModel, batch) -> MeshCtx:
    """The step's context: `ctx` with the global batch, checked to be the
    mesh the model is sharded on."""
    if model.mesh is not ctx.mesh:
        raise ValueError("the model is not sharded on this context's mesh "
                         "(ModelBundle.shard / init(ctx=...))")
    return ctx.with_batch(next(iter(batch.values())).shape[0])


def step_loss(model: LanguageModel, batch, ctx: Optional[MeshCtx] = None
              ) -> torch.Tensor:
    """`lm_loss` of a global batch: with `ctx`, on this process's rows."""
    if ctx is None:
        return lm_loss(model, batch)
    run = step_ctx(ctx, model, batch)
    return lm_loss(model, shard_batch(batch, run), run)


def reduce_grads(grads: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each gradient summed, in place, over the mesh axes its parameter is
    not sharded on (the shares of the processes that hold it in copy)."""
    from ..optim.adamw import sharded_axes

    def one(g, sp):
        rest = tuple(a for a in mesh.axis_names
                     if a not in sharded_axes(sp, mesh))
        if rest and mesh.axes_size(rest) > 1:
            g.copy_(col._raw_all_reduce(mesh, rest, g,
                                        torch.distributed.ReduceOp.SUM))
    pm.tree_map(one, grads, specs)
    return grads


def params_tree(model: LanguageModel, values: Optional[PyTree] = None
                ) -> PyTree:
    """The model's parameters as the reference's tree (leaves stacked over
    layers and groups, under the reference's names): the tensors the
    blocks view, so writing a leaf in place writes the model. `values`, a
    tree of the same shapes (a restored checkpoint's), is copied in
    first."""
    tree = model.tree
    if values is not None:
        def put(t, v):
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"leaf of shape {tuple(v.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(v)
        pm.tree_map(put, tree, values)
    return tree


def value_and_grad(model: LanguageModel, batch, *, accum: int = 1,
                   ctx: Optional[MeshCtx] = None
                   ) -> Tuple[torch.Tensor, PyTree]:
    """(mean loss, its gradient as the reference's tree). accum == 1: the
    gradients in each parameter's dtype. accum > 1: the batch cut into
    `accum` microbatches along its first axis, their losses and float32
    gradients summed in order and divided by `accum` (the reference's
    scan). With `ctx`: `batch` is the global batch (each microbatch cut
    into this process's rows), the loss the global one, and the gradient
    this process's blocks of the global gradient."""
    tree = params_tree(model)
    grads = pm.tree_map(torch.zeros_like, tree)

    def done(loss, g):
        if ctx is not None:
            reduce_grads(g, model.specs, model.mesh)
        return loss, g

    with bind_grads(model, grads):
        if accum == 1:
            loss = step_loss(model, batch, ctx)
            loss.backward()
            return done(loss.detach(), grads)
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "microbatches")
        mb = B // accum
        acc_l = torch.zeros((), dtype=torch.float32, device=model.device)
        acc_g = pm.tree_map(lambda t: torch.zeros(
            t.shape, dtype=torch.float32, device=t.device), tree)
        for i in range(accum):
            for g in pm.tree_leaves(grads):
                g.zero_()
            loss = step_loss(model, {k: v[i * mb:(i + 1) * mb]
                                     for k, v in batch.items()}, ctx)
            loss.backward()
            acc_l = acc_l + loss.detach()
            pm.tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc_g,
                        grads)
    n = acc_l.new_tensor(accum)
    return done(acc_l / n, pm.tree_map(lambda a: a.div_(n), acc_g))


@functools.lru_cache(maxsize=None)
def get_bundle(arch_id: str, smoke: bool = False) -> ModelBundle:
    from ..configs import get_config
    return ModelBundle(get_config(arch_id, smoke=smoke))
