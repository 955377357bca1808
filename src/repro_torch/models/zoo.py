"""ModelBundle: one object per architecture exposing what the launchers,
the tests and the simulation plane need (the reference's
`repro/models/zoo.py`): parameters, the loss and the training step,
prefill and decode, caches and specs. Its steps run on one device; the
reference's mesh context (`ctx`) and sharding trees wait for the sharding
slice (ROADMAP 10c)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..data.pipeline import make_batch_specs
from ..optim import (AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm)
from . import decode as decode_mod
from . import params as pm
from .config import ModelConfig
from .transformer import LanguageModel, bind_grads, lm_loss, model_defs

PyTree = Any


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig

    def __post_init__(self):
        self.defs = model_defs(self.cfg)

    # ---- parameters --------------------------------------------------------
    def init(self, generator: torch.Generator) -> LanguageModel:
        """Random weights drawn from `generator`, on its device."""
        return LanguageModel(self.cfg, pm.init_params(self.defs, generator))

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

    def loss_fn(self, ctx=None) -> Callable:
        no_mesh(ctx)
        return lm_loss

    def opt_init(self, model: LanguageModel) -> AdamWState:
        """Zero AdamW state over the model's reference tree."""
        return adamw_init(params_tree(model))

    def train_step(self, ctx=None, *, lr=3e-4, max_grad_norm: float = 1.0,
                   accum: int = 1) -> Callable:
        """step(model, opt_state, batch) -> (model, opt_state, {"loss",
        "grad_norm"}): the loss and its gradients, global-norm clipping,
        one AdamW step, the parameters and moments updated in place.
        accum > 1: gradient accumulation over microbatches."""
        no_mesh(ctx)

        def step(model, opt_state, batch):
            loss, grads = value_and_grad(model, batch, accum=accum)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            _, opt_state = adamw_update(grads, opt_state, params_tree(model),
                                        lr=lr)
            return model, opt_state, {"loss": loss, "grad_norm": gnorm}
        return step

    # ---- caches and specs --------------------------------------------------
    def batch_specs(self, *, seq: int, batch: int, mode: str) -> Dict:
        return make_batch_specs(self.cfg, seq=seq, batch=batch, mode=mode)

    def cache_defs(self, *, batch: int, cache_len: int):
        return decode_mod.cache_defs(self.cfg, batch, cache_len)

    def init_cache(self, *, batch: int, cache_len: int, device=None) -> PyTree:
        """A zero cache on `device` (CUDA unless the caller asks for the
        CPU; raises without a card)."""
        from ..core.replay import resolve_device
        return decode_mod.zeros_cache(
            self.cache_defs(batch=batch, cache_len=cache_len),
            resolve_device(device))


def no_mesh(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "a mesh context shards the step over devices; the port runs on "
            "one device until the sharding slice (ROADMAP 10c)")


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


def value_and_grad(model: LanguageModel, batch, *, accum: int = 1
                   ) -> Tuple[torch.Tensor, PyTree]:
    """(mean loss, its gradient as the reference's tree). accum == 1: the
    gradients in each parameter's dtype. accum > 1: the batch cut into
    `accum` microbatches along its first axis, their losses and float32
    gradients summed in order and divided by `accum` (the reference's
    scan)."""
    tree = params_tree(model)
    grads = pm.tree_map(torch.zeros_like, tree)
    with bind_grads(model, grads):
        if accum == 1:
            loss = lm_loss(model, batch)
            loss.backward()
            return loss.detach(), grads
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
            loss = lm_loss(model, {k: v[i * mb:(i + 1) * mb]
                                   for k, v in batch.items()})
            loss.backward()
            acc_l = acc_l + loss.detach()
            pm.tree_map(lambda a, g: a.add_(g.to(torch.float32)), acc_g,
                        grads)
    n = acc_l.new_tensor(accum)
    return acc_l / n, pm.tree_map(lambda a: a.div_(n), acc_g)


@functools.lru_cache(maxsize=None)
def get_bundle(arch_id: str, smoke: bool = False) -> ModelBundle:
    from ..configs import get_config
    return ModelBundle(get_config(arch_id, smoke=smoke))
