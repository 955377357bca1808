"""Spec-driven parameters: one definition serves real initialization,
the counts and the conversion of the reference's parameters.

A parameter tree is a nested dict whose leaves are `ParamDef`s (shape,
logical axes, init, dtype), stacked over layers (and, for hybrid and ssm
models, over groups) exactly as in the reference;
`transformer.LanguageModel` turns a tree of tensors of that shape into the
port's modules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]     # logical axis per dim
    init: str = "normal"                   # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a reference dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map `fn` over the leaves of nested dicts (every tree in `rest` has
    the first one's keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of nested dicts in the reference's flatten order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init_params(defs: PyTree, generator: torch.Generator) -> PyTree:
    """Real initialization on the generator's device: normal leaves are
    N(0, 1) draws in float32 times `scale`, cast to the leaf's dtype (the
    reference's distribution; its threefry bits cannot be matched)."""
    dev = generator.device

    def one(d: ParamDef):
        dt = torch_dtype(d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        return (torch.randn(d.shape, generator=generator, dtype=torch.float32,
                            device=dev).mul_(d.scale)).to(dt)
    return tree_map(one, defs)


def from_numpy_tree(defs: PyTree, tree: PyTree, device) -> PyTree:
    """Float32 numpy leaves (the reference's, through `np.asarray(leaf,
    np.float32)`) as tensors of each ParamDef's dtype on `device`. A
    bfloat16 value survives bfloat16 -> float32 -> bfloat16 exactly."""
    def one(d: ParamDef, a):
        a = np.asarray(a, np.float32)
        if a.shape != tuple(d.shape):
            raise ValueError(f"leaf of shape {a.shape}, expected {d.shape}")
        return torch.from_numpy(a.copy()).to(device=device,
                                             dtype=torch_dtype(d.dtype))
    return tree_map(one, defs, tree)


def param_bytes(defs: PyTree) -> int:
    return int(sum(math.prod(d.shape) * torch_dtype(d.dtype).itemsize
                   for d in tree_leaves(defs)))


def param_count(defs: PyTree) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))


def params_from_reference(cfg, tree: PyTree, device=None):
    """The reference's parameter pytree (nested dicts of numpy arrays,
    leaves stacked over layers and groups; any float dtype numpy can cast
    to float32) as the port's model on `device` (CUDA unless the caller
    asks for the CPU; raises without a card), each leaf in its ParamDef's
    dtype (`cfg.param_dtype`, float32 for the SSM scalars)."""
    from ..core.replay import resolve_device
    from .transformer import LanguageModel, model_defs
    return LanguageModel(cfg, from_numpy_tree(model_defs(cfg), tree,
                                              resolve_device(device)))
