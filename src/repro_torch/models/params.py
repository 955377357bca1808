"""Spec-driven parameters: one definition serves real initialization,
the counts, the conversion of the reference's parameters and the
sharding trees.

A parameter tree is a nested dict whose leaves are `ParamDef`s (shape,
logical axes, init, dtype), stacked over layers (and, for hybrid and ssm
models, over groups) exactly as in the reference;
`transformer.LanguageModel` turns a tree of tensors of that shape into the
port's modules.

Sharded, each process holds of a leaf the contiguous block its mesh
coordinates select along every dimension its spec shards (`shard_leaf`);
`gather_leaf` puts the blocks back together. So a leaf's shards are
slices of the reference's layout, and a checkpoint or a spec tree means
the same in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..dist import collectives as col
from ..dist.sharding import (MeshCtx, NamedSharding, PartitionSpec,
                             entry_axes, logical_to_spec)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]     # logical axis per dim
    init: str = "normal"                   # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"

    def spec(self, ctx: MeshCtx) -> PartitionSpec:
        """PartitionSpec with automatic replication of non-divisible dims
        (e.g. 8 KV heads over a 16-way model axis)."""
        full = logical_to_spec(ctx, *self.logical)
        out = []
        for dim, axes in zip(self.shape, full):
            if axes is None:
                out.append(None)
                continue
            size = 1
            for n in entry_axes(axes):
                size *= ctx.mesh.shape[n]
            out.append(axes if dim % size == 0 else None)
        return PartitionSpec(*out)


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


def tree_specs(defs: PyTree, ctx: MeshCtx) -> PyTree:
    return tree_map(lambda d: d.spec(ctx), defs)


def tree_shardings(defs: PyTree, ctx: MeshCtx) -> PyTree:
    return tree_map(lambda d: NamedSharding(ctx.mesh, d.spec(ctx)), defs)


def shard_leaf(full: torch.Tensor, spec, mesh, skip=()) -> torch.Tensor:
    """This process's block of a whole leaf (a contiguous copy): along
    each dimension its spec shards, the block of its coordinates. Axes in
    `skip` are taken as already local (a batch dimension a step was given
    sliced)."""
    t = full
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in entry_axes(entry) if a not in skip)
        if axes:
            t = col.local_block(t, mesh, axes, dim)
    return t.contiguous().clone()


def gather_leaf(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every process's block (no gradient)."""
    t = local.detach()
    for dim, entry in enumerate(spec):
        if entry is not None:
            t = col._raw_all_gather(mesh, mesh.ordered(entry_axes(entry)), t,
                                    dim)
    return t


def shard_tree(tree: PyTree, specs: PyTree, mesh, skip=()) -> PyTree:
    return tree_map(lambda t, s: shard_leaf(t, s, mesh, skip), tree, specs)


def gather_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    return tree_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


class Sharded(dict):
    """A tree of this process's blocks that carries its spec tree (a
    sharded cache: a local block alone does not say how large the whole
    leaf is)."""

    def __init__(self, tree: dict, specs: dict):
        super().__init__(tree)
        self.specs = specs


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
