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

`init_params` draws a tree in units (a layer of a stacked leaf, split
along its first remaining dim where that dim allows), each from a
generator of its own, so a process
draws only the units its blocks cut: a model no device holds whole is
drawn sharded without ever being whole, and its blocks are the blocks of
the one-device draw.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
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
    # the port's own: how many leading dims stack layers (and groups)
    stacked: int = 0

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


# The unit size a draw aims at, in float32 elements (256 MiB): a unit is
# one index of a leaf's stacked dims (a layer), cut along its first
# remaining dim into blocks of at most this many elements where that dim
# allows; one index of that dim is the smallest unit (mixtral-8x7b's
# `w_up`: one expert, 117 M elements).
DRAW_ELEMS = 1 << 26


def draw_units(d: ParamDef):
    """The units a leaf is drawn in, in order: for each, its index along
    every leading dim it fixes and its (start, stop) along the dim after
    them (None: the leaf has no such dim). Fixed by the leaf's shape
    alone, never by a mesh."""
    shape = tuple(d.shape)
    lead, rest = shape[:d.stacked], shape[d.stacked:]
    if rest:
        row = math.prod(rest[1:])
        step = max(1, DRAW_ELEMS // max(row, 1))
        rows = [(a, min(a + step, rest[0])) for a in range(0, rest[0], step)]
    else:
        rows = [None]
    for idx in itertools.product(*(range(n) for n in lead)):
        for r in rows:
            yield idx, r


def _unit_seed(base: int, path: str, i: int) -> int:
    h = hashlib.sha256(f"{base}/{path}/{i}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _block_ranges(shape, spec, mesh):
    """(start, stop) of this process's block along every dim."""
    if spec is None:
        return [(0, n) for n in shape]
    out = []
    for n, entry in zip(shape, spec):
        axes = entry_axes(entry)
        if not axes:
            out.append((0, n))
            continue
        k = mesh.axes_size(axes)
        b = n // k
        i = mesh.axes_index(axes)
        out.append((i * b, (i + 1) * b))
    return out


def init_params(defs: PyTree, generator: torch.Generator, *,
                specs=None, mesh=None, device=None):
    """Real initialization: normal leaves are N(0, 1) draws in float32
    times `scale`, cast to the leaf's dtype (the reference's distribution;
    its threefry bits cannot be matched), zeros and ones leaves filled.

    One number drawn from `generator` seeds the tree; each unit of a leaf
    (`draw_units`) is drawn on the generator's device from a generator
    seeded by (that number, the leaf's path, the unit's index), so a
    leaf's values never depend on how it is cut. With `specs` and a
    `mesh` whose coordinates are known (bound, or a rank given), the
    result is this process's blocks (`shard_tree` of the whole draw):
    only the units a block cuts are drawn, one at a time, so a process
    holds its blocks and one unit, never a whole leaf. `specs` may be a
    list of spec trees: each unit is then drawn once and cut into a tree
    for each, and the list of trees is returned. The leaves live on
    `device` (default the generator's)."""
    gdev = generator.device
    dev = gdev if device is None else torch.device(device)
    many = isinstance(specs, (list, tuple))
    spec_list = list(specs) if many else [specs]
    if any((sp is None) != (mesh is None) for sp in spec_list):
        raise ValueError("give both specs and mesh, or neither")
    base = int(torch.randint(0, 1 << 62, (), generator=generator,
                             device=gdev))

    def one(path: str, d: ParamDef, leaf_specs) -> list:
        dt = torch_dtype(d.dtype)
        blocks = [_block_ranges(d.shape, sp, mesh) for sp in leaf_specs]
        fill = {"zeros": torch.zeros, "ones": torch.ones}.get(d.init,
                                                             torch.empty)
        outs = [fill(tuple(b - a for a, b in r), dtype=dt, device=dev)
                for r in blocks]
        if d.init in ("zeros", "ones"):
            return outs
        k = d.stacked
        for i, (idx, rows) in enumerate(draw_units(d)):
            x = None
            for out, ranges in zip(outs, blocks):
                # where the unit (idx along the stacked dims, `rows` along
                # the next, the rest whole) meets this block
                if any(not a <= j < b for j, (a, b) in zip(idx, ranges)):
                    continue
                at = tuple(j - a for j, (a, _) in zip(idx, ranges))
                if rows is None:
                    src_ix, dst_ix, shape = (), at, ()
                else:
                    lo, hi = max(rows[0], ranges[k][0]), min(rows[1],
                                                             ranges[k][1])
                    if lo >= hi:
                        continue
                    shape = (rows[1] - rows[0],) + tuple(d.shape[k + 1:])
                    src_ix = (slice(lo - rows[0], hi - rows[0]),) + tuple(
                        slice(a, b) for a, b in ranges[k + 1:])
                    dst_ix = at + (slice(lo - ranges[k][0],
                                         hi - ranges[k][0]),)
                if x is None:
                    g = torch.Generator(device=gdev).manual_seed(
                        _unit_seed(base, path, i))
                    x = torch.randn(shape, generator=g, dtype=torch.float32,
                                    device=gdev).mul_(d.scale)
                out[dst_ix].copy_(x[src_ix].to(dt))
            del x
        return outs

    def walk(defs, leaf_specs, path) -> list:
        if isinstance(defs, dict):
            sub = {key: walk(defs[key], [None if sp is None else sp[key]
                                         for sp in leaf_specs],
                             f"{path}/{key}")
                   for key in defs}
            return [{key: sub[key][n] for key in defs}
                    for n in range(len(leaf_specs))]
        return one(path, defs, leaf_specs)
    trees = walk(defs, spec_list, "")
    return trees if many else trees[0]


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
