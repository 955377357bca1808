"""AdamW with global-norm clipping and a cosine schedule, as plain
functions over the reference's parameter tree (nested dicts of tensors,
`repro/optim/adamw.py`).

Moments are float32 whatever the parameter's dtype: a bfloat16 parameter
updates through a float32 cast and is cast back. The float32 scalars of
the reference (the step's bias corrections, the schedule) are float32
tensors on the leaves' device, and the arithmetic follows the reference
operation by operation, in its order (`torch.optim.AdamW` orders its bias
correction and decay differently). A division is a true division by a
float32 tensor on the leaves' device: on CUDA, a Python number as the
divisor would be a product with its reciprocal. XLA still contracts some
of the reference's products and sums into fused multiply-adds, so the two
differ in the last bits.

Clipping and the update write into the tensors they are given: a model's
block parameters are views of its stacked leaves
(`models/transformer.py`), so updating a leaf moves every view. Large
leaves go through in chunks of `CHUNK` elements; every operation there is
elementwise, so the result is the same and the float32 temporaries stay
small.

Sharded (a spec tree and its bound mesh given): each leaf is this
process's block, and the norm keeps the reference's global meaning. A
leaf's squares are summed over the axes it is sharded on, so every
element of the logical leaf counts once and a replicated leaf is counted
once, not once per copy; the update is elementwise and runs on the
blocks in place.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

from ..dist import collectives as col
from ..dist.sharding import entry_axes
from ..models.params import tree_leaves, tree_map

PyTree = Any
F32 = torch.float32
CHUNK = 1 << 25


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32, 0-d, on the leaves' device
    m: PyTree
    v: PyTree


def chunks(t: torch.Tensor):
    """Views of a contiguous tensor's elements, `CHUNK` at a time."""
    if not t.is_contiguous():
        raise ValueError("optimizer leaves must be contiguous")
    return t.view(-1).split(CHUNK)


def adamw_init(params: PyTree) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def sharded_axes(spec, mesh):
    """The mesh axes of more than one process that a leaf's spec shards
    it over, in mesh order."""
    used = {a for e in spec for a in entry_axes(e)}
    return tuple(a for a in mesh.axis_names
                 if a in used and mesh.shape[a] > 1)


def global_sq_norm(grads: PyTree, specs: PyTree = None, mesh=None
                   ) -> torch.Tensor:
    """The sum of the squares of every element of the logical leaves, in
    float32. Sharded: per set of sharded axes, the blocks' sums are summed
    over those axes (one all-reduce per set), in a fixed order on every
    process."""
    leaves = tree_leaves(grads)
    sums = [sum(torch.sum(torch.square(c.to(F32))) for c in chunks(g))
            for g in leaves]
    if specs is None:
        gn2 = None
        for s in sums:
            gn2 = s if gn2 is None else gn2 + s
        return gn2
    by_axes = {}
    for s, sp in zip(sums, tree_leaves(specs)):
        key = sharded_axes(sp, mesh)
        by_axes[key] = s if key not in by_axes else by_axes[key] + s
    gn2 = None
    for key in sorted(by_axes):
        s = by_axes[key]
        if key:
            s = col._raw_all_reduce(mesh, key, s, torch.distributed.ReduceOp.SUM)
        gn2 = s if gn2 is None else gn2 + s
    return gn2


def clip_by_global_norm(grads: PyTree, max_norm: float, specs: PyTree = None,
                        mesh=None):
    """Scale `grads` in place to a global norm of at most `max_norm`
    (each leaf through float32, cast back to its dtype); returns
    (grads, the norm before clipping). specs, mesh: `grads` holds this
    process's blocks, cut by the spec tree `specs` on `mesh`."""
    gn = torch.sqrt(global_sq_norm(grads, specs, mesh))
    scale = torch.clamp(gn.new_tensor(max_norm) / (gn + 1e-9), max=1.0)
    for g in tree_leaves(grads):
        for c in chunks(g):
            c.copy_(c.to(F32) * scale)
    return grads, gn


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up over `warmup` steps, then a cosine to 0 at `total`:
    a function of the int32 step tensor, in float32 on its device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(F32)
        warm = s / s.new_tensor(max(warmup, 1))
        prog = torch.clamp((s - warmup) / s.new_tensor(max(total - warmup, 1)),
                           0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr


def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step in place on `params` and the state's moments;
    returns (params, the new state)."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    sf = step.to(F32)
    b1c = 1 - torch.pow(sf.new_tensor(b1), sf)
    b2c = 1 - torch.pow(sf.new_tensor(b2), sf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        for pc, gc, mc, vc in zip(chunks(p), chunks(g), chunks(m),
                                  chunks(v)):
            gf = gc.to(F32)
            mc.mul_(b1).add_((1 - b1) * gf)
            vc.mul_(b2).add_((1 - b2) * gf * gf)
            u = (mc / b1c) / (torch.sqrt(vc / b2c) + eps)
            pf = pc.to(F32)
            pc.copy_(pf - lr_t * (u + weight_decay * pf))
    return params, AdamWState(step, state.m, state.v)
