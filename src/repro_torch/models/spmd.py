"""Shard-local SPMD pieces of the model stack under a mesh context: a
block's parameters gathered as a sublayer needs them, the residual
stream's sequence sharding (the reference's `res_shard`, `res_gather`
and `melt_batch`), the tensor-parallel combine, and a step's batch cut to
this process's rows.

Each process holds its blocks of every parameter (`params.shard_leaf`)
and of the batch (`shard_batch`: the dp rows when the dp axes divide the
global batch, else all of it). Activations are this process's batch rows,
over the whole sequence or, between blocks where the sequence splits over
the model axis, its L / tp rows (`seq_sharded`). Gradients follow
`dist/collectives.py`: each process differentiates its own share of the
loss, and a parameter's gradient is summed over the axes it is not
sharded on after the backward (`models/zoo.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dist import collectives as col
from ..dist.sharding import MeshCtx, entry_axes


def param(p, name: str, ctx: Optional[MeshCtx], keep=()) -> torch.Tensor:
    """Parameter `name` of the block `p` (a module or dict with `specs`),
    gathered over every axis it is sharded on except those in `keep`
    (which stay this process's block)."""
    w = p[name]
    if ctx is None:
        return w
    for dim, entry in enumerate(p.specs[name]):
        axes = entry_axes(entry)
        gather = tuple(a for a in axes if a not in keep)
        if gather and len(gather) != len(axes):
            raise ValueError(f"{name}: cannot keep part of the axes {axes}")
        if gather:
            w = col.all_gather(w, ctx.mesh, gather, dim)
    return w


def param_tp_block(p, name: str, ctx: MeshCtx, dim: int) -> torch.Tensor:
    """This model rank's block of parameter `name` along `dim`, whole
    along every other dimension: its stored block where the leaf is
    sharded there on the model axis, else a slice of the gathered leaf."""
    tp = ctx.tp_axis
    w = param(p, name, ctx, keep=(tp,))
    if tp is not None and tp not in entry_axes(p.specs[name][dim]):
        w = col.local_block(w, ctx.mesh, tp, dim)
    return w


def tp_sections(w: torch.Tensor, parts: int, ctx: MeshCtx,
                dim: int = -1) -> torch.Tensor:
    """The model rank's block of each of `parts` equal sections of `w`
    along `dim`, concatenated: a fused projection's ([gate | up], [z | x],
    [q | k | v]) columns of the rank's heads or features."""
    sec = w.shape[dim] // parts
    n = sec // ctx.tp
    lo = ctx.tp_rank * n
    return torch.cat([w.narrow(dim, i * sec + lo, n) for i in range(parts)],
                     dim)


def seq_sharded(ctx: Optional[MeshCtx], L: int) -> bool:
    """Whether a sequence of global length L lives split over the model
    axis between blocks (the reference's `res_shard` condition)."""
    return ctx is not None and L % ctx.tp == 0 and L > 1


def res_shard(x: torch.Tensor, ctx: Optional[MeshCtx]) -> torch.Tensor:
    """Sequence parallelism (Korthikanti et al.): a (B, L, d) value whose
    rows this process holds whole -> its L / tp rows. A slice: no
    traffic."""
    if ctx is None or x.ndim != 3 or not seq_sharded(ctx, x.shape[1]):
        return x
    return col.local_block(x, ctx.mesh, ctx.tp_axis, 1)


def rows_gather(x: torch.Tensor, ctx: Optional[MeshCtx], L: int
                ) -> torch.Tensor:
    """The whole sequence from the L / tp rows of every model rank."""
    if not seq_sharded(ctx, L):
        return x
    return col.all_gather(x, ctx.mesh, ctx.tp_axis, 1)


def res_gather(x: torch.Tensor, ctx: Optional[MeshCtx], L: int,
               sp_mode: str = "megatron") -> torch.Tensor:
    """A sublayer's input: megatron mode gathers the L-sharded residual
    for the sublayer's tensor-parallel products; weightgather mode keeps
    it L-sharded and the sublayer gathers its weights instead (2D FSDP)."""
    if sp_mode == "weightgather":
        return x
    return rows_gather(x, ctx, L)


def melt_batch(x: torch.Tensor, ctx: Optional[MeshCtx]):
    """For blocks whose inner structure cannot shard over the model axis:
    this process's rows of the batch spread over the dp axes and the model
    axis together, or None where B does not split dp x tp ways (as the
    reference, which defines but does not call it). x: the whole batch."""
    if ctx is None or x.ndim != 3 or x.shape[0] % (ctx.dp * ctx.tp):
        return None
    axes = tuple(ctx.dp_axes) + ((ctx.tp_axis,) if ctx.tp_axis else ())
    return col.local_block(x, ctx.mesh, axes, 0)


def tp_combine(partial: torch.Tensor, ctx: MeshCtx, L: int
               ) -> torch.Tensor:
    """The sum over the model axis of a tensor-parallel sublayer's partial
    outputs (whole rows): reduce-scattered to this rank's L / tp rows
    where the sequence is sharded, all-reduced otherwise."""
    if seq_sharded(ctx, L):
        return col.reduce_scatter(partial, ctx.mesh, ctx.tp_axis, 1)
    return col.all_reduce(partial, ctx.mesh, ctx.tp_axis)


def batch_sharded(ctx: MeshCtx, batch: int) -> bool:
    return ctx.batch_entry(batch) is not None and ctx.dp > 1


def shard_batch(batch: dict, ctx: MeshCtx) -> dict:
    """This process's rows of a step's global batch (every leaf's leading
    axis): its dp block where the dp axes divide the batch, all of it
    otherwise (the reference's `batch_shardings`)."""
    B = next(iter(batch.values())).shape[0]
    if not batch_sharded(ctx, B):
        return dict(batch)
    return {k: col.local_block(v, ctx.mesh, ctx.dp_axes, 0)
            for k, v in batch.items()}


def loss_copies(ctx: MeshCtx, batch: int) -> int:
    """How many processes hold the same batch rows (the model axis, and
    the dp axes too when the batch is not split over them)."""
    return ctx.mesh.size // (ctx.dp if batch_sharded(ctx, batch) else 1)
