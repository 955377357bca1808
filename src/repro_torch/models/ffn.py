"""Dense SwiGLU FFN and Mixture-of-Experts with capacity-based dispatch.

Dispatch: top-k experts per token by a stable descending sort (ties go to
the lower expert index, as `jax.lax.top_k` breaks them), each (token,
expert) pair's position within its expert by a one-hot cumsum in the
flattened token-major order, pairs at or past the capacity dropped, the
kept ones scattered into an (E, C, d) buffer.

Under a mesh context (`ctx`), as the reference:
  - the dense FFN is tensor-parallel over `model` on d_ff. Its `w_up` is
    [gate | up] and its stored shards are contiguous slices of that
    layout (the reference's specs), so rank r's gate and up columns lie
    on two ranks: the leaf is gathered whole and rank r takes columns
    [r F/tp, (r+1) F/tp) of each half, or, with fewer rows than d (a
    decode step), each rank's block of activations x @ w_up is gathered
    instead (rows x 2F elements, not d x 2F) and the partial sums are
    reduced in float32. `w_down`'s rows are its stored block. The partial
    outputs are summed over `model`. In
    weightgather mode the rank's L / tp rows go through the gathered
    weights instead;
  - the MoE layer with more than 4,096 tokens that the dp width divides
    runs the reference's shard_map body on each process: the dp block of
    the tokens dispatched with the per-shard capacity cap(T / dp),
    `w_up` and `w_down` gathered over `data` (ZeRO-3) but kept as the
    rank's contiguous `model` block (so its swiglu splits the rank's
    block of [gate | up] in two halves, exactly as the reference's body
    does), and the output summed over `model`;
  - any other MoE call (decode steps, short batches) routes the whole
    global batch's tokens with the global capacity (`ffn.py:84` of the
    reference: the same drop set and slot-order combine) and splits the
    expert products as XLA partitions that function (`moe_short`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..dist import collectives as col
from ..dist.sharding import entry_axes
from .common import matmul_f32, swiglu
from .spmd import (batch_sharded, param, param_tp_block, res_shard,
                   seq_sharded, tp_combine, tp_sections)


def dense_ffn(p, x, ctx=None, sp_mode: str = "megatron",
              seq_len: Optional[int] = None):
    """x: (B, L, d); p: w_up (d, 2*dff) [gate|up], w_down (dff, d).
    Under `ctx`, x and the result are rows as in `attention.attention`."""
    if ctx is None:
        return torch.matmul(swiglu(torch.matmul(x, p["w_up"])), p["w_down"])
    L = seq_len or x.shape[1]
    if sp_mode == "weightgather" and seq_sharded(ctx, L) or ctx.tp == 1:
        return torch.matmul(swiglu(torch.matmul(x, param(p, "w_up", ctx))),
                            param(p, "w_down", ctx))
    F_ = p["w_down"].shape[0]
    if ctx.tp_axis in entry_axes(p.specs["w_down"][0]):
        F_ *= ctx.tp
    if F_ % ctx.tp:                       # d_ff does not split: replicated
        y = torch.matmul(swiglu(torch.matmul(x, param(p, "w_up", ctx))),
                         param(p, "w_down", ctx))
        return res_shard(y, ctx) if seq_sharded(ctx, L) else y
    w_down = param_tp_block(p, "w_down", ctx, 0)
    n = F_ // ctx.tp
    lo = ctx.tp_rank * n
    if x.shape[0] * x.shape[1] < x.shape[2]:
        # fewer rows than d (decode): gather the rank's [gate | up] block
        # of activations, not the weight
        h = col.all_gather(torch.matmul(x, param_tp_block(p, "w_up", ctx,
                                                          1)),
                           ctx.mesh, ctx.tp_axis, -1)
        a = swiglu(h)[..., lo:lo + n]
        # the partial sums in float32, rounded once after the reduction
        part = torch.matmul(a.to(torch.float32), w_down.to(torch.float32))
        return tp_combine(part, ctx, L).to(x.dtype)
    else:
        a = swiglu(torch.matmul(x, tp_sections(param(p, "w_up", ctx), 2,
                                               ctx)))
    return tp_combine(torch.matmul(a, w_down), ctx, L)


def top_k(gates: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dispatch(x, wr, *, k: int, capacity: int):
    """The routing of `_moe_local`: (flat expert ids (T*k,), positions in
    expert (T*k,), keep mask (T*k,), normalised top-k weights (T, k))."""
    E = wr.shape[1]
    gates = torch.softmax(matmul_f32(x, wr), dim=-1)
    topv, topi = top_k(gates, k)                      # (T, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(-1)                              # (T*k,)
    oh = F.one_hot(flat_e, E)
    pos = torch.cumsum(oh, dim=0) - oh                     # position in expert
    pos = (pos * oh).sum(-1)                               # (T*k,)
    return flat_e, pos, pos < capacity, topv


def moe_scatter(x, flat_e, slot, keep, *, k: int, experts: int,
                capacity: int):
    """The (E, C, x's width) dispatch buffer: each kept (token, expert)
    pair's row of x at its slot (kept (e, pos) pairs are unique; a dropped
    pair adds 0 to slot 0)."""
    T, d = x.shape
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((experts, capacity, d), dtype=x.dtype, device=x.device)
    contrib = torch.where(keep[:, None], x[tok], 0)
    buf.index_put_((flat_e, slot), contrib, accumulate=True)
    return buf


def moe_combine(y_e, flat_e, slot, keep, topv, *, k: int):
    """The tokens' outputs (T, y_e's width) from the experts' (E, C, .)."""
    T = topv.shape[0]
    gathered = y_e[flat_e, slot]                           # (T*k, d)
    w = torch.where(keep, topv.reshape(-1), 0.0).to(y_e.dtype)
    parts = (gathered * w[:, None]).reshape(T, k, y_e.shape[-1])
    # the weighted combine, each token's k parts added in order from zero:
    # the reference's scatter-add order, and deterministic on the card
    # (index_add_ there adds with atomics in no fixed order)
    y = torch.zeros((T, y_e.shape[-1]), dtype=y_e.dtype, device=y_e.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


def moe_local(x, wr, w_up, w_down, *, k: int, capacity: int):
    """Per-device MoE block. x: (T, d); wr: (d, E); w_up: (E, d, 2F);
    w_down: (E, F, d)."""
    E = wr.shape[1]
    flat_e, pos, keep, topv = moe_dispatch(x, wr, k=k, capacity=capacity)
    slot = torch.where(keep, pos, 0)
    buf = moe_scatter(x, flat_e, slot, keep, k=k, experts=E,
                      capacity=capacity)
    h = swiglu(torch.bmm(buf, w_up))
    y_e = torch.bmm(h, w_down)                             # (E, C, d)
    return moe_combine(y_e, flat_e, slot, keep, topv, k=k)


def moe_capacity(tokens: int, cfg) -> int:
    return max(1, int(tokens * cfg.top_k / cfg.num_experts
                      * cfg.moe_capacity_factor))


def moe_ffn(p, x, *, cfg, ctx=None):
    """x: (B, L, d) -> (B, L, d). p: wr (d, E), w_up (E, d, 2F),
    w_down (E, F, d). Under `ctx`: this process's batch rows over the
    whole sequence, `ctx.batch` the global batch."""
    B, L, d = x.shape
    if ctx is None:
        y = moe_local(x.reshape(B * L, d), p["wr"], p["w_up"], p["w_down"],
                      k=cfg.top_k, capacity=moe_capacity(B * L, cfg))
        return y.reshape(B, L, d).to(x.dtype)
    mesh, dp = ctx.mesh, ctx.dp_axes
    rows = batch_sharded(ctx, ctx.batch)
    T = ctx.batch * L
    if T % ctx.dp or T <= 4096:
        return moe_short(p, x, cfg=cfg, ctx=ctx)
    # the reference's shard_map body on this process's block of tokens
    xt = x.reshape(B * L, d)
    if not rows:
        xt = col.local_block(xt, mesh, dp, 0)
    y = moe_local(xt, param(p, "wr", ctx),
                  param_tp_block(p, "w_up", ctx, 2),
                  param_tp_block(p, "w_down", ctx, 1), k=cfg.top_k,
                  capacity=moe_capacity(T // ctx.dp, cfg))
    y = col.all_reduce(y, mesh, ctx.tp_axis)
    if not rows:
        y = col.all_gather(y, mesh, dp, 0)
    return y.reshape(B, L, d).to(x.dtype)


def _param_blocks(p, name: str, ctx, blocks: dict) -> torch.Tensor:
    """Parameter `name` whole except along each dim of `blocks`, where it
    is this process's block over that dim's axis: the stored block where
    the leaf is sharded there (the training specs), else a slice of the
    gathered leaf (the serving specs keep the FSDP dim whole)."""
    spec = p.specs[name]
    w = param(p, name, ctx, keep=tuple(
        a for dim, a in blocks.items() if a in entry_axes(spec[dim])))
    for dim, a in blocks.items():
        if a not in entry_axes(spec[dim]):
            w = col.local_block(w, ctx.mesh, a, dim)
    return w


def moe_short(p, x, *, cfg, ctx):
    """The short-batch MoE path under a mesh (at most 4,096 tokens, or a
    token count the dp width does not divide): the reference's local
    function over the global batch, which XLA partitions as follows, and
    so does this.

    Replicated on every process: the routing of all T tokens of the
    global batch (the all-gathered rows), the global capacity, the drop
    set and the slots. Split:
      - over the FSDP axis (`data`), d: this process's dispatch buffer
        holds its block of the tokens' columns, (E, C, d / data); it meets
        the (E, d / data, .) block of `w_up` (the stored one under the
        training specs), and the partial products are summed over `data`
        before swiglu; `w_down`'s columns of that block give the outputs'
        d block;
      - over `model`, F: the rank's block of F of both halves of [gate |
        up] (swiglu exact), `w_down`'s stored rows, and the combined
        outputs summed over `model`.
    Each process then keeps its rows (an all-to-all over `data` turns the
    tokens' d blocks into this process's rows of whole width). Where d
    or F does not split, that axis's products run replicated."""
    _, L, d = x.shape
    mesh, dp, tp, fs = ctx.mesh, ctx.dp_axes, ctx.tp_axis, ctx.fsdp_axis
    rows = batch_sharded(ctx, ctx.batch)
    T = ctx.batch * L
    k = cfg.top_k
    xg = col.all_gather(x, mesh, dp, 0) if rows else x
    xt = xg.reshape(T, d)
    wr = param(p, "wr", ctx)
    E = wr.shape[1]
    cap = moe_capacity(T, cfg)
    flat_e, pos, keep, topv = moe_dispatch(xt, wr, k=k, capacity=cap)
    slot = torch.where(keep, pos, 0)

    n_fs = mesh.axes_size(fs) if fs else 1
    d_split = n_fs > 1 and d % n_fs == 0
    F_ = p["w_down"].shape[1] * (ctx.tp if tp in entry_axes(
        p.specs["w_down"][1]) else 1)
    f_split = ctx.tp > 1 and F_ % ctx.tp == 0
    w_up = _param_blocks(p, "w_up", ctx, {1: fs} if d_split else {})
    if f_split:
        w_up = tp_sections(w_up, 2, ctx)
    w_down = _param_blocks(p, "w_down", ctx,
                           {**({1: tp} if f_split else {}),
                            **({2: fs} if d_split else {})})

    xd = col.local_block(xt, mesh, fs, 1) if d_split else xt
    buf = moe_scatter(xd, flat_e, slot, keep, k=k, experts=E, capacity=cap)
    h = torch.bmm(buf, w_up)
    if d_split:
        h = col.all_reduce(h, mesh, fs)
    y_e = torch.bmm(swiglu(h), w_down)
    y = moe_combine(y_e, flat_e, slot, keep, topv, k=k)
    if f_split:
        y = col.all_reduce(y, mesh, tp)
    y = y.reshape(ctx.batch, L, y.shape[-1])
    if d_split and rows:
        others = tuple(a for a in mesh.ordered(dp) if a != fs)
        if others:
            y = col.local_block(y, mesh, others, 0)
        y = col.all_to_all(y, mesh, fs, 0, 2)
    elif d_split:
        y = col.all_gather(y, mesh, fs, 2)
    elif rows:
        y = col.local_block(y, mesh, dp, 0)
    return y.to(x.dtype)
