"""GQA attention: query-chunked prefill, cached decode, windows.

The full-sequence pass loops over query chunks of 256 with the full K/V
per chunk (peak memory chunk x S instead of L x S; under autograd a
chunk's scores are recomputed in the backward); causal and window
masks come from absolute positions, scores and softmax in float32, the
probabilities cast to v's dtype, as in the reference
(`repro/models/attention.py`). Written in plain PyTorch ops rather than
`scaled_dot_product_attention`, so the masks and casts are the
reference's.

Under a mesh context (`ctx`), as the reference's sharding strategy:
  - heads % tp == 0 (megatron mode): head tensor parallelism. Each model
    rank projects its own block of query heads, the KV heads repeated to H
    and sliced to the same block, and its heads' part of the `wo`
    contraction is summed over the model axis (reduce-scattered to the
    rank's rows where the sequence is sharded between blocks);
  - otherwise, or in weightgather mode, with L % tp == 0: sequence-sharded
    attention (the reference's `_seq_sharded_attention`). Each model rank
    owns L / tp query rows at offset r * L / tp and the full K/V (its rows'
    K/V all-gathered), with the reference's chunk budget; the output stays
    sharded by rows;
  - tiny L (a cross-attention in decode): replicated compute;
  - decode: the cache's S axis is sharded over `model`. The new row lands
    on the rank that owns its slot; the softmax runs across ranks (max,
    then sum, then the weighted V, each all-reduced), flash-decode's
    combine. Where the weights' heads are split over `model` (the
    serving specs), each rank projects its own heads and the step's few
    rows of q, k, v are gathered, and `wo`'s partial sums are reduced in
    float32: no weight moves per token.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..dist import collectives as col
from ..dist.sharding import entry_axes
from .common import F32, remat, rope
from .spmd import param, param_tp_block, seq_sharded, tp_combine

NEG = -1e30


def gqa_scores_ctx(q, k, v, *, causal: bool, window: int, q_offset: int,
                   chunk: int = 256):
    """q: (B, Lq, H, hd), k/v: (B, S, KV, hd) -> (B, Lq, H, hd).

    q_offset: absolute position of q[0] (prefill: 0). Queries longer than
    `chunk` run chunk by chunk, the ragged tail padded with zero queries
    and sliced off, as in the reference's scan.
    """
    B, Lq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = hd ** -0.5
    chunk = min(chunk, Lq)
    kpos = torch.arange(S, device=q.device)
    kf = k.to(F32)
    qg = q.reshape(B, Lq, KV, group, hd)

    def one_chunk(qc, qpos):
        # qc: (B, nq, KV, group, hd)
        s = torch.einsum("bqkgh,bskh->bqkgs", qc.to(F32), kf) * scale
        mask = torch.ones((qc.shape[1], S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s, NEG)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bqkgs,bskh->bqkgh", p, v)

    if Lq <= chunk:
        qpos = q_offset + torch.arange(Lq, device=q.device)
        return one_chunk(qg, qpos).reshape(B, Lq, H, hd)

    n = -(-Lq // chunk)
    pad = n * chunk - Lq
    if pad:                          # ragged tail: pad, compute, slice
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
    outs = []
    for i in range(n):
        qpos = q_offset + i * chunk + torch.arange(chunk, device=q.device)
        # recomputed in the backward, as the reference's checkpointed scan
        outs.append(remat(one_chunk, qg[:, i * chunk:(i + 1) * chunk],
                          qpos))
    out = torch.cat(outs, dim=1)
    return out[:, :Lq].reshape(B, Lq, H, hd)


def _qkv(p, x, src, ctx=None):
    q = torch.einsum("bld,dnh->blnh", x, param(p, "wq", ctx))
    k = torch.einsum("bsd,dnh->bsnh", src, param(p, "wk", ctx))
    v = torch.einsum("bsd,dnh->bsnh", src, param(p, "wv", ctx))
    if p.get("bq") is not None:
        q = q + param(p, "bq", ctx)
        k = k + param(p, "bk", ctx)
        v = v + param(p, "bv", ctx)
    return q, k, v


def _positions(B, start, n, device):
    return torch.broadcast_to(start + torch.arange(n, device=device), (B, n))


def attention(p, x, *, cfg, ctx=None, causal: bool = True,
              kv_x: Optional[torch.Tensor] = None, use_rope: bool = True,
              seq_len: Optional[int] = None, kv_out: bool = True):
    """Full-sequence attention (train / prefill). x: (B, L, d); p maps
    wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d) and, with QKV bias,
    bq/bk/bv. kv_x: the encoder states of a cross-attention. Returns
    (y, (k, v)), k/v over the whole sequence.

    Under `ctx`: seq_len is the global L; x holds this rank's L / tp rows
    where the sequence is sharded and the mode is weightgather, its whole
    rows otherwise, and y this rank's L / tp rows wherever the sequence is
    sharded (`spmd.seq_sharded`). kv_out=False: the caller drops k/v (a
    training stack); in head tensor parallelism each model rank then
    projects only its own KV heads and returns (y, None)."""
    if ctx is not None:
        return _attention_ctx(p, x, cfg=cfg, ctx=ctx, causal=causal,
                              kv_x=kv_x, use_rope=use_rope,
                              L=seq_len or x.shape[1], kv_out=kv_out)
    B, L, d = x.shape
    src = x if kv_x is None else kv_x
    q, k, v = _qkv(p, x, src)
    if use_rope and kv_x is None:
        pos = _positions(B, 0, L, x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    out = gqa_scores_ctx(q, k, v, causal=causal and kv_x is None,
                         window=cfg.attn_window, q_offset=0)
    y = torch.einsum("blnh,nhd->bld", out, p["wo"])
    return y, (k, v)


def seq_chunk(b_loc: int, heads: int, s_full: int, l_loc: int) -> int:
    """The reference's query chunk in `_seq_sharded_attention`: a power of
    two (>= 16) bounding the float32 score buffer (b_loc, chunk, H, S) to
    ~256 MB, at most the rank's rows."""
    budget = max(16, (1 << 28) // max(b_loc * heads * s_full * 4, 1))
    chunk = 1 << max(4, budget.bit_length() - 1)
    return min(chunk, l_loc)


def _attention_ctx(p, x, *, cfg, ctx, causal, kv_x, use_rope, L,
                   kv_out=True):
    H, KV = cfg.heads, cfg.kv_heads
    mesh, tp = ctx.mesh, ctx.tp_axis
    B = x.shape[0]
    is_causal = causal and kv_x is None
    weightgather = cfg.sp_mode == "weightgather"
    sp = seq_sharded(ctx, L)
    if H % ctx.tp == 0 and not weightgather:
        # Megatron-style GQA TP: KV heads repeated to H so the head axis
        # shards evenly; each rank's q heads see their own kv copy. Rank
        # r's q heads read KV heads [r KV / tp, (r + 1) KV / tp) when tp
        # divides KV, so a caller that drops k/v has the rank project
        # those alone (as XLA partitions the reference's projection)
        src = x if kv_x is None else kv_x
        own_kv = ctx.tp > 1 and KV % ctx.tp == 0 and not kv_out
        kvw = ((lambda n, dim: param_tp_block(p, n, ctx, dim)) if own_kv
               else (lambda n, dim: param(p, n, ctx)))
        q = torch.einsum("bld,dnh->blnh", x,
                         param_tp_block(p, "wq", ctx, 1))
        k = torch.einsum("bsd,dnh->bsnh", src, kvw("wk", 1))
        v = torch.einsum("bsd,dnh->bsnh", src, kvw("wv", 1))
        if p.get("bq") is not None:
            q = q + param_tp_block(p, "bq", ctx, 0)
            k = k + kvw("bk", 0)
            v = v + kvw("bv", 0)
        if use_rope and kv_x is None:
            pos = _positions(B, 0, L, x.device)
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        group = H // KV
        kr, vr = k, v
        if ctx.tp > 1:
            if group > 1:
                kr = kr.repeat_interleave(group, dim=2)
                vr = vr.repeat_interleave(group, dim=2)
            if not own_kv:
                kr = col.local_block(kr, mesh, tp, 2)
                vr = col.local_block(vr, mesh, tp, 2)
        out = gqa_scores_ctx(q, kr, vr, causal=is_causal,
                             window=cfg.attn_window, q_offset=0)
        y = torch.einsum("blnh,nhd->bld", out,
                         param_tp_block(p, "wo", ctx, 0))
        return tp_combine(y, ctx, L), ((k, v) if kv_out else None)
    if sp:
        # sequence-parallel attention: this rank's L / tp query rows at
        # offset r * L / tp against the full K/V
        l_loc = L // ctx.tp
        off = ctx.tp_rank * l_loc
        x_loc = x if weightgather else col.local_block(x, mesh, tp, 1)
        if kv_x is None:
            q, k, v = _qkv(p, x_loc, x_loc, ctx)
            if use_rope:
                pos = _positions(B, off, l_loc, x.device)
                q = rope(q, pos, cfg.rope_theta)
                k = rope(k, pos, cfg.rope_theta)
            k = col.all_gather(k, mesh, tp, 1)
            v = col.all_gather(v, mesh, tp, 1)
        else:
            q, k, v = _qkv(p, x_loc, kv_x, ctx)
        out = gqa_scores_ctx(q, k, v, causal=is_causal,
                             window=cfg.attn_window, q_offset=off,
                             chunk=seq_chunk(B, H, k.shape[1], l_loc))
        return torch.einsum("blnh,nhd->bld", out, param(p, "wo", ctx)), (k, v)
    # tiny L (cross-attention during decode): replicated compute
    src = x if kv_x is None else kv_x
    q, k, v = _qkv(p, x, src, ctx)
    if use_rope and kv_x is None:
        pos = _positions(B, 0, L, x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    out = gqa_scores_ctx(q, k, v, causal=is_causal, window=cfg.attn_window,
                         q_offset=0)
    return torch.einsum("blnh,nhd->bld", out, param(p, "wo", ctx)), (k, v)


def decode_attention(p, x, cache_k, cache_v, cache_len: int, *, cfg,
                     ctx=None, kv_sharded: bool = False):
    """One-token decode. x: (B, 1, d); cache: (B, S, KV, hd). The new K/V
    row goes into slot `cache_len % S` for a windowed cache (a ring
    buffer), `min(cache_len, S - 1)` otherwise, and positions up to
    `min(cache_len, S - 1)` are attended to. Writes the row into
    `cache_k`/`cache_v` in place and returns y, (cache_k, cache_v).

    kv_sharded: the cache given is this model rank's S / tp rows (the
    reference's "kv_len" spec); the softmax then runs across ranks."""
    B = x.shape[0]
    H, KV, hd = cfg.heads, cfg.kv_heads, cfg.head_dim
    S_loc = cache_k.shape[1]
    shards = ctx.tp if (ctx is not None and kv_sharded) else 1
    r = ctx.tp_rank if shards > 1 else 0
    S = S_loc * shards
    q, k, v = (_proj(p, x, "q", ctx), _proj(p, x, "k", ctx),
               _proj(p, x, "v", ctx))
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    slot = cache_len % S if cfg.attn_window else min(cache_len, S - 1)
    if slot // S_loc == r:                  # the rank that owns the slot
        cache_k[:, slot - r * S_loc] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - r * S_loc] = v[:, 0].to(cache_v.dtype)
    group = H // KV
    qg = q.reshape(B, 1, KV, group, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qg.to(F32),
                     cache_k.to(F32)) * hd ** -0.5
    kpos = r * S_loc + torch.arange(S_loc, device=x.device)
    valid = kpos <= min(cache_len, S - 1)
    s = torch.where(valid[None, None, None, None, :], s, NEG)
    if shards == 1:
        pattn = torch.softmax(s, dim=-1).to(cache_v.dtype)
        out = torch.einsum("bqkgs,bskh->bqkgh", pattn, cache_v)
    else:
        mesh, tp = ctx.mesh, ctx.tp_axis
        m = col.all_reduce_max(torch.amax(s, dim=-1, keepdim=True), mesh, tp)
        e = torch.exp(s - m)
        den = col.all_reduce(torch.sum(e, dim=-1, keepdim=True), mesh, tp)
        pattn = (e / den).to(cache_v.dtype)
        part = torch.einsum("bqkgs,bskh->bqkgh", pattn.to(F32),
                            cache_v.to(F32))
        out = col.all_reduce(part, mesh, tp).to(cache_v.dtype)
    out = out.reshape(B, 1, H, hd)
    if ctx is None or not _tp_split(p, "wo", 0, ctx):
        y = torch.einsum("blnh,nhd->bld", out, param(p, "wo", ctx))
    else:
        # the rank's heads through its rows of wo, in float32, summed
        # over `model` and rounded once (one device's float32 accumulation)
        part = torch.einsum("blnh,nhd->bld",
                            col.local_block(out, ctx.mesh, ctx.tp_axis,
                                            2).to(F32),
                            param_tp_block(p, "wo", ctx, 0).to(F32))
        y = col.all_reduce(part, ctx.mesh, ctx.tp_axis).to(out.dtype)
    return y, (cache_k, cache_v)


def _tp_split(p, name, dim, ctx) -> bool:
    """Whether leaf `name` is stored split over a model axis of more than
    one process along `dim` (the serving specs keep the heads split)."""
    return ctx.tp > 1 and ctx.tp_axis in entry_axes(p.specs[name][dim])


def _proj(p, x, which, ctx):
    """One decode step's q, k or v (B, 1, heads, hd), whole heads. Where
    the weight's heads are split over `model`, each rank projects its own
    heads and the few rows of activations are gathered, not the weight."""
    w, b = "w" + which, "b" + which
    has_b = p.get(b) is not None
    if ctx is None or not _tp_split(p, w, 1, ctx):
        y = torch.einsum("bld,dnh->blnh", x, param(p, w, ctx))
        return y + param(p, b, ctx) if has_b else y
    y = torch.einsum("bld,dnh->blnh", x, param_tp_block(p, w, ctx, 1))
    if has_b:
        y = y + param_tp_block(p, b, ctx, 0)
    return col.all_gather(y, ctx.mesh, ctx.tp_axis, 2)
