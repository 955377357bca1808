"""GQA attention: query-chunked prefill, cached decode, windows.

The full-sequence pass loops over query chunks of 256 with the full K/V
per chunk (peak memory chunk x S instead of L x S; under autograd a
chunk's scores are recomputed in the backward); causal and window
masks come from absolute positions, scores and softmax in float32, the
probabilities cast to v's dtype, as in the reference
(`repro/models/attention.py`). Written in plain PyTorch ops rather than
`scaled_dot_product_attention`, so the masks and casts are the
reference's. The sharded branches wait for the sharding slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import F32, remat, rope

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


def _qkv(p, x, src):
    q = torch.einsum("bld,dnh->blnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", src, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", src, p["wv"])
    if p.get("bq") is not None:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def attention(p, x, *, cfg, causal: bool = True,
              kv_x: Optional[torch.Tensor] = None, use_rope: bool = True):
    """Full-sequence attention (train / prefill). x: (B, L, d); p maps
    wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d) and, with QKV bias,
    bq/bk/bv. kv_x: the encoder states of a cross-attention. Returns
    (y, (k, v))."""
    B, L, d = x.shape
    src = x if kv_x is None else kv_x
    q, k, v = _qkv(p, x, src)
    if use_rope and kv_x is None:
        pos = torch.broadcast_to(torch.arange(L, device=x.device), (B, L))
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    out = gqa_scores_ctx(q, k, v, causal=causal and kv_x is None,
                         window=cfg.attn_window, q_offset=0)
    y = torch.einsum("blnh,nhd->bld", out, p["wo"])
    return y, (k, v)


def decode_attention(p, x, cache_k, cache_v, cache_len: int, *, cfg):
    """One-token decode. x: (B, 1, d); cache: (B, S, KV, hd). The new K/V
    row goes into slot `cache_len % S` for a windowed cache (a ring
    buffer), `min(cache_len, S - 1)` otherwise, and positions up to
    `min(cache_len, S - 1)` are attended to. Writes the row into
    `cache_k`/`cache_v` in place and returns y, (cache_k, cache_v)."""
    B = x.shape[0]
    H, KV, hd = cfg.heads, cfg.kv_heads, cfg.head_dim
    S = cache_k.shape[1]
    q, k, v = _qkv(p, x, x)
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    slot = cache_len % S if cfg.attn_window else min(cache_len, S - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    group = H // KV
    qg = q.reshape(B, 1, KV, group, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qg.to(F32),
                     cache_k.to(F32)) * hd ** -0.5
    valid = torch.arange(S, device=x.device) <= min(cache_len, S - 1)
    s = torch.where(valid[None, None, None, None, :], s, NEG)
    pattn = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bqkgs,bskh->bqkgh", pattn, cache_v)
    out = out.reshape(B, 1, H, hd)
    y = torch.einsum("blnh,nhd->bld", out, p["wo"])
    return y, (cache_k, cache_v)
