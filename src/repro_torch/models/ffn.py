"""Dense SwiGLU FFN and Mixture-of-Experts with capacity-based dispatch
(the reference's single-device `_moe_local` path; its shard_map path waits
for the sharding slice).

Dispatch: top-k experts per token by a stable descending sort (ties go to
the lower expert index, as `jax.lax.top_k` breaks them), each (token,
expert) pair's position within its expert by a one-hot cumsum in the
flattened token-major order, pairs at or past the capacity dropped, the
kept ones scattered into an (E, C, d) buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import matmul_f32, swiglu


def dense_ffn(p, x):
    """x: (B, L, d); p: w_up (d, 2*dff) [gate|up], w_down (dff, d)."""
    return torch.matmul(swiglu(torch.matmul(x, p["w_up"])), p["w_down"])


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


def moe_local(x, wr, w_up, w_down, *, k: int, capacity: int):
    """Per-device MoE block. x: (T, d); wr: (d, E); w_up: (E, d, 2F);
    w_down: (E, F, d)."""
    T, d = x.shape
    E = wr.shape[1]
    flat_e, pos, keep, topv = moe_dispatch(x, wr, k=k,
                                           capacity=capacity)
    slot = torch.where(keep, pos, 0)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    # kept (e, pos) pairs are unique; a dropped pair adds 0 to slot 0
    buf = torch.zeros((E, capacity, d), dtype=x.dtype, device=x.device)
    contrib = torch.where(keep[:, None], x[tok], 0)
    buf.index_put_((flat_e, slot), contrib, accumulate=True)

    h = swiglu(torch.bmm(buf, w_up))
    y_e = torch.bmm(h, w_down)                             # (E, C, d)
    gathered = y_e[flat_e, slot]                           # (T*k, d)
    w = torch.where(keep, topv.reshape(-1), 0.0).to(y_e.dtype)
    parts = (gathered * w[:, None]).reshape(T, k, d)
    # the weighted combine, each token's k parts added in order from zero:
    # the reference's scatter-add order, and deterministic on the card
    # (index_add_ there adds with atomics in no fixed order)
    y = torch.zeros((T, d), dtype=y_e.dtype, device=x.device)
    for j in range(k):
        y = y + parts[:, j]
    return y


def moe_capacity(tokens: int, cfg) -> int:
    return max(1, int(tokens * cfg.top_k / cfg.num_experts
                      * cfg.moe_capacity_factor))


def moe_ffn(p, x, *, cfg):
    """x: (B, L, d) -> (B, L, d). p: wr (d, E), w_up (E, d, 2F),
    w_down (E, F, d)."""
    B, L, d = x.shape
    y = moe_local(x.reshape(B * L, d), p["wr"], p["w_up"], p["w_down"],
                  k=cfg.top_k, capacity=moe_capacity(B * L, cfg))
    return y.reshape(B, L, d).to(x.dtype)
