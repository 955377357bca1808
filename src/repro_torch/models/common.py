"""Shared model pieces: norms, RoPE, activations, chunked cross-entropy."""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import collectives as col

F32 = torch.float32


_REMAT = threading.local()


@contextlib.contextmanager
def _in_remat():
    """Marks a remat's forward and its recompute (for `flat`)."""
    depth = getattr(_REMAT, "depth", 0)
    _REMAT.depth = depth + 1
    try:
        yield
    finally:
        _REMAT.depth = depth


def flat(fn):
    """Marks fn for `remat` to run plainly inside another remat (its
    forward or its recompute), so the enclosing recompute keeps fn's
    activations for the backward: fn's forward then runs twice in a
    training step, not three times as nested checkpoints run it."""
    fn.remat_flat = True
    return fn


def remat(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its activations recomputed in the backward
    instead of kept, where the reference puts a `jax.checkpoint`; a plain
    call when autograd is not recording (serving), or for a `flat` fn
    inside another remat. Remat changes memory, not numbers; the forward
    draws no random numbers, so no RNG state is stashed."""
    if not torch.is_grad_enabled() or (
            getattr(fn, "remat_flat", False) and getattr(_REMAT, "depth", 0)):
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (_in_remat(), _in_remat()), **kwargs)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5):
    xf = x.to(F32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6):
    """x: (..., L, H, hd); positions: (..., L) integer. Rotate-half RoPE;
    the angles in float32, cos and sin cast to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(half, dtype=F32, device=x.device)
    freqs = 1.0 / (theta ** (ar / half))
    # angles: (..., L, 1, half) — broadcast over the heads axis
    ang = positions[..., :, None, None].to(F32) * freqs
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def swiglu(gate_up: torch.Tensor):
    g, u = gate_up.chunk(2, dim=-1)
    return F.silu(g.to(F32)).to(u.dtype) * u


def gelu(x):
    """The tanh form, as `jax.nn.gelu`'s default."""
    return F.gelu(x.to(F32), approximate="tanh").to(x.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32 result (the reference's
    `preferred_element_type=float32`): both operands in float32."""
    return torch.matmul(a.to(F32), b.to(F32))


def chunked_cross_entropy(x: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, *, true_vocab: int,
                          chunk: int = 512,
                          mask: Optional[torch.Tensor] = None,
                          ctx=None, parts: bool = False):
    """Mean CE without materializing (B, L, V) logits.

    x: (B, L, d) final hidden; unembed: (d, Vpad); labels: (B, L) integer.
    A loop over L-chunks keeps peak memory at (B, chunk, Vpad), and under
    autograd each chunk's logits are recomputed in the backward (as the
    reference's checkpointed scan body), so the backward too holds one
    chunk; padded vocab entries are masked to -1e30. mask: (B, L) 1.0 =
    count this token. As in the reference, only the first
    (L // chunk) * chunk tokens of a sequence count: the last L % chunk
    are skipped.

    ctx: `unembed` is this model rank's block of the vocabulary columns
    (vocab-parallel): the log-sum-exp takes its maximum and its sum over
    `model`, and the gold logit comes from the rank that holds it.
    parts: return (the sum of the token losses, the token count) instead
    of their quotient.
    """
    B, L, d = x.shape
    V = unembed.shape[1]
    chunk = min(chunk, L)
    n = L // chunk
    lo = ctx.tp_rank * V if ctx is not None else 0
    vocab_ok = lo + torch.arange(V, device=x.device) < true_vocab
    neg = torch.tensor(-1e30, dtype=F32, device=x.device)

    def chunk_loss(xc, yc, mc):
        logits = torch.where(vocab_ok, matmul_f32(xc, unembed), neg)
        if ctx is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
            return torch.sum((lse - gold) * mc)
        mesh, tp = ctx.mesh, ctx.tp_axis
        m = col.all_reduce_max(torch.amax(logits, dim=-1), mesh, tp)
        lse = torch.log(col.all_reduce(
            torch.sum(torch.exp(logits - m[..., None]), dim=-1), mesh,
            tp)) + m
        ids = yc.long() - lo
        mine = (ids >= 0) & (ids < V)
        gold = torch.gather(logits, -1, torch.where(mine, ids, 0)[..., None])
        gold = col.all_reduce(torch.where(mine, gold[..., 0], 0.0), mesh, tp)
        return torch.sum((lse - gold) * mc)

    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        mc = (mask[:, sl].to(F32) if mask is not None
              else torch.ones((B, chunk), dtype=F32, device=x.device))
        tot = tot + remat(chunk_loss, x[:, sl], labels[:, sl], mc)
        cnt = cnt + torch.sum(mc)
    if parts:
        return tot, cnt
    return tot / torch.clamp(cnt, min=1.0)
