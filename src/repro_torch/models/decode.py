"""Serving paths: prefill (build cache) and decode (one token, cached).

Cache layout (leaves stacked over layers, mirroring the parameters; the
reference's layout, so that caches convert leaf for leaf):
  dense/moe/vlm : {"k","v"}: (L, B, S, KV, hd)
  audio         : decoder self-attn cache + precomputed encoder states
  hybrid        : mamba (S, conv) states per block + shared-attn K/V per group
  ssm           : mLSTM (S, n) + sLSTM (h, c, n, m) states

Windowed attention (mixtral, zamba2's shared block) allocates S = window
and `decode_attention` ring-buffers into it. `decode` writes the new state
into the cache it is given (in place: the reference returns a new cache;
a served wave holds one) and returns it.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import matmul_f32, rms_norm
from .config import ModelConfig
from .params import ParamDef, torch_dtype, tree_map
from .transformer import (CONV_K, LanguageModel, hybrid_layout, xlstm_layout)

PyTree = Any


def _pd(shape, logical, dtype):
    return ParamDef(tuple(int(s) for s in shape), tuple(logical), dtype=dtype)


def cache_defs(cfg: ModelConfig, batch: int, cache_len: int) -> PyTree:
    """ParamDef tree of the decode cache."""
    dt = cfg.param_dtype
    B, d = batch, cfg.d_model
    S = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
    KV, hd = cfg.kv_heads, cfg.head_dim
    kv = lambda L: {"k": _pd((L, B, S, KV, hd),
                             (None, "batch", "kv_len", None, None), dt),
                    "v": _pd((L, B, S, KV, hd),
                             (None, "batch", "kv_len", None, None), dt)}
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = di // H
    mamba = lambda *lead: {
        "S": _pd((*lead, B, H, p, N), (*(None,) * len(lead), "batch",
                                       None, None, None), "float32"),
        "conv": _pd((*lead, B, CONV_K - 1, di + 2 * N),
                    (*(None,) * len(lead), "batch", None, None), dt)}
    if cfg.family in ("dense", "moe", "vlm"):
        return kv(cfg.layers)
    if cfg.family == "audio":
        return {"self": kv(cfg.decoder_layers),
                "enc": _pd((B, cache_len, d), ("batch", None, None), dt)}
    if cfg.family == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        return {"mamba_groups": mamba(groups, per),
                "mamba_tail": mamba(tail),
                "attn": {"k": _pd((groups, B, S, KV, hd),
                                  (None, "batch", "kv_len", None, None), dt),
                         "v": _pd((groups, B, S, KV, hd),
                                  (None, "batch", "kv_len", None, None), dt)}}
    if cfg.family == "ssm":
        groups, per = xlstm_layout(cfg)
        H2 = cfg.heads
        p2 = di // H2
        return {"mlstm": {
                    "S": _pd((groups, per, B, H2, p2, p2),
                             (None, None, "batch", None, "tp", None),
                             "float32"),
                    "n": _pd((groups, per, B, H2, p2),
                             (None, None, "batch", None, "tp"), "float32")},
                "slstm": {k: _pd((groups, B, d), (None, "batch", None),
                                 "float32") for k in ("h", "c", "n", "m")}}
    raise ValueError(cfg.family)


def zeros_cache(defs: PyTree, device) -> PyTree:
    return tree_map(lambda d: torch.zeros(d.shape, dtype=torch_dtype(d.dtype),
                                          device=device), defs)


def cache_from_reference(cfg: ModelConfig, tree: PyTree, device=None):
    """The reference's cache pytree (nested dicts of numpy arrays in any
    float dtype numpy can cast to float32) as the port's cache on
    `device` (CUDA unless the caller asks for the CPU; raises without a
    card), each leaf in `cache_defs`' dtype."""
    from ..core.replay import resolve_device
    device = resolve_device(device)
    dtypes = cache_defs(cfg, 1, 1)
    return tree_map(
        lambda d, a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=device, dtype=torch_dtype(d.dtype)), dtypes, tree)


def _stack_states(states, names):
    """[(s0, s1, ...)] per block -> {name: stacked over blocks}."""
    return {n: torch.stack([s[i] for s in states])
            for i, n in enumerate(names)}


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _fit_kv(k, v, S, window):
    """Keep the last S rows of a windowed cache, pad a short one to S."""
    L = k.shape[1]
    if window and L > S:
        return k[:, L - S:], v[:, L - S:]
    if L < S:
        pad = (0, 0, 0, 0, 0, S - L)
        return F.pad(k, pad), F.pad(v, pad)
    return k, v


def _prefill_kv_stack(blocks, x, *, cfg, S, causal=True, cross=None):
    """Run blocks, returning hidden + per-layer (k, v) padded to S."""
    dt = torch_dtype(cfg.param_dtype)
    ks, vs = [], []
    for blk in blocks:
        x, (k, v) = blk(x, causal=causal, cross=cross)
        k, v = _fit_kv(k, v, S, cfg.attn_window)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _logits(model: LanguageModel, x):
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    return matmul_f32(x[:, -1], model.unembed)


def prefill(model: LanguageModel, batch) -> Tuple[torch.Tensor, PyTree]:
    """Returns (last-position logits (B, Vpad) in float32, cache)."""
    cfg = model.cfg
    fam = cfg.family
    tokens = batch["tokens"]
    B, L = tokens.shape
    S = min(L, cfg.attn_window) if cfg.attn_window else L
    if fam in ("dense", "moe", "vlm"):
        x = model.embed_tokens(tokens)
        if fam == "vlm" and batch.get("patches") is not None:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        x, cache = _prefill_kv_stack(model.blocks, x, cfg=cfg,
                                     S=S if cfg.attn_window else x.shape[1])
    elif fam == "audio":
        from .transformer import decoder_stack
        enc = decoder_stack(model.enc_blocks, batch["frames"], causal=False)
        enc = rms_norm(enc, model.enc_norm, cfg.norm_eps)
        x, kvc = _prefill_kv_stack(model.dec_blocks,
                                   model.embed_tokens(tokens), cfg=cfg, S=S,
                                   cross=enc)
        cache = {"self": kvc, "enc": enc}
    elif fam == "hybrid":
        x = model.embed_tokens(tokens)
        dt = torch_dtype(cfg.param_dtype)
        mg, ks, vs = [], [], []
        for group in model.mamba_groups:
            states = []
            for blk in group:
                x, st = blk(x)
                states.append(st)
            mg.append(_stack_states(states, ("S", "conv")))
            x, (k, v) = model.shared_attn(x)
            if k.shape[1] > S:
                k, v = k[:, -S:], v[:, -S:]
            ks.append(k.to(dt))
            vs.append(v.to(dt))
        tail = []
        for blk in model.mamba_tail:
            x, st = blk(x)
            tail.append(st)
        cache = {"mamba_groups": {n: torch.stack([g[n] for g in mg])
                                  for n in ("S", "conv")},
                 "mamba_tail": _stack_states(tail, ("S", "conv")),
                 "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    elif fam == "ssm":
        x = model.embed_tokens(tokens)
        ms, ss = [], []
        for group, sblk in zip(model.mlstm_groups, model.slstm_blocks):
            states = []
            for blk in group:
                x, st = blk(x)
                states.append(st)
            ms.append(_stack_states(states, ("S", "n")))
            x, st = sblk(x)
            ss.append(st)
        cache = {"mlstm": {n: torch.stack([g[n] for g in ms])
                           for n in ("S", "n")},
                 "slstm": _stack_states(ss, ("h", "c", "n", "m"))}
    else:
        raise ValueError(fam)
    return _logits(model, x), cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _step_states(blocks, x, cache, names, idx=()):
    """One token through recurrent blocks whose states are the cache's
    leaves at [*idx, i]; each new state is written back in place."""
    for i, blk in enumerate(blocks):
        state = tuple(cache[n][(*idx, i)] for n in names)
        x, new = blk(x, state=state, decode=True)
        for n, s in zip(names, new):
            cache[n][(*idx, i)].copy_(s)
    return x


def decode(model: LanguageModel, cache: PyTree, token, cache_len: int
           ) -> Tuple[torch.Tensor, PyTree]:
    """One-token step. token: (B, 1) integer; cache_len: the token's
    position. Returns (logits (B, Vpad) in float32, cache), the cache
    updated in place."""
    cfg = model.cfg
    fam = cfg.family
    x = model.embed_tokens(token)
    if fam in ("dense", "moe", "vlm"):
        for i, blk in enumerate(model.blocks):
            x, _ = blk.decode(x, {"k": cache["k"][i], "v": cache["v"][i]},
                              cache_len)
    elif fam == "audio":
        kv = cache["self"]
        for i, blk in enumerate(model.dec_blocks):
            x, _ = blk.decode(x, {"k": kv["k"][i], "v": kv["v"][i]},
                              cache_len, cross=cache["enc"])
    elif fam == "hybrid":
        ac = cache["attn"]
        for g, group in enumerate(model.mamba_groups):
            x = _step_states(group, x, cache["mamba_groups"], ("S", "conv"),
                             (g,))
            x, _ = model.shared_attn.decode(
                x, {"k": ac["k"][g], "v": ac["v"][g]}, cache_len)
        x = _step_states(model.mamba_tail, x, cache["mamba_tail"],
                         ("S", "conv"))
    elif fam == "ssm":
        for g, (group, sblk) in enumerate(zip(model.mlstm_groups,
                                              model.slstm_blocks)):
            x = _step_states(group, x, cache["mlstm"], ("S", "n"), (g,))
            x = _step_states([sblk], x,
                             {n: cache["slstm"][n][g:g + 1]
                              for n in ("h", "c", "n", "m")},
                             ("h", "c", "n", "m"))
    else:
        raise ValueError(fam)
    return _logits(model, x), cache
