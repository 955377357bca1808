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

Under a mesh context (`ctx`, `ctx.batch` the global batch) both take this
process's batch rows and return the global logits on every process;
`prefill` returns this process's blocks of the cache as a
`params.Sharded` tree that carries the cache's specs
(`cache_specs`: the K/V length sharded over `model` where it divides,
the reference's `cache_shardings`), and `decode` reads and writes such a
cache. The K/V decode runs on the sharded length (`decode_attention`);
a recurrent state sharded over `model` (the mLSTM's) is gathered for its
step and its block written back.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dist import collectives as col
from ..dist.sharding import entry_axes
from .common import matmul_f32, rms_norm
from .config import ModelConfig
from .params import (ParamDef, Sharded, shard_leaf, torch_dtype,
                     tree_map, tree_specs)
from .spmd import batch_sharded, param, res_shard, rows_gather
from .transformer import (CONV_K, LanguageModel, hybrid_layout, vocab_sharded,
                          xlstm_layout)

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


def cache_specs(cfg: ModelConfig, ctx, batch: int, cache_len: int) -> PyTree:
    """The cache's spec tree on `ctx`'s mesh (the reference's
    `cache_shardings`): a batch the dp axes do not divide is replicated,
    and "kv_len" shards over `model` where S divides."""
    defs = cache_defs(cfg, batch, cache_len)
    if batch % ctx.dp:
        defs = tree_map(lambda d: ParamDef(
            d.shape, tuple(None if a == "batch" else a for a in d.logical),
            d.init, d.scale, d.dtype), defs)
    return tree_specs(defs, ctx)


def shard_cache(cache: PyTree, specs: PyTree, ctx) -> Sharded:
    """This process's blocks of a cache whose batch rows are already this
    process's: cut along every other axis its spec shards."""
    skip = tuple(ctx.dp_axes)
    return Sharded(tree_map(lambda t, sp: shard_leaf(t, sp, ctx.mesh, skip),
                            cache, specs), specs)


def _tp_axes(spec, ctx):
    """The dims of a cache leaf's spec sharded over `model`."""
    return [i for i, e in enumerate(spec) if ctx.tp_axis in entry_axes(e)]


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


def _prefill_kv_stack(blocks, x, *, cfg, S, ctx=None, causal=True,
                      cross=None):
    """Run blocks, returning hidden + per-layer (k, v) padded to S."""
    dt = torch_dtype(cfg.param_dtype)
    L = x.shape[1]
    x = res_shard(x, ctx)
    ks, vs = [], []
    for blk in blocks:
        x, (k, v) = blk(x, ctx=ctx, causal=causal, cross=cross, seq_len=L)
        k, v = _fit_kv(k, v, S, cfg.attn_window)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    return rows_gather(x, ctx, L), {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}


def _logits(model: LanguageModel, x, ctx=None):
    """Last-position logits (B, Vpad) in float32; under `ctx` the global
    batch's, gathered from the vocabulary blocks and the dp rows."""
    x = rms_norm(x, model.leaf("final_norm", ctx), model.cfg.norm_eps)
    if ctx is None:
        return matmul_f32(x[:, -1], model.unembed)
    vocab_tp = vocab_sharded(model, "unembed", 1, ctx)
    w = param(model._named(), "unembed", ctx,
              keep=(ctx.tp_axis,) if vocab_tp else ())
    logits = matmul_f32(x[:, -1], w)
    if vocab_tp:
        logits = col.all_gather(logits, ctx.mesh, ctx.tp_axis, 1)
    if batch_sharded(ctx, ctx.batch):
        logits = col.all_gather(logits, ctx.mesh, ctx.dp_axes, 0)
    return logits


def prefill(model: LanguageModel, batch, ctx=None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Returns (last-position logits (B, Vpad) in float32, cache)."""
    cfg = model.cfg
    fam = cfg.family
    tokens = batch["tokens"]
    B, L = tokens.shape
    S = min(L, cfg.attn_window) if cfg.attn_window else L
    S_alloc = S
    if fam in ("dense", "moe", "vlm"):
        x = model.embed_tokens(tokens, ctx)
        if fam == "vlm" and batch.get("patches") is not None:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        S_alloc = S if cfg.attn_window else x.shape[1]
        x, cache = _prefill_kv_stack(model.blocks, x, cfg=cfg, ctx=ctx,
                                     S=S_alloc)
    elif fam == "audio":
        from .transformer import decoder_stack
        enc = decoder_stack(model.enc_blocks, batch["frames"], ctx=ctx,
                            causal=False)
        enc = rms_norm(enc, model.leaf("enc_norm", ctx), cfg.norm_eps)
        x, kvc = _prefill_kv_stack(model.dec_blocks,
                                   model.embed_tokens(tokens, ctx), cfg=cfg,
                                   ctx=ctx, S=S, cross=enc)
        cache = {"self": kvc, "enc": enc}
    elif fam == "hybrid":
        x = res_shard(model.embed_tokens(tokens, ctx), ctx)
        dt = torch_dtype(cfg.param_dtype)
        mg, ks, vs = [], [], []
        for group in model.mamba_groups:
            states = []
            for blk in group:
                x, st = blk(x, ctx=ctx, seq_len=L)
                states.append(st)
            mg.append(_stack_states(states, ("S", "conv")))
            x, (k, v) = model.shared_attn(x, ctx=ctx, seq_len=L)
            if k.shape[1] > S:
                k, v = k[:, -S:], v[:, -S:]
            ks.append(k.to(dt))
            vs.append(v.to(dt))
        tail = []
        for blk in model.mamba_tail:
            x, st = blk(x, ctx=ctx, seq_len=L)
            tail.append(st)
        x = rows_gather(x, ctx, L)
        cache = {"mamba_groups": {n: torch.stack([g[n] for g in mg])
                                  for n in ("S", "conv")},
                 "mamba_tail": _stack_states(tail, ("S", "conv")),
                 "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    elif fam == "ssm":
        x = res_shard(model.embed_tokens(tokens, ctx), ctx)
        ms, ss = [], []
        for group, sblk in zip(model.mlstm_groups, model.slstm_blocks):
            states = []
            for blk in group:
                x, st = blk(x, ctx=ctx, seq_len=L)
                states.append(st)
            ms.append(_stack_states(states, ("S", "n")))
            x, st = sblk(x, ctx=ctx, seq_len=L)
            ss.append(st)
        x = rows_gather(x, ctx, L)
        cache = {"mlstm": {n: torch.stack([g[n] for g in ms])
                           for n in ("S", "n")},
                 "slstm": _stack_states(ss, ("h", "c", "n", "m"))}
    else:
        raise ValueError(fam)
    logits = _logits(model, x, ctx)
    if ctx is not None:
        cache = shard_cache(cache, cache_specs(cfg, ctx, ctx.batch, S_alloc),
                            ctx)
    return logits, cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _step_states(blocks, x, cache, names, idx=(), ctx=None, specs=None):
    """One token through recurrent blocks whose states are the cache's
    leaves at [*idx, i]; each new state is written back in place. Under
    `ctx` a state leaf whose spec shards it over `model` is gathered for
    the step and this rank's block of the new state written back."""
    n_idx = len(idx) + 1
    for i, blk in enumerate(blocks):
        state = []
        for n in names:
            t = cache[n][(*idx, i)]
            if ctx is not None:
                for dim in _tp_axes(specs[n], ctx):
                    t = col._raw_all_gather(ctx.mesh, (ctx.tp_axis,), t,
                                            dim - n_idx)
            state.append(t)
        x, new = blk(x, ctx=ctx, state=tuple(state), decode=True)
        for n, s in zip(names, new):
            if ctx is not None:
                for dim in _tp_axes(specs[n], ctx):
                    s = col.local_block(s, ctx.mesh, ctx.tp_axis, dim - n_idx)
            cache[n][(*idx, i)].copy_(s)
    return x


def decode(model: LanguageModel, cache: PyTree, token, cache_len: int,
           ctx=None) -> Tuple[torch.Tensor, PyTree]:
    """One-token step. token: (B, 1) integer; cache_len: the token's
    position. Returns (logits (B, Vpad) in float32, cache), the cache
    updated in place. Under `ctx`, `cache` is a `Sharded` cache."""
    cfg = model.cfg
    fam = cfg.family
    specs = None
    if ctx is not None:
        if not isinstance(cache, Sharded):
            raise TypeError("a sharded decode takes the Sharded cache of "
                            "prefill_step(ctx) or init_cache(ctx=...)")
        specs = cache.specs
    kv_sharded = lambda sp: (ctx is not None
                             and bool(_tp_axes(sp["k"], ctx)))
    x = model.embed_tokens(token, ctx)
    if fam in ("dense", "moe", "vlm"):
        shard = kv_sharded(specs) if specs else False
        for i, blk in enumerate(model.blocks):
            x, _ = blk.decode(x, {"k": cache["k"][i], "v": cache["v"][i]},
                              cache_len, ctx=ctx, kv_sharded=shard)
    elif fam == "audio":
        kv = cache["self"]
        shard = kv_sharded(specs["self"]) if specs else False
        for i, blk in enumerate(model.dec_blocks):
            x, _ = blk.decode(x, {"k": kv["k"][i], "v": kv["v"][i]},
                              cache_len, ctx=ctx, cross=cache["enc"],
                              kv_sharded=shard)
    elif fam == "hybrid":
        ac = cache["attn"]
        shard = kv_sharded(specs["attn"]) if specs else False
        for g, group in enumerate(model.mamba_groups):
            x = _step_states(group, x, cache["mamba_groups"], ("S", "conv"),
                             (g,), ctx, specs and specs["mamba_groups"])
            x, _ = model.shared_attn.decode(
                x, {"k": ac["k"][g], "v": ac["v"][g]}, cache_len, ctx=ctx,
                kv_sharded=shard)
        x = _step_states(model.mamba_tail, x, cache["mamba_tail"],
                         ("S", "conv"), (), ctx, specs and specs["mamba_tail"])
    elif fam == "ssm":
        for g, (group, sblk) in enumerate(zip(model.mlstm_groups,
                                              model.slstm_blocks)):
            x = _step_states(group, x, cache["mlstm"], ("S", "n"), (g,), ctx,
                             specs and specs["mlstm"])
            x = _step_states([sblk], x,
                             {n: cache["slstm"][n][g:g + 1]
                              for n in ("h", "c", "n", "m")},
                             ("h", "c", "n", "m"), (), ctx,
                             specs and specs["slstm"])
    else:
        raise ValueError(fam)
    return _logits(model, x, ctx), cache
