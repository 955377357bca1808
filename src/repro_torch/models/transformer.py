"""Model assembly for all 10 assigned architectures.

`model_defs(cfg)` is the reference's parameter tree (`ParamDef` leaves
stacked over layers, and over groups for the hybrid and ssm families), so
that its parameters convert leaf for leaf. `LanguageModel(cfg, tree)`
turns a tree of tensors of those shapes into modules: one `nn.Module` per
block, an `nn.ModuleList` per stack (groups nested for hybrid and ssm),
and for zamba2 one shared attention block. The block functions take the block's
parameters by the reference's names (`p["wq"]`), so they read as the
reference's; the layer scans are Python loops.

Each block's parameters are views of the stacked leaves, and the model
keeps the stacked tree (`LanguageModel.tree`): the optimizer and the
checkpoint work on that tree, as the reference's do, and an in-place
update of a leaf moves every block's view of it. Under autograd each
block of a decoder stack and of the mamba tail, and each group of a
hybrid or ssm stack, is recomputed in the backward, where the reference
checkpoints its layer scans.

Layout: decoder-only (dense/moe/vlm), enc-dec (audio), hybrid, ssm.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..dist import collectives as col
from ..dist.sharding import PartitionSpec, entry_axes
from .attention import attention, decode_attention
from .common import chunked_cross_entropy, remat, rms_norm
from .config import ModelConfig
from .ffn import dense_ffn, moe_ffn
from .params import ParamDef, Sharded, tree_leaves, tree_map
from .spmd import (batch_sharded, loss_copies, param, res_gather, res_shard,
                   rows_gather)
from .ssm import (mamba2_decode, mamba2_forward, mlstm_decode, mlstm_forward,
                  slstm_decode, slstm_forward)

PyTree = Any
CONV_K = 4


def _pd(shape, logical, **kw):
    return ParamDef(tuple(int(s) for s in shape), tuple(logical), **kw)


def _stack(defs: PyTree, n: int) -> PyTree:
    """Prepend a layer axis to every leaf."""
    if isinstance(defs, dict):
        return {k: _stack(v, n) for k, v in defs.items()}
    return ParamDef((n,) + defs.shape, (None,) + defs.logical, defs.init,
                    defs.scale, defs.dtype)


# --------------------------------------------------------------------------
# per-block ParamDefs
# --------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, dt: str) -> Dict[str, ParamDef]:
    d, H, KV, hd = cfg.d_model, cfg.heads, cfg.kv_heads, cfg.head_dim
    defs = {
        "wq": _pd((d, H, hd), ("fsdp", "tp", None), dtype=dt),
        "wk": _pd((d, KV, hd), ("fsdp", "tp", None), dtype=dt),
        "wv": _pd((d, KV, hd), ("fsdp", "tp", None), dtype=dt),
        "wo": _pd((H, hd, d), ("tp", None, "fsdp"), dtype=dt),
    }
    if cfg.qkv_bias:
        defs.update(bq=_pd((H, hd), ("tp", None), init="zeros", dtype=dt),
                    bk=_pd((KV, hd), ("tp", None), init="zeros", dtype=dt),
                    bv=_pd((KV, hd), ("tp", None), init="zeros", dtype=dt))
    return defs


def ffn_defs(cfg: ModelConfig, dt: str) -> Dict[str, ParamDef]:
    d, F = cfg.d_model, cfg.d_ff
    if cfg.num_experts > 1:
        return {
            "wr": _pd((d, cfg.num_experts), (None, None), dtype=dt),
            "w_up": _pd((cfg.num_experts, d, 2 * F), (None, "fsdp", "tp"),
                        dtype=dt),
            "w_down": _pd((cfg.num_experts, F, d), (None, "tp", "fsdp"),
                          dtype=dt),
        }
    return {"w_up": _pd((d, 2 * F), ("fsdp", "tp"), dtype=dt),
            "w_down": _pd((F, d), ("tp", "fsdp"), dtype=dt)}


def norm_defs(cfg, dt, names=("ln1", "ln2")):
    return {n: _pd((cfg.d_model,), (None,), init="ones", dtype=dt)
            for n in names}


def mamba_defs(cfg: ModelConfig, dt: str) -> Dict[str, ParamDef]:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "in_proj": _pd((d, 2 * di), ("fsdp", "tp"), dtype=dt),
        "bc_proj": _pd((d, 2 * N), ("fsdp", None), dtype=dt),
        "dt_proj": _pd((d, H), ("fsdp", None), dtype=dt),
        "dt_bias": _pd((H,), (None,), init="zeros", dtype="float32"),
        "A_log": _pd((H,), (None,), init="zeros", dtype="float32"),
        "D": _pd((H,), (None,), init="ones", dtype="float32"),
        "conv_w": _pd((CONV_K, di + 2 * N), (None, None), dtype=dt),
        "gate_norm": _pd((di,), (None,), init="ones", dtype=dt),
        "out_proj": _pd((di, d), ("tp", "fsdp"), dtype=dt),
        "ln": _pd((d,), (None,), init="ones", dtype=dt),
    }


def mlstm_defs(cfg: ModelConfig, dt: str) -> Dict[str, ParamDef]:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.heads
    return {
        "up_proj": _pd((d, 2 * di), ("fsdp", "tp"), dtype=dt),
        "w_qkv": _pd((di, 3 * di), ("fsdp", "tp"), dtype=dt),
        "w_gates": _pd((di, 2 * H), ("fsdp", None), dtype=dt),
        "down_proj": _pd((di, d), ("tp", "fsdp"), dtype=dt),
        "ln": _pd((d,), (None,), init="ones", dtype=dt),
    }


def slstm_defs(cfg: ModelConfig, dt: str) -> Dict[str, ParamDef]:
    d = cfg.d_model
    return {
        "w_in": _pd((d, 4 * d), ("fsdp", "tp"), dtype=dt),
        "w_rec": _pd((d, 4 * d), ("fsdp", None), dtype=dt, scale=0.002),
        "w_out": _pd((d, d), ("fsdp", "tp"), dtype=dt),
        "ln": _pd((d,), (None,), init="ones", dtype=dt),
    }


def hybrid_layout(cfg: ModelConfig):
    """(groups, blocks a group, tail blocks) of a hybrid stack: groups of
    (attn_every - 1) mamba blocks and the shared block, then the tail. As
    in the reference, a stack whose layers divide evenly still gets one
    tail block."""
    g = cfg.attn_every
    groups = cfg.layers // g
    return groups, g - 1, max(cfg.layers - groups * g, 1)


def xlstm_layout(cfg: ModelConfig):
    """(groups, mLSTM blocks a group): each group ends in one sLSTM block."""
    g = cfg.slstm_every or 8
    return cfg.layers // g, g - 1


def model_defs(cfg: ModelConfig) -> PyTree:
    dt = cfg.param_dtype
    d, Vp = cfg.d_model, cfg.vocab_padded
    defs: Dict[str, Any] = {
        "embed": _pd((Vp, d), ("tp", "fsdp"), scale=1.0, dtype=dt),
        "final_norm": _pd((d,), (None,), init="ones", dtype=dt),
        "unembed": _pd((d, Vp), ("fsdp", "tp"), dtype=dt),
    }
    block = lambda: {**attn_defs(cfg, dt), **ffn_defs(cfg, dt),
                     **norm_defs(cfg, dt)}
    if cfg.family in ("dense", "moe", "vlm"):
        defs["blocks"] = _stack(block(), cfg.layers)
    elif cfg.family == "audio":
        defs["enc_blocks"] = _stack(block(), cfg.encoder_layers)
        dec = {**block(),
               **{f"x_{k}": v for k, v in attn_defs(cfg, dt).items()},
               "ln3": _pd((d,), (None,), init="ones", dtype=dt)}
        defs["dec_blocks"] = _stack(dec, cfg.decoder_layers)
        defs["enc_norm"] = _pd((d,), (None,), init="ones", dtype=dt)
    elif cfg.family == "hybrid":
        groups, per, tail = hybrid_layout(cfg)
        defs["mamba_groups"] = _stack(_stack(mamba_defs(cfg, dt), per),
                                      groups)
        defs["mamba_tail"] = _stack(mamba_defs(cfg, dt), tail)
        defs["shared_attn"] = block()              # one shared block
    elif cfg.family == "ssm":
        groups, per = xlstm_layout(cfg)
        defs["mlstm_groups"] = _stack(_stack(mlstm_defs(cfg, dt), per),
                                      groups)
        defs["slstm_blocks"] = _stack(slstm_defs(cfg, dt), groups)
    else:
        raise ValueError(cfg.family)
    return defs


# --------------------------------------------------------------------------
# block functions (p maps the reference's parameter names)
#
# Under a mesh context the residual stream x of a block is this process's
# batch rows, over L / tp rows of the sequence where it is sharded
# (`spmd.seq_sharded(ctx, L)`, L the global length) and whole otherwise;
# each sublayer takes `res_gather` of its normed input and returns rows
# in the residual's layout.
# --------------------------------------------------------------------------

def cross_params(pl):
    """A decoder block's cross-attention parameters, `x_` prefix dropped
    (with their specs)."""
    specs = getattr(pl, "specs", None) or {}
    return Sharded({k[2:]: v for k, v in pl.items() if k.startswith("x_")},
                   {k[2:]: v for k, v in specs.items() if k.startswith("x_")})


def ffn_apply(pl, x, cfg, ctx=None, L=None):
    if cfg.num_experts > 1:
        if ctx is None:
            return moe_ffn(pl, x, cfg=cfg)
        L = L or x.shape[1]
        if cfg.sp_mode == "weightgather":
            x = rows_gather(x, ctx, L)
        y = moe_ffn(pl, x, cfg=cfg, ctx=ctx)
        return res_shard(y, ctx)
    return dense_ffn(pl, x, ctx, cfg.sp_mode, L)


def _norm(x, pl, name, cfg, ctx):
    return rms_norm(x, param(pl, name, ctx), cfg.norm_eps)


def transformer_block(pl, x, *, cfg, ctx=None, causal=True, cross=None,
                      seq_len=None, kv_out=True):
    """One block; returns (x, (k, v)) with the block's self-attention K/V
    (prefill keeps them; kv_out=False: a stack that drops them, k/v then
    None under a mesh context)."""
    L = seq_len or x.shape[1]
    h, kv = attention(pl, res_gather(_norm(x, pl, "ln1", cfg, ctx), ctx, L,
                                     cfg.sp_mode),
                      cfg=cfg, ctx=ctx, causal=causal, seq_len=L,
                      kv_out=kv_out)
    x = x + h
    if cross is not None:
        h, _ = attention(cross_params(pl),
                         res_gather(_norm(x, pl, "ln3", cfg, ctx), ctx, L,
                                    cfg.sp_mode),
                         cfg=cfg, ctx=ctx, causal=False, kv_x=cross,
                         use_rope=False, seq_len=L, kv_out=False)
        x = x + h
    x = x + ffn_apply(pl, res_gather(_norm(x, pl, "ln2", cfg, ctx), ctx, L,
                                     cfg.sp_mode), cfg, ctx, L)
    return x, kv


def transformer_block_decode(pl, x, cache_l, cache_len, *, cfg, ctx=None,
                             cross=None, kv_sharded=False):
    """One token through one block; writes the block's cache in place."""
    h, kv = decode_attention(pl, _norm(x, pl, "ln1", cfg, ctx),
                             cache_l["k"], cache_l["v"], cache_len, cfg=cfg,
                             ctx=ctx, kv_sharded=kv_sharded)
    x = x + h
    if cross is not None:
        h, _ = attention(cross_params(pl), _norm(x, pl, "ln3", cfg, ctx),
                         cfg=cfg, ctx=ctx, causal=False, kv_x=cross,
                         use_rope=False)
        x = x + h
    x = x + ffn_apply(pl, _norm(x, pl, "ln2", cfg, ctx), cfg, ctx)
    return x, dict(cache_l, k=kv[0], v=kv[1])


def _residual(fwd, dec, pl, x, cfg, state, decode, ctx=None, seq_len=None):
    """A recurrent block on the whole sequence: under a mesh its weights
    are gathered whole and every model rank runs it on its batch rows
    (compute replicated over `model`)."""
    L = seq_len or x.shape[1]
    h = rows_gather(_norm(x, pl, "ln", cfg, ctx), ctx, L)
    pw = pl if ctx is None else {k: param(pl, k, ctx) for k, _ in pl.items()}
    y, s = (dec(pw, h, state, cfg=cfg) if decode
            else fwd(pw, h, cfg=cfg, state=state))
    return x + res_shard(y, ctx), s


def mamba_block(pl, x, *, cfg, ctx=None, state=None, decode=False,
                seq_len=None):
    return _residual(mamba2_forward, mamba2_decode, pl, x, cfg, state, decode,
                     ctx, seq_len)


def mlstm_block(pl, x, *, cfg, ctx=None, state=None, decode=False,
                seq_len=None):
    return _residual(mlstm_forward, mlstm_decode, pl, x, cfg, state, decode,
                     ctx, seq_len)


def slstm_block(pl, x, *, cfg, ctx=None, state=None, decode=False,
                seq_len=None):
    return _residual(slstm_forward, slstm_decode, pl, x, cfg, state, decode,
                     ctx, seq_len)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

class Params(nn.Module):
    """A block's parameters under the reference's names, readable as
    `p["wq"]`, `p.get("bq")`, `p.items()`; `specs` maps each name to its
    PartitionSpec when the tensors are this process's shards."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, torch.Tensor],
                 specs: Optional[Dict] = None):
        super().__init__()
        self.cfg = cfg
        self.specs = specs
        for k, v in tree.items():
            self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    def get(self, name: str, default=None):
        return self._parameters.get(name, default)

    def items(self):
        return self._parameters.items()


class TransformerBlock(Params):
    def forward(self, x, *, ctx=None, causal=True, cross=None, seq_len=None,
                kv_out=True):
        return transformer_block(self, x, cfg=self.cfg, ctx=ctx,
                                 causal=causal, cross=cross, seq_len=seq_len,
                                 kv_out=kv_out)

    def decode(self, x, cache_l, cache_len, *, ctx=None, cross=None,
               kv_sharded=False):
        return transformer_block_decode(self, x, cache_l, cache_len,
                                        cfg=self.cfg, ctx=ctx, cross=cross,
                                        kv_sharded=kv_sharded)


class MambaBlock(Params):
    def forward(self, x, *, ctx=None, state=None, decode=False, seq_len=None):
        return mamba_block(self, x, cfg=self.cfg, ctx=ctx, state=state,
                           decode=decode, seq_len=seq_len)


class MLSTMBlock(Params):
    def forward(self, x, *, ctx=None, state=None, decode=False, seq_len=None):
        return mlstm_block(self, x, cfg=self.cfg, ctx=ctx, state=state,
                           decode=decode, seq_len=seq_len)


class SLSTMBlock(Params):
    def forward(self, x, *, ctx=None, state=None, decode=False, seq_len=None):
        return slstm_block(self, x, cfg=self.cfg, ctx=ctx, state=state,
                           decode=decode, seq_len=seq_len)


def unstack(tree: PyTree) -> list:
    """A tree of leaves stacked on axis 0 -> one tree per index."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def unstack_specs(specs: PyTree, n: int) -> list:
    """A spec tree of leaves stacked on axis 0 (replicated) -> the spec
    tree of one index, n times."""
    one = tree_map(lambda s: PartitionSpec(*s[1:]), specs)
    return [one] * n


class LanguageModel(nn.Module):
    """One architecture's parameters as modules, built over a tree of
    tensors shaped as `model_defs(cfg)` (each block's parameters are views
    into the stacked leaves, which `tree` keeps); `cfg` says which stacks
    it has (the reference's tree keys). Its parameters take no gradient
    except inside `bind_grads`.

    Sharded: `tree` holds this process's blocks of the leaves, `specs` the
    spec tree they were cut by and `mesh` the bound mesh; the steps of
    `models/zoo.py` take a mesh context over that mesh."""

    def __init__(self, cfg: ModelConfig, tree: PyTree,
                 specs: Optional[PyTree] = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.tree = tree
        self.specs = specs
        self.mesh = mesh
        sp = specs or {}
        for k in ("embed", "final_norm", "unembed", "enc_norm"):
            if k in tree:
                self.register_parameter(
                    k, nn.Parameter(tree[k], requires_grad=False))

        def stack(cls, t, s):
            ss = unstack_specs(s, t_len(t)) if s else None
            return nn.ModuleList(cls(cfg, b, ss[i] if ss else None)
                                 for i, b in enumerate(unstack(t)))

        def groups(cls, t, s):
            ss = unstack_specs(s, t_len(t)) if s else None
            return nn.ModuleList(stack(cls, g, ss[i] if ss else None)
                                 for i, g in enumerate(unstack(t)))
        fam = cfg.family
        if fam in ("dense", "moe", "vlm"):
            self.blocks = stack(TransformerBlock, tree["blocks"],
                                sp.get("blocks"))
        elif fam == "audio":
            self.enc_blocks = stack(TransformerBlock, tree["enc_blocks"],
                                    sp.get("enc_blocks"))
            self.dec_blocks = stack(TransformerBlock, tree["dec_blocks"],
                                    sp.get("dec_blocks"))
        elif fam == "hybrid":
            self.mamba_groups = groups(MambaBlock, tree["mamba_groups"],
                                       sp.get("mamba_groups"))
            self.mamba_tail = stack(MambaBlock, tree["mamba_tail"],
                                    sp.get("mamba_tail"))
            self.shared_attn = TransformerBlock(cfg, tree["shared_attn"],
                                                sp.get("shared_attn"))
        elif fam == "ssm":
            self.mlstm_groups = groups(MLSTMBlock, tree["mlstm_groups"],
                                       sp.get("mlstm_groups"))
            self.slstm_blocks = stack(SLSTMBlock, tree["slstm_blocks"],
                                      sp.get("slstm_blocks"))
        else:
            raise ValueError(fam)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def leaf(self, name: str, ctx) -> torch.Tensor:
        """A model-level leaf (final_norm, enc_norm) gathered whole."""
        return param(self._named(), name, ctx)

    def _named(self):
        return Sharded(dict(self._parameters), self.specs or {})

    def embed_tokens(self, tokens, ctx=None):
        """Token embeddings. Under `ctx`, with the vocabulary sharded over
        `model`, each rank looks up the ids in its block of rows and the
        rows are summed over `model` (vocab-parallel embedding)."""
        if ctx is None:
            return self.embed[tokens]
        named = self._named()
        if not vocab_sharded(self, "embed", 0, ctx):
            return param(named, "embed", ctx)[tokens]
        emb = param(named, "embed", ctx, keep=(ctx.tp_axis,))
        lo = ctx.tp_rank * emb.shape[0]
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < emb.shape[0])
        x = emb[torch.where(mine, ids, 0)] * mine[..., None].to(emb.dtype)
        return col.all_reduce(x, ctx.mesh, ctx.tp_axis)


def vocab_sharded(model: LanguageModel, name: str, dim: int, ctx) -> bool:
    """Whether a model-level leaf's vocabulary dimension is split over a
    model axis of more than one process (vocab-parallel embedding and
    cross-entropy)."""
    return ctx.tp > 1 and ctx.tp_axis in entry_axes(model.specs[name][dim])


def t_len(tree: PyTree) -> int:
    """The leading (stacked) size of a tree's leaves."""
    return len(tree_leaves(tree)[0])


# --------------------------------------------------------------------------
# stacks: under a mesh the sequence is sharded between blocks and whole at
# a stack's entry and exit
# --------------------------------------------------------------------------

def decoder_stack(blocks, x, *, ctx=None, causal=True, cross=None):
    L = x.shape[1]
    x = res_shard(x, ctx)
    for blk in blocks:
        x, _ = remat(blk, x, ctx=ctx, causal=causal, cross=cross, seq_len=L,
                     kv_out=False)
    return rows_gather(x, ctx, L)


def _group(x, blocks, last, ctx=None, seq_len=None):
    """A hybrid or ssm group: its blocks, then `last` (zamba2's shared
    attention block, xLSTM's sLSTM block)."""
    for blk in blocks:
        x, _ = blk(x, ctx=ctx, seq_len=seq_len)
    x, _ = last(x, ctx=ctx, seq_len=seq_len)
    return x


def hybrid_stack(model: LanguageModel, x, ctx=None):
    """zamba2: groups of (attn_every - 1) mamba blocks + 1 shared attn,
    then the tail mamba blocks."""
    L = x.shape[1]
    x = res_shard(x, ctx)
    shared = functools.partial(model.shared_attn, kv_out=False)
    for group in model.mamba_groups:
        x = remat(_group, x, group, shared, ctx, L)
    for blk in model.mamba_tail:
        x, _ = remat(blk, x, ctx=ctx, seq_len=L)
    return rows_gather(x, ctx, L)


def xlstm_stack(model: LanguageModel, x, ctx=None):
    L = x.shape[1]
    x = res_shard(x, ctx)
    for group, sblk in zip(model.mlstm_groups, model.slstm_blocks):
        x = remat(_group, x, group, sblk, ctx, L)
    return rows_gather(x, ctx, L)


def backbone(model: LanguageModel, batch, ctx=None) -> torch.Tensor:
    """Full forward to final hidden states (B, L, d); under `ctx` the
    batch is this process's rows (`spmd.shard_batch`)."""
    cfg = model.cfg
    fam = cfg.family
    if fam == "audio":
        enc = decoder_stack(model.enc_blocks, batch["frames"], ctx=ctx,
                            causal=False)                 # stub frontend
        enc = rms_norm(enc, model.leaf("enc_norm", ctx), cfg.norm_eps)
        x = model.embed_tokens(batch["tokens"], ctx)
        x = decoder_stack(model.dec_blocks, x, ctx=ctx, causal=True,
                          cross=enc)
    elif fam == "vlm":
        x = model.embed_tokens(batch["tokens"], ctx)
        patches = batch.get("patches")
        if patches is not None:                           # stub ViT frontend
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        x = decoder_stack(model.blocks, x, ctx=ctx)
        if patches is not None:
            x = x[:, patches.shape[1]:]
    elif fam in ("dense", "moe"):
        x = decoder_stack(model.blocks,
                          model.embed_tokens(batch["tokens"], ctx), ctx=ctx)
    elif fam == "hybrid":
        x = hybrid_stack(model, model.embed_tokens(batch["tokens"], ctx), ctx)
    elif fam == "ssm":
        x = xlstm_stack(model, model.embed_tokens(batch["tokens"], ctx), ctx)
    else:
        raise ValueError(fam)
    return rms_norm(x, model.leaf("final_norm", ctx), cfg.norm_eps)


def lm_loss(model: LanguageModel, batch, ctx=None) -> torch.Tensor:
    """Mean next-token cross-entropy; differentiable in the model's
    parameters inside `bind_grads`.

    Under `ctx` (`ctx.batch` the global batch, `batch` this process's
    rows): the value is the global mean, the same on every process, and
    its gradient is that of this process's share of it. Every process
    differentiates it, and the shares add up to the gradient of the
    global loss (`dist/collectives.py`)."""
    h = backbone(model, batch, ctx)
    if ctx is None:
        return chunked_cross_entropy(h, model.unembed, batch["labels"],
                                     true_vocab=model.cfg.vocab,
                                     mask=batch.get("loss_mask"))
    named = model._named()
    vocab_tp = vocab_sharded(model, "unembed", 1, ctx)
    unembed = param(named, "unembed", ctx,
                    keep=(ctx.tp_axis,) if vocab_tp else ())
    tot, cnt = chunked_cross_entropy(
        h, unembed, batch["labels"], true_vocab=model.cfg.vocab,
        mask=batch.get("loss_mask"), ctx=ctx if vocab_tp else None,
        parts=True)
    mesh = ctx.mesh
    sharded = batch_sharded(ctx, ctx.batch)
    if sharded:
        cnt = col._raw_all_reduce(mesh, mesh.ordered(ctx.dp_axes), cnt,
                                  torch.distributed.ReduceOp.SUM)
    share = tot / torch.clamp(cnt, min=1.0) / loss_copies(ctx, ctx.batch)
    whole = col._raw_all_reduce(mesh, mesh.axis_names, share.detach(),
                                torch.distributed.ReduceOp.SUM)
    return share + (whole - share).detach()


@contextlib.contextmanager
def bind_grads(model: LanguageModel, grads: PyTree):
    """Within the block, the model's parameters take gradients, and each
    one's `.grad` is its view of `grads` (a tree shaped as `model.tree`,
    in the leaves' dtypes): autograd accumulates in place into the
    stacked leaves, so `grads` is the reference's gradient tree. On exit
    the parameters take no gradient again."""
    params = list(model.parameters())
    views = [g.detach() for g in LanguageModel(model.cfg, grads).parameters()]
    try:
        for p, g in zip(params, views):
            p.requires_grad_(True)
            p.grad = g
        with torch.enable_grad():
            yield
    finally:
        for p in params:
            p.grad = None
            p.requires_grad_(False)
