"""Workload operator graphs for the simulation plane (the paper's own CNN/ViT
workloads, GEMM-ified: M = filters, N = ofmap pixels, K = im2col window).

The PyTorch port's copy of `repro.core.workloads`: `Op` has the same
fields, so `Op(**dataclasses.asdict(reference_op))` rebuilds a reference
op, and every paper workload yields the identical op list. `lm_ops` turns one
step of an LM architecture (a duck-typed model config with the
reference's `ModelConfig` fields) into the same op graph as the
reference's; the model configs themselves belong to the workload plane.

`Op.count` multiplies identical GEMMs (e.g. per-head attention GEMMs, layer
repeats); `Op.kind == 'vector'` ops run on the SIMD unit (Sec. III-C).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    M: int = 0
    N: int = 0
    K: int = 0
    count: float = 1.0
    kind: str = "gemm"              # gemm | vector
    vector_elems: float = 0.0
    sparsity_nm: Optional[Tuple[int, int]] = None  # per-layer N:M override

    @property
    def macs(self) -> float:
        return self.count * self.M * self.N * self.K


def _g(name, M, N, K, count=1.0, nm=None) -> Op:
    return Op(name, int(M), int(N), int(K), count, sparsity_nm=nm)


def _v(name, elems, count=1.0) -> Op:
    return Op(name, kind="vector", vector_elems=float(elems), count=count)


def resnet18() -> List[Op]:
    ops = [_g("conv1", 64, 112 * 112, 147)]
    ops += [_g(f"conv2_{i}", 64, 56 * 56, 576) for i in range(4)]
    ops += [_g("conv3_0", 128, 28 * 28, 576), _g("conv3_sc", 128, 28 * 28, 64)]
    ops += [_g(f"conv3_{i}", 128, 28 * 28, 1152) for i in range(1, 4)]
    ops += [_g("conv4_0", 256, 14 * 14, 1152), _g("conv4_sc", 256, 14 * 14, 128)]
    ops += [_g(f"conv4_{i}", 256, 14 * 14, 2304) for i in range(1, 4)]
    ops += [_g("conv5_0", 512, 7 * 7, 2304), _g("conv5_sc", 512, 7 * 7, 256)]
    ops += [_g(f"conv5_{i}", 512, 7 * 7, 4608) for i in range(1, 4)]
    ops += [_g("fc", 1000, 1, 512)]
    return ops


def resnet18_six_layers() -> List[Op]:
    """Six-layer subset for the WS-vs-OS DRAM study (Sec. IX-B): the early,
    activation-heavy layers (large N) where WS wins on compute cycles but
    loses once DRAM stalls are modeled."""
    return resnet18()[:6]


def alexnet() -> List[Op]:
    return [
        _g("conv1", 96, 55 * 55, 363), _g("conv2", 256, 27 * 27, 2400),
        _g("conv3", 384, 13 * 13, 2304), _g("conv4", 384, 13 * 13, 3456),
        _g("conv5", 256, 13 * 13, 3456), _g("fc6", 4096, 1, 9216),
        _g("fc7", 4096, 1, 4096), _g("fc8", 1000, 1, 4096),
    ]


def resnet50() -> List[Op]:
    ops = [_g("conv1", 64, 112 * 112, 147)]
    spec = [(56 * 56, 64, 256, 3), (28 * 28, 128, 512, 4),
            (14 * 14, 256, 1024, 6), (7 * 7, 512, 2048, 3)]
    cin = 64
    for n, mid, out, blocks in spec:
        for b in range(blocks):
            ops += [_g(f"b{out}_{b}_1x1a", mid, n, cin),
                    _g(f"b{out}_{b}_3x3", mid, n, mid * 9),
                    _g(f"b{out}_{b}_1x1b", out, n, mid)]
            if b == 0:
                ops.append(_g(f"b{out}_sc", out, n, cin))
            cin = out
    ops.append(_g("fc", 1000, 1, 2048))
    return ops


def vit(d: int, layers: int, heads: int, d_ff: int, tokens: int = 197,
        prefix: str = "vit") -> List[Op]:
    hd = d // heads
    ops: List[Op] = [_g(f"{prefix}_embed", d, tokens, 3 * 16 * 16)]
    for l in range(layers):
        ops += [
            _g(f"{prefix}_{l}_qkv", 3 * d, tokens, d),
            _g(f"{prefix}_{l}_scores", tokens, tokens, hd, count=heads),
            _v(f"{prefix}_{l}_softmax", heads * tokens * tokens),
            _g(f"{prefix}_{l}_attnv", hd, tokens, tokens, count=heads),
            _g(f"{prefix}_{l}_proj", d, tokens, d),
            _g(f"{prefix}_{l}_mlp1", d_ff, tokens, d),
            _v(f"{prefix}_{l}_gelu", d_ff * tokens),
            _g(f"{prefix}_{l}_mlp2", d, tokens, d_ff),
            _v(f"{prefix}_{l}_ln", 2 * tokens * d),
        ]
    ops.append(_g(f"{prefix}_head", 1000, 1, d))
    return ops


def vit_base() -> List[Op]:
    return vit(768, 12, 12, 3072, prefix="vitb")


def vit_small() -> List[Op]:
    return vit(384, 12, 6, 1536, prefix="vits")


def vit_large() -> List[Op]:
    return vit(1024, 24, 16, 4096, prefix="vitl")


def vit_linear(d: int, layers: int, d_ff: int, tokens: int = 197,
               prefix: str = "vit") -> List[Op]:
    """Linear layers only (qkv/proj/mlp) — SCALE-Sim GEMM-topology style,
    used for the paper's Table V latency/energy/EdP reproduction."""
    ops: List[Op] = []
    for l in range(layers):
        ops += [_g(f"{prefix}_{l}_qkv", 3 * d, tokens, d),
                _g(f"{prefix}_{l}_proj", d, tokens, d),
                _g(f"{prefix}_{l}_mlp1", d_ff, tokens, d),
                _g(f"{prefix}_{l}_mlp2", d, tokens, d_ff)]
    return ops


def vit_base_linear() -> List[Op]:
    return vit_linear(768, 12, 3072, prefix="vitb")


def vit_ffn_only(d: int = 768, d_ff: int = 3072, tokens: int = 197,
                 layers: int = 12) -> List[Op]:
    """Feed-forward layers of ViTs (paper Fig. 8 workload)."""
    ops = []
    for l in range(layers):
        ops += [_g(f"ff{l}_1", d_ff, tokens, d), _g(f"ff{l}_2", d, tokens, d_ff)]
    return ops


def rcnn() -> List[Op]:
    """Fast-RCNN-style: VGG16 backbone + per-RoI heads (GEMM-ified)."""
    cfg = [(64, 224 * 224, 27), (64, 224 * 224, 576),
           (128, 112 * 112, 576), (128, 112 * 112, 1152),
           (256, 56 * 56, 1152), (256, 56 * 56, 2304), (256, 56 * 56, 2304),
           (512, 28 * 28, 2304), (512, 28 * 28, 4608), (512, 28 * 28, 4608),
           (512, 14 * 14, 4608), (512, 14 * 14, 4608), (512, 14 * 14, 4608)]
    ops = [_g(f"vgg{i}", m, n, k) for i, (m, n, k) in enumerate(cfg)]
    ops += [_g("fc6", 4096, 128, 25088), _g("fc7", 4096, 128, 4096),
            _g("cls", 21, 128, 4096), _g("bbox", 84, 128, 4096)]
    return ops


PAPER_WORKLOADS = dict(resnet18=resnet18, alexnet=alexnet, resnet50=resnet50,
                       vit_base=vit_base, vit_small=vit_small,
                       vit_large=vit_large, rcnn=rcnn)


# --------------------------------------------------------------------------
# LM architecture extractor (assigned archs x shape cells)
# --------------------------------------------------------------------------

def lm_ops(cfg, *, seq: int, batch: int, mode: str = "train",
           cache_len: Optional[int] = None) -> List[Op]:
    """Operator graph for one step of an assigned LM architecture.

    cfg: any object with the fields of the reference's `ModelConfig` that
    are read here (family, d_model, layers, heads, kv_heads, head_dim,
    d_ff, num_experts, top_k, vocab; attn_window, attn_every, ssm_state
    where the family uses them). mode: train | prefill | decode.
    Training multiplies forward GEMMs by 3 (fwd + ~2x bwd, standard
    GEMM-count accounting); decode uses N = batch (one token each) and
    attention GEMVs against a cache of `cache_len`.
    """
    mult = 3.0 if mode == "train" else 1.0
    d, L = cfg.d_model, cfg.layers
    hd = cfg.head_dim
    nq, nkv = cfg.heads, cfg.kv_heads
    ops: List[Op] = []
    if mode == "decode":
        n_tok = batch                       # one new token per sequence
        ctx = cache_len or seq
    else:
        n_tok = batch * seq
        ctx = seq
    window = getattr(cfg, "attn_window", 0) or 0
    eff_ctx = min(ctx, window) if window else ctx

    def attn_block(tag, cross_ctx=None):
        kv_ctx = cross_ctx if cross_ctx is not None else eff_ctx
        ops.append(_g(f"{tag}_q", nq * hd, n_tok, d, count=mult))
        ops.append(_g(f"{tag}_kv", 2 * nkv * hd, n_tok if cross_ctx is None
                      else cross_ctx * batch // max(batch, 1), d, count=mult))
        if mode == "decode":
            ops.append(_g(f"{tag}_scores", kv_ctx, 1, hd, count=mult * batch * nq))
            ops.append(_g(f"{tag}_ctxv", hd, 1, kv_ctx, count=mult * batch * nq))
        else:
            sc = min(seq, eff_ctx) if cross_ctx is None else cross_ctx
            ops.append(_g(f"{tag}_scores", sc, seq, hd, count=mult * batch * nq))
            ops.append(_g(f"{tag}_ctxv", hd, seq, sc, count=mult * batch * nq))
        ops.append(_v(f"{tag}_softmax", n_tok * nq * kv_ctx, count=mult))
        ops.append(_g(f"{tag}_o", d, n_tok, nq * hd, count=mult))
        ops.append(_v(f"{tag}_norm", 2 * n_tok * d, count=mult))

    def ffn_block(tag):
        if cfg.num_experts > 1:
            ops.append(_g(f"{tag}_router", cfg.num_experts, n_tok, d, count=mult))
            act = cfg.top_k
            ops.append(_g(f"{tag}_moe_up", 2 * cfg.d_ff, n_tok, d, count=mult * act))
            ops.append(_v(f"{tag}_moe_act", act * n_tok * cfg.d_ff, count=mult))
            ops.append(_g(f"{tag}_moe_down", d, n_tok, cfg.d_ff, count=mult * act))
        elif cfg.d_ff > 0:
            ops.append(_g(f"{tag}_ffn_up", 2 * cfg.d_ff, n_tok, d, count=mult))
            ops.append(_v(f"{tag}_ffn_act", n_tok * cfg.d_ff, count=mult))
            ops.append(_g(f"{tag}_ffn_down", d, n_tok, cfg.d_ff, count=mult))

    def ssm_block(tag):
        di = 2 * d
        st = getattr(cfg, "ssm_state", 64)
        chunk = min(256, max(1, seq if mode != "decode" else 1))
        ops.append(_g(f"{tag}_inproj", 2 * di + 2 * st, n_tok, d, count=mult))
        if mode == "decode":
            ops.append(_v(f"{tag}_state_update", batch * di * st, count=mult))
        else:
            ops.append(_g(f"{tag}_intra", chunk, seq, st,
                          count=mult * batch * max(1, di // 64)))
            ops.append(_g(f"{tag}_state", st, di, chunk,
                          count=mult * batch * (seq // max(chunk, 1))))
        ops.append(_g(f"{tag}_outproj", d, n_tok, di, count=mult))
        ops.append(_v(f"{tag}_norm", 2 * n_tok * d, count=mult))

    family = cfg.family
    for l in range(L):
        tag = f"L{l}"
        if family in ("dense", "moe", "vlm"):
            attn_block(tag)
            ffn_block(tag)
        elif family == "audio":                     # whisper enc-dec
            if l < L // 2:
                attn_block(f"{tag}_enc")
                ffn_block(f"{tag}_enc")
            else:
                attn_block(f"{tag}_dec")
                attn_block(f"{tag}_xattn", cross_ctx=min(seq, eff_ctx))
                ffn_block(f"{tag}_dec")
        elif family == "hybrid":                    # zamba2
            if (l + 1) % cfg.attn_every == 0:
                attn_block(tag)
            else:
                ssm_block(tag)
            ffn_block(tag)
        elif family == "ssm":                       # xlstm
            if (l + 1) % 8 == 0:
                ops.append(_g(f"{tag}_slstm", 4 * d, n_tok, d, count=mult))
                ops.append(_v(f"{tag}_slstm_gates", 4 * n_tok * d, count=mult))
            else:
                ssm_block(tag)
        else:
            raise ValueError(f"unknown family {family!r}")
    # embedding + unembedding (vocab GEMM)
    if mode != "decode":
        ops.append(_g("unembed", cfg.vocab, n_tok, d, count=mult))
    else:
        ops.append(_g("unembed", cfg.vocab, batch, d, count=1.0))
    return ops


def total_macs(ops: Sequence[Op]) -> float:
    return sum(o.macs for o in ops if o.kind == "gemm")
