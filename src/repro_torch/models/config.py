"""Model configuration shared by the zoo, the configs/ registry, the
simulation-plane extractor and the launchers."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | audio | hybrid | ssm | vlm
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // heads
    qkv_bias: bool = False
    num_experts: int = 1
    top_k: int = 1
    attn_window: int = 0        # 0 = full attention; >0 = sliding window
    attn_every: int = 0         # hybrid: attention block every N blocks
    ssm_state: int = 64
    ssm_headdim: int = 64
    slstm_every: int = 0        # xlstm: sLSTM block every N blocks
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    frontend: Optional[str] = None   # None | audio | vision  (stub inputs)
    frontend_tokens: int = 0         # vision: #patch embeddings prepended
    encoder_layers: int = 0          # audio enc-dec: encoder depth
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    moe_capacity_factor: float = 1.25
    # sequence-parallel strategy (see models/transformer.py + EXPERIMENTS.md
    # §Perf): "megatron" all-gathers activations at each TP sublayer;
    # "weightgather" (2D-FSDP) keeps activations L-sharded and gathers the
    # (data x model)-sharded weights per layer instead.
    sp_mode: str = "megatron"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding tables padded to a TP-friendly multiple of 256."""
        return -(-self.vocab // 256) * 256

    @property
    def decoder_layers(self) -> int:
        return self.layers - self.encoder_layers

    @property
    def d_inner(self) -> int:        # mamba2 / mLSTM expanded width
        return 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return max(1, self.d_inner // self.ssm_headdim)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with O(1)-or-windowed state? (long_500k)."""
        return (self.family in ("ssm", "hybrid")
                or (self.attn_window > 0 and self.family != "audio"))

    def param_count(self) -> float:
        """Analytic parameter count (for MODEL_FLOPS roofline terms)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.heads * hd) + 2 * d * (self.kv_heads * hd) \
            + (self.heads * hd) * d
        if self.num_experts > 1:
            ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        else:
            ffn = 3 * d * self.d_ff if self.d_ff else 0
        ssm = d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads) \
            + self.d_inner * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "vlm"):
            body = self.layers * (attn + ffn)
        elif self.family == "audio":
            enc = self.encoder_layers * (attn + ffn)
            dec = self.decoder_layers * (2 * attn + ffn)   # self + cross
            body = enc + dec
        elif self.family == "hybrid":
            n_attn = self.layers // max(self.attn_every, 1)
            body = (self.layers - n_attn) * ssm + 1 * (attn + ffn)  # shared
        elif self.family == "ssm":
            n_s = self.layers // max(self.slstm_every or 8, 1)
            slstm = 4 * d * d + 4 * d
            body = (self.layers - n_s) * ssm + n_s * slstm
        else:
            raise ValueError(self.family)
        return float(body + emb)

    def active_param_count(self) -> float:
        """MoE: parameters touched per token (top-k experts)."""
        if self.num_experts <= 1:
            return self.param_count()
        d = self.d_model
        dense_ffn = self.num_experts * 3 * d * self.d_ff
        active_ffn = self.top_k * 3 * d * self.d_ff
        return self.param_count() - self.layers * (dense_ffn - active_ffn)
