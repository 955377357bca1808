"""mixtral-8x7b [moe]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=32000, 8 experts top-2, sliding-window attention 4096
[arXiv:2401.04088]."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="mixtral-8x7b", family="moe", layers=32, d_model=4096,
    heads=32, kv_heads=8, d_ff=14336, vocab=32000,
    num_experts=8, top_k=2, attn_window=4096, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=512,
    num_experts=4, top_k=2, attn_window=32)
