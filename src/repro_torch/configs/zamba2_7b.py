"""zamba2-7b [hybrid]: 81 blocks, d_model=3584, Mamba2 backbone
(ssm_state=64) with a SHARED full-attention block (32H, kv=32 i.e. MHA,
d_ff=14336 MLP) applied every 6th block [arXiv:2411.15242]. For long_500k
the shared block uses a 4096 sliding window (DESIGN.md adaptation)."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="zamba2-7b", family="hybrid", layers=81, d_model=3584,
    heads=32, kv_heads=32, d_ff=14336, vocab=32000,
    attn_every=6, attn_window=4096, ssm_state=64, ssm_headdim=64,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    ARCH, layers=7, d_model=64, heads=4, kv_heads=4, d_ff=128, vocab=512,
    attn_every=3, attn_window=32, ssm_state=16, ssm_headdim=32)
