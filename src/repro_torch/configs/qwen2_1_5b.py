"""qwen2-1.5b [dense]: 28L, d_model=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936, QKV bias [arXiv:2407.10671]. 12 heads are not divisible by
TP=16 -> attention uses the sequence-sharded fallback (models/attention.py)."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="qwen2-1.5b", family="dense", layers=28, d_model=1536,
    heads=12, kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=48, heads=6, kv_heads=2, d_ff=96, vocab=512)
