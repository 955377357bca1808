"""qwen2-72b [dense]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568,
vocab=152064, QKV bias [arXiv:2407.10671]."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="qwen2-72b", family="dense", layers=80, d_model=8192,
    heads=64, kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128, vocab=512)
