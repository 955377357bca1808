"""yi-34b [dense]: 60L, d_model=7168, 56H (GQA kv=8), d_ff=20480,
vocab=64000, llama-arch [arXiv:2403.04652]."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="yi-34b", family="dense", layers=60, d_model=7168,
    heads=56, kv_heads=8, d_ff=20480, vocab=64000, rope_theta=5e6,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=56, heads=7, kv_heads=1, d_ff=128, vocab=512)
