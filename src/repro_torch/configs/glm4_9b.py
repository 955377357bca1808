"""glm4-9b [dense]: 40L, d_model=4096, 32H (GQA kv=2), d_ff=13696,
vocab=151552, RoPE [hf:THUDM/glm-4-9b]."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="glm4-9b", family="dense", layers=40, d_model=4096,
    heads=32, kv_heads=2, d_ff=13696, vocab=151552, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=64, heads=4, kv_heads=1, d_ff=128, vocab=512)
