"""internvl2-1b [vlm]: Qwen2-0.5B-shaped LM backbone: 24L, d_model=896,
14H (GQA kv=2), d_ff=4864, vocab=151655 [arXiv:2404.16821]. InternViT
frontend is a STUB: input_specs provide 256 precomputed patch embeddings
prepended to the text sequence."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="internvl2-1b", family="vlm", layers=24, d_model=896,
    heads=14, kv_heads=2, d_ff=4864, vocab=151655, qkv_bias=True,
    frontend="vision", frontend_tokens=256, rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=56, heads=7, kv_heads=1, d_ff=112, vocab=512,
    frontend_tokens=16)
