"""granite-moe-3b-a800m [moe]: 32L, d_model=1536, 24H (GQA kv=8),
per-expert d_ff=512, vocab=49155, MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base]. The assignment's structured
field says 40e top-8 (matching the hf config); the prose "32 experts" is
inconsistent with both and ignored (DESIGN.md §4)."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="granite-moe-3b-a800m", family="moe", layers=32, d_model=1536,
    heads=24, kv_heads=8, d_ff=512, vocab=49155,
    num_experts=40, top_k=8, rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    ARCH, layers=2, d_model=48, heads=4, kv_heads=2, d_ff=32, vocab=512,
    num_experts=8, top_k=4)
