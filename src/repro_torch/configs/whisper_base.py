"""whisper-base [audio]: enc-dec, 6L encoder + 6L decoder (spec: 6L),
d_model=512, 8H (kv=8), d_ff=2048, vocab=51865 [arXiv:2212.04356].
Conv audio frontend is a STUB: input_specs provide precomputed frame
embeddings (B, L, d_model)."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="whisper-base", family="audio", layers=12, encoder_layers=6,
    d_model=512, heads=8, kv_heads=8, d_ff=2048, vocab=51865,
    rope_theta=1e4, frontend="audio",
)

SMOKE = dataclasses.replace(
    ARCH, layers=4, encoder_layers=2, d_model=64, heads=4, kv_heads=4,
    d_ff=128, vocab=512)
