"""xlstm-1.3b [ssm]: 48 blocks, d_model=2048, 4H (kv=4), d_ff=0 (blocks
carry their own 2x up-projection), vocab=50304; mLSTM blocks with an sLSTM
block every 8th [arXiv:2405.04517]."""
import dataclasses
from ..models.config import ModelConfig

ARCH = ModelConfig(
    arch_id="xlstm-1.3b", family="ssm", layers=48, d_model=2048,
    heads=4, kv_heads=4, d_ff=0, vocab=50304, slstm_every=8,
    head_dim=512,
)

SMOKE = dataclasses.replace(
    ARCH, layers=8, d_model=64, heads=2, kv_heads=2, vocab=512,
    slstm_every=4, head_dim=32)
