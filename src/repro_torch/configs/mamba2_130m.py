"""Mamba2-130M — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    n_layers=24,
    d_model=768,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=64,
    tie_embeddings=True,
)

SMOKE = CONFIG.variant(
    name="mamba2-130m-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
)
