"""InternVL2-76B backbone — InternLM2-76B trunk; the InternViT vision
frontend is a STUB per the assignment (``input_specs`` provides patch
embeddings) [arXiv:2404.16821; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    source="[arXiv:2404.16821; unverified]",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    attn_kind="full",
    rope_theta=1e6,
    frontend="vision",
    n_prefix_tokens=256,  # one image tile worth of patch embeddings
)

SMOKE = CONFIG.variant(
    name="internvl2-76b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    n_prefix_tokens=8,
)
