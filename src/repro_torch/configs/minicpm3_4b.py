"""MiniCPM3-4B — Multi-head Latent Attention (MLA)
[hf:openbmb/MiniCPM3-4B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    source="[hf:openbmb/MiniCPM3-4B; hf]",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,  # MLA: per-head K/V reconstructed from the latent
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    nope_head_dim=64,
    v_head_dim=64,
    head_dim=96,  # nope + rope
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = CONFIG.variant(
    name="minicpm3-4b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    q_lora_rank=32,
    kv_lora_rank=16,
    rope_head_dim=8,
    nope_head_dim=16,
    v_head_dim=16,
    head_dim=24,
)
