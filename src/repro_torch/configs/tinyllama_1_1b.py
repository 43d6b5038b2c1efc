"""TinyLlama-1.1B — llama2-architecture small model [arXiv:2401.02385; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    source="[arXiv:2401.02385; hf]",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    attn_kind="full",
    rope_theta=1e4,
)

SMOKE = CONFIG.variant(
    name="tinyllama-1.1b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
