"""Zamba2-1.2B — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=64,
    attn_every=6,  # the shared attention+MLP block fires every 6th layer
    attn_kind="swa",  # serving: the shared block keeps a bounded SWA cache
    window=4096,
)

SMOKE = CONFIG.variant(
    name="zamba2-1.2b-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    attn_every=2,
    window=16,
)
