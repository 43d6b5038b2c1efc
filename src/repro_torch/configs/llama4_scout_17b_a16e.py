"""Llama-4-Scout-17B-16E — MoE top-1 + shared expert, chunked local
attention with periodic global layers
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,  # per-expert FFN width
    vocab_size=202048,
    attn_kind="chunked",
    window=8192,  # local chunked attention
    global_every=4,  # every 4th layer attends globally
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    rope_theta=5e5,
)

SMOKE = CONFIG.variant(
    name="llama4-scout-17b-a16e-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    window=16,
    global_every=2,
    n_experts=4,
    n_shared_experts=1,
    top_k=1,
)
