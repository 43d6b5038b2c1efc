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

# Zamba2-1.2B in its published layout: the layer equations of transformers'
# Zamba2 (modeling_zamba2.py, 4.57) at the 1.2B sizes above.  The shared
# block reads concat(h, x0), 4096 wide, with 32 heads of 2 * 2048 / 32 = 128
# (the family's rule); it runs before layers 6, 12, ..., 36.  Values the
# 1.2B sizes do not fix are set in perfbench/configs/zamba2-1.2b.json's
# ``assumed``.  ``zamba2-1.2b`` above stays the layout the JAX package runs.
PUBLISHED = CONFIG.variant(
    name="zamba2-1.2b-published",
    head_dim=128,
    attn_kind="full",
    window=0,
    hybrid_layout="zamba2",
    hybrid_layer_ids=(6, 12, 18, 24, 30, 36),
    adapter_rank=128,
    use_shared_mlp_adapter=True,
    use_shared_attention_adapter=True,
    tie_embeddings=True,
)

PUBLISHED_SMOKE = PUBLISHED.variant(
    name="zamba2-1.2b-published-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    ssm_groups=2,
    hybrid_layer_ids=(1, 3),
    adapter_rank=8,
)
