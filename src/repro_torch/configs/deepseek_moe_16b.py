"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed experts, top-6
[arXiv:2401.06066; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="[arXiv:2401.06066; hf]",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert FFN width (fine-grained)
    vocab_size=102400,
    attn_kind="full",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    rope_theta=1e4,
)

SMOKE = CONFIG.variant(
    name="deepseek-moe-16b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    n_experts=8,
    n_shared_experts=1,
    top_k=2,
)
