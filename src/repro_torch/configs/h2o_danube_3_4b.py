"""H2O-Danube-3-4B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="[arXiv:2401.16818; unverified]",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attn_kind="swa",
    window=4096,
    rope_theta=1e4,
)

SMOKE = CONFIG.variant(
    name="h2o-danube-3-4b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    window=16,
)
