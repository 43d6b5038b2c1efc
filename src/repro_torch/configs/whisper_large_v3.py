"""Whisper-large-v3 backbone — encoder-decoder transformer; the conv/mel
frontend is a STUB per the assignment (``input_specs`` provides precomputed
frame embeddings) [arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    source="[arXiv:2212.04356; unverified]",
    n_layers=32,  # decoder layers; encoder has its own 32 (see encoder_layers)
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    attn_kind="full",
    encoder_layers=32,
    encoder_seq=1500,  # 30 s of audio after the (stubbed) conv frontend
    frontend="audio",
    gated_ffn=False,  # classic GELU FFN
)

SMOKE = CONFIG.variant(
    name="whisper-large-v3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    encoder_layers=2,
    encoder_seq=32,
)
