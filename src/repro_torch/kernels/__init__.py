"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see :mod:`.ops`).  Sources live in ``csrc/`` and are built at
first use by :mod:`.build`; importing this package builds nothing."""
from .ops import (
    attention,
    attention_plain,
    expert_ffn_matmul,
    flash_attention,
    grouped_matmul,
    grouped_matmul_plain,
    ssd_chunk,
    ssd_chunk_kernel,
    ssd_chunk_plain,
)

__all__ = [
    "attention", "attention_plain", "flash_attention",
    "expert_ffn_matmul", "grouped_matmul", "grouped_matmul_plain",
    "ssd_chunk", "ssd_chunk_kernel", "ssd_chunk_plain",
]
