"""Public entry points of the port's kernels.

The route is chosen by the tensors' device, never by a mode switch: a CUDA
tensor runs the Hopper kernel (or raises), a CPU tensor the kernel's plain
PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import attention_plain, flash_attention
from .moe_gmm import grouped_matmul, grouped_matmul_plain
from .ssd_scan import ssd_chunk_kernel, ssd_chunk_plain

__all__ = [
    "attention", "attention_plain", "flash_attention",
    "expert_ffn_matmul", "grouped_matmul", "grouped_matmul_plain",
    "ssd_chunk", "ssd_chunk_kernel", "ssd_chunk_plain",
]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, chunk: int = 0) -> torch.Tensor:
    """Forward GQA attention, q (B,S,H,D) against k/v (B,S,KV,D)."""
    return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)


def ssd_chunk(a_dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD intra-chunk block: a_dt (B,H,nc,Q), x (B,H,nc,Q,P), b/c
    (B,G,nc,Q,N) → (y_diag (B,H,nc,Q,P), chunk states (B,H,nc,P,N) f32)."""
    return ssd_chunk_kernel(a_dt, x, b, c)


def expert_ffn_matmul(x: torch.Tensor, w: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert FFN product: x (E,C,D) × w (E,D,F) → (E,C,F) in x's dtype,
    written into ``out`` (contiguous, of x's dtype and device) when given."""
    return grouped_matmul(x, w, out=out)
