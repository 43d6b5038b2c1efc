"""Public entry points of the port's kernels.

The route is chosen by the tensors' device, never by a mode switch: a CUDA
tensor runs the Hopper kernel (or raises), a CPU tensor the kernel's plain
PyTorch version.
"""
from __future__ import annotations

import torch

from .flash_attention import attention_plain, flash_attention

__all__ = ["attention", "attention_plain", "flash_attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, chunk: int = 0) -> torch.Tensor:
    """Forward GQA attention, q (B,S,H,D) against k/v (B,S,KV,D)."""
    return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)
