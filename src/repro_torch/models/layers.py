"""Shared model primitives: norms, RoPE, FFN, embeddings.

Port of ``repro/models/layers.py``.  Plain functions over explicit param
dicts of tensors, with the JAX package's keys, shapes and layouts.  Every
initializer draws from an explicit :class:`torch.Generator` and allocates
on that generator's device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "Params",
    "dense_init",
    "rms_norm",
    "layer_norm",
    "rope_frequencies",
    "apply_rope",
    "ffn_init",
    "ffn_apply",
    "embed_init",
    "cross_entropy_loss",
]

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (within ±2) fan-in init, drawn in f32 then cast."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm (biased variance) computed in f32, cast back to ``x``'s
    dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies (head_dim//2,) in f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by f32 angles of
    ``positions`` (..., seq).  Split halves, not interleaved pairs."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, gated: bool = True) -> Params:
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    return p


def ffn_apply(p: Params, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    """SwiGLU, or the tanh-form GELU FFN (``jax.nn.gelu``'s default)."""
    up = x @ p["w_up"]
    if gated:
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype) -> torch.Tensor:
    return dense_init(gen, (vocab, d_model), dtype, scale=1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy in f32; ``mask`` (same shape as labels)
    excludes padding/vision-prefix positions."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
