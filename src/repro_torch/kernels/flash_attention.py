"""Forward GQA flash attention: the Hopper kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``_attn_kernel`` of ``repro/kernels/flash_attention.py``; see the source's
header for its design.  :func:`flash_attention` picks the route by the
tensors' device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes :func:`attention_plain`.  Unlike the TPU kernel, any sequence
length works: the kernel masks the ragged tail itself.  bf16 inputs go to
the tensor-core route, whose 16-byte copies want each of q, k, v to start
on 16 bytes with its (B, S, H) strides a multiple of 8 elements: the
wrapper raises on any other layout rather than copy it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build
from .guard import refuse_autograd

__all__ = ["NEG_INF", "attention_plain", "flash_attention", "HEAD_DIMS", "DTYPES"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    q_start: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch copy of ``repro.kernels.ref.attention_ref``: f32 scores
    and softmax over the whole (masked) score matrix.  ``q_start`` is the
    position of q's first row (k's rows sit at 0..skv-1), so that a long
    sequence can be taken a block of queries at a time.  Scores are scaled
    by ``scale``, by default 1/sqrt(D)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    qpos = torch.arange(q_start, q_start + sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if chunk > 0:
        mask &= (kpos // chunk) == (qpos // chunk)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _kernel():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, chunk: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v must lie on one CUDA device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; the kernel takes float32 or bfloat16, all alike")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,S,H,D) and k, v (B,S,KV,D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch, length or head dim")
    if h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: {h} heads are not a multiple of {k.shape[2]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            steps = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
            if t.data_ptr() % 16 or any(st % 8 for st in steps):
                raise ValueError(f"flash_attention: bf16 {name} must start on 16 bytes with (B, S, H) strides a "
                                 f"multiple of 8 elements for the 16-byte copies; got strides {t.stride()}")
    if window < 0 or chunk < 0:
        raise ValueError(f"flash_attention: window {window} and chunk {chunk} must be >= 0")
    if max(h, b) > 65535:
        raise ValueError(f"flash_attention: {b} batches x {h} heads exceed the launch grid")


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward attention of q against k/v, scores scaled by ``scale``
    (1/sqrt(D) by default); CUDA tensors run the kernel, CPU and meta
    tensors :func:`attention_plain`.  ``flash_attention.launches`` counts
    kernel launches."""
    if q.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes, no data
        return attention_plain(q, k, v, causal=causal, window=window, chunk=chunk, scale=scale)
    _check(q, k, v, window, chunk)
    refuse_autograd("flash_attention", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, s, h, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), int(window), int(chunk), 1.0 / math.sqrt(d) if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (CUDA error {rc})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
