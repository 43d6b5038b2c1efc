"""Grouped (per-expert) matmul for MoE FFN batches: the Hopper kernel's
wrapper and its plain PyTorch version.

The kernel (``csrc/moe_gmm.cu``) replaces the Pallas TPU kernel
``_gmm_kernel`` of ``repro/kernels/moe_gmm.py``; see the source's header
for its design.  It computes (E, C, D) × (E, D, F) → (E, C, F), every
expert's token queue against its own weights, in f32, cast to x's dtype.
:func:`grouped_matmul` picks the route by the tensors' device: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes
:func:`grouped_matmul_plain`.  Unlike the TPU kernel, any C, D and F work:
the kernel masks the ragged tiles itself.  The kernel reads x and w through
their strides but wants their last dims (D and F) contiguous: the wrapper
copies an operand whose last dim is not (same values, so the same result
bit for bit) and counts it in ``grouped_matmul.copies``.  Both routes
write into a given ``out`` where they are handed one (a CUDA graph that
reads the product needs it at the address it captured).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .guard import refuse_autograd

__all__ = ["grouped_matmul", "grouped_matmul_plain", "DTYPES"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_C = 64  # output rows of one block of the f32 route: BC in csrc/moe_gmm.cu


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy of ``repro.kernels.ref.grouped_matmul_ref``: the product in
    f32, cast to x's dtype (written into ``out`` when given)."""
    if out is not None:
        _check_out(out, x, w)
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
    return y if out is None else out.copy_(y)


def _check_out(out: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> None:
    want = (x.shape[0], x.shape[1], w.shape[2])
    if tuple(out.shape) != want or out.dtype != x.dtype or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"grouped_matmul: out must be a contiguous {want} {x.dtype} tensor on {x.device}; "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"grouped_matmul: x and w must lie on one CUDA device (got {x.device}, {w.device})")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: dtypes {x.dtype}, {w.dtype}; the kernel takes float32 or bfloat16, both alike")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_matmul: want x (E,C,D) and w (E,D,F); got {tuple(x.shape)}, {tuple(w.shape)}")
    e, c, _ = x.shape
    if e > 65535 or -(-c // BLOCK_C) > 65535 or max(x.shape + w.shape) > 2**31 - 1:
        raise ValueError(f"grouped_matmul: {e} experts x {c} rows exceed the launch grid")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("moe_gmm")
    lib.repro_gmm_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    lib.repro_gmm_fwd.restype = ctypes.c_int
    return lib


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D) × w (E, D, F) → (E, C, F) in x's dtype, written into
    ``out`` (contiguous, x's dtype and device) when given.  CUDA tensors
    run the kernel (read through their strides; an operand whose last dim
    is not contiguous is first copied contiguous), CPU and meta tensors
    :func:`grouped_matmul_plain`.  ``grouped_matmul.launches`` counts
    kernel launches, ``grouped_matmul.copies`` the copies."""
    if x.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes, no data
        return grouped_matmul_plain(x, w, out)
    _check(x, w)
    if out is not None:
        _check_out(out, x, w)
    refuse_autograd("grouped_matmul", x, w)
    if x.shape[2] > 1 and x.stride(2) != 1:
        x = x.contiguous()
        grouped_matmul.copies += 1
    if w.shape[2] > 1 and w.stride(2) != 1:
        w = w.contiguous()
        grouped_matmul.copies += 1
    e, c, d = x.shape
    f = w.shape[2]
    if out is None:
        out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().repro_gmm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPES[x.dtype], e, c, d, f,
            *x.stride(), *w.stride(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"grouped_matmul: kernel launch failed (CUDA error {rc})")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
grouped_matmul.copies = 0
