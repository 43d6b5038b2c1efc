"""The rule every CUDA kernel wrapper keeps under autograd.

A wrapper hands the kernel raw pointers and returns a tensor that autograd
knows nothing of: called on inputs that require grad, with grad mode on,
its output would carry no ``grad_fn`` and every gradient upstream of it
would silently vanish.  So the wrapper refuses; the way through a kernel
under autograd is an ``autograd.Function`` whose forward calls it (grad
mode is off inside ``forward``).
"""
from __future__ import annotations

import torch

__all__ = ["refuse_autograd"]


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and its output would be silently "
            "detached from autograd; call it under torch.no_grad() / inference_mode(), "
            "or through the autograd.Function that wraps it"
        )
