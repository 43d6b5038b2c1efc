"""PyTorch/CUDA port of the JAX package ``repro``, one slice at a time.

The package sits beside ``src/repro`` with the same sub-package layout;
each module is held against its JAX counterpart by the tests.  It imports
``torch``, ``numpy`` and the standard library only.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; kernels pick their
route by the tensors' device (see :mod:`repro_torch.kernels`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
