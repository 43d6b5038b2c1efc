"""Where the port runs: ``cuda`` unless the caller asks for the CPU (or for
``meta``, the dry-run's shapes without data)."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on.  ``None`` means ``cuda``.  A CUDA
    request without a usable card raises: the port never carries on on the
    CPU unless the caller asked for it.  ``meta`` (shapes and dtypes, no
    data, no card) is the dry-run's."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
