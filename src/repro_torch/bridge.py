"""Carry JAX-made parameters, caches and train states into the port.

The JAX package's pytrees arrive as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``); the port's trees have the
same keys and shapes, so the two packages compute the same function on the
same weights.  bf16 arrives as ``ml_dtypes.bfloat16``, which torch cannot
read: it crosses as its ``uint16`` bits and is viewed back as bf16.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "cache_from_jax", "train_state_from_jax"]


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_from_jax(tree: Any, device: Union[str, torch.device, None] = "cuda") -> Any:
    """A JAX parameter tree (numpy leaves) as the port's parameter tree."""
    return _tree(tree, resolve_device(device))


def cache_from_jax(tree: Any, device: Union[str, torch.device, None] = "cuda") -> Any:
    """A JAX decode cache (numpy leaves) as the port's cache."""
    return _tree(tree, resolve_device(device))


def train_state_from_jax(state: Any, device: Union[str, torch.device, None] = "cuda") -> Any:
    """A JAX train state (numpy leaves: ``params``, ``opt`` with ``mu``,
    ``nu`` and ``count``, ``step``, and ``ef`` under int8_ef) as the port's
    train state."""
    missing = {"params", "opt", "step"} - set(state)
    if missing or {"mu", "nu", "count"} - set(state["opt"]):
        raise ValueError(f"not a train state: keys {sorted(state)}")
    return _tree(state, resolve_device(device))
