"""Random weights from the seed, in the port's parameter format.

The benchmark makes the weights and hands the same tensors to the port and
to the plain reference, so neither side takes anything the other made.
Each stacked leaf is drawn in one call on the device, in the type it is
served in (bf16, and float32 for the router, which the port keeps in
float32), from a ``torch.Generator`` on that device.  Scales are fan-in (1/sqrt of the input width) for every
product, 1 for the embedding.  The layout (keys and shapes) is the port's
input format, read by ``repro_torch.models``, and comes from the family's
reference module (``reference/<cfg["reference"]>.py`` ``layout``), which
reads the same tree; leaves are drawn in its key order.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench.cells import family


def layout(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter tree of ``cfg``'s family (nested dict of ``(shape,
    dtype, init)`` leaves), from its reference module's ``layout``."""
    return family(cfg, "layout")(cfg)


def make_params(cfg: Dict[str, Any], seed: int, device: str) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = getattr(torch, cfg["dtype"])

    def draw(leaf):
        if isinstance(leaf, dict):
            return {k: draw(v) for k, v in leaf.items()}
        shape, dtype, (init, arg) = leaf
        dt = model if dtype == "model" else getattr(torch, dtype)
        if init == "normal":
            return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(arg)
        if init == "const":
            return torch.full(shape, arg, device=device, dtype=dt)
        raise ValueError(init)

    return draw(layout(cfg))

