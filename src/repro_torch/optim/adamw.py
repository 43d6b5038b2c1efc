"""AdamW + schedules over trees of tensors.

Port of ``repro/optim/adamw.py``.  Optimizer state: f32 first and second
moments per parameter leaf, and a step count.  Where the reference returns
new trees (and ``jit`` donates the old ones), :func:`adamw_update` writes
the new parameters and moments into the given tensors in place, so a
full-width state is held once; it returns the same trees.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..tree import leaves as tree_leaves
from ..tree import tree_map

__all__ = ["OptHParams", "adamw_init", "adamw_update", "warmup_cosine", "global_norm"]


@dataclass(frozen=True)
class OptHParams:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def variant(self, **kw) -> "OptHParams":
        return dataclasses.replace(self, **kw)


def warmup_cosine(step: torch.Tensor, hp: OptHParams) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min`` at
    ``total_steps``; f32, as the reference computes it."""
    step = torch.as_tensor(step).float()
    warm = hp.lr_peak * step / max(hp.warmup_steps, 1)
    frac = torch.clamp((step - hp.warmup_steps) / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = hp.lr_min + 0.5 * (hp.lr_peak - hp.lr_min) * (1 + torch.cos(math.pi * frac))
    return torch.where(step < hp.warmup_steps, warm, cos)


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = next(iter(tree_leaves(params)), torch.zeros(())).device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(
    grads: Any,
    opt_state: Dict[str, Any],
    params: Any,
    hp: OptHParams,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping; weight decay on leaves of
    two or more dims only (norms and biases exempt).  Updates ``params``
    and the moments in place and returns ``(params, opt_state, metrics)``."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(hp.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = warmup_cosine(count, hp)
    b1, b2 = hp.beta1, hp.beta2
    bc1 = 1 - b1 ** count.float()
    bc2 = 1 - b2 ** count.float()
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]), tree_leaves(params)):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        step = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
        if p.dim() >= 2:  # decay matrices only (norms/bias exempt)
            step = step + hp.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
