"""The train step: microbatched grad accumulation, remat, AdamW.

Port of ``repro/train/step.py``.  ``make_train_step(cfg, hp, tcfg)``
returns ``(state, batch) → (state, metrics)``.  The global batch splits
into ``microbatches`` slices run in order with f32 gradient accumulation;
``grad_sync="int8_ef"`` passes the gradients through int8 compression with
error feedback (:mod:`repro_torch.train.grad_sync`), its residual carried
in ``state["ef"]``.

Where the reference's step is pure and ``jit`` donates the old state, this
one updates ``state`` in place (parameters and moments through
:func:`~repro_torch.optim.adamw_update`; ``ef`` and ``step`` rebound), so a
full-width run holds one copy of the optimizer state.  Gradients come from
``torch.autograd.grad`` over the parameter leaves, which require grad only
for the length of the forward and backward.

A state of DTensors (placed by :mod:`repro_torch.sharding.params`) takes
the same step on each rank's shards; a DTensor op picks its output's
placement by its own strategy, so every state leaf is redistributed back
to the placement it came in with, and the metrics come back as plain
(replicated) tensors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..models import model as model_lib
from ..optim import OptHParams, adamw_init, adamw_update
from ..sharding.logical import is_dtensor, replicate_plain
from ..tree import leaves as tree_leaves
from ..tree import tree_map, unflatten
from .grad_sync import compress_grads_int8_ef

__all__ = ["TrainConfig", "TrainState", "init_train_state", "loss_and_grads", "make_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "dots"  # 'none' | 'full' | 'dots' | 'dots_no_batch'
    grad_sync: str = "auto"  # 'auto' (no compression) | 'int8_ef' (explicit compression)
    # Which packer the explicit-DP wire hand-off uses: 'host' = the numpy
    # reference loop, 'device' = the fused quantize+pack kernel
    # (bit-identical wire bytes; see grad_sync.make_packer).  Read by
    # nothing in the step, as in the reference.
    grad_pack: str = "host"

    def __post_init__(self):
        if self.grad_pack not in ("host", "device"):
            raise ValueError(f"grad_pack must be 'host' or 'device', got {self.grad_pack!r}")

    def variant(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


TrainState = Dict[str, Any]  # {"params", "opt", "step", ["ef"]}


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_train_state(gen: torch.Generator, cfg: ArchConfig, tcfg: Optional[TrainConfig] = None) -> TrainState:
    """Random parameters from ``gen`` (on its device), zero moments, step 0,
    and a zero EF tree under ``grad_sync="int8_ef"``."""
    params = model_lib.init_params(gen, cfg)
    state: TrainState = {
        "params": params,
        "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }
    if tcfg is not None and tcfg.grad_sync == "int8_ef":
        state["ef"] = tree_map(_zeros_f32, params)
    return state


def loss_and_grads(
    params: Any, cfg: ArchConfig, batch: Dict[str, torch.Tensor], remat: str = "none"
) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: returns ((loss,
    metrics), grads), the grads a tree of ``params``' structure in the
    parameters' dtypes."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad(), replicate_plain(params):  # remat reruns forwards inside grad
            total, metrics = model_lib.loss_fn(params, cfg, batch, remat=remat)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), unflatten(params, grads)


def _split_micro(batch: Dict[str, torch.Tensor], m: int) -> List[Dict[str, torch.Tensor]]:
    """(B, ...) → m batches of (B/m, ...), in order."""
    for k, x in batch.items():
        if x.shape[0] % m:
            raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not split into {m} microbatches")
    return [{k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i] for k, x in batch.items()} for i in range(m)]


def make_train_step(
    cfg: ArchConfig,
    hp: OptHParams,
    tcfg: TrainConfig = TrainConfig(),
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        placed = _placements(state)
        params = state["params"]
        m = tcfg.microbatches
        if m == 1:
            (l, metrics), grads = loss_and_grads(params, cfg, batch, tcfg.remat)
        else:
            g_acc = tree_map(_zeros_f32, params)
            l = torch.zeros((), dtype=torch.float32, device=state["step"].device)
            for mb in _split_micro(batch, m):
                (l_mb, metrics), g = loss_and_grads(params, cfg, mb, tcfg.remat)
                for a, b in zip(tree_leaves(g_acc), tree_leaves(g)):
                    a.add_(b.float())
                del g
                l = l + l_mb
            grads = tree_map(lambda g: (g / m).float(), g_acc)
            del g_acc
            l = l / m
        if tcfg.grad_sync == "int8_ef":
            grads, new_ef = compress_grads_int8_ef(grads, state["ef"])
            state["ef"] = new_ef
        _, _, opt_metrics = adamw_update(grads, state["opt"], params, hp)
        state["step"] = state["step"] + 1
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss_mean"] = l
        if placed is not None:
            state = _replace(state, placed)
            metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return state, metrics

    return train_step


def _placements(state: TrainState) -> Optional[List[Any]]:
    """Each leaf's (mesh, placements) in :func:`leaves` order (None for a
    plain leaf), or None for a plain state."""
    flat = tree_leaves(state)
    if not any(is_dtensor(t) for t in flat):
        return None
    return [(t.device_mesh, tuple(t.placements)) if is_dtensor(t) else None for t in flat]


def _replace(state: TrainState, placed: List[Any]) -> TrainState:
    """Put every DTensor leaf of ``state`` back on its recorded placement,
    in the state's own dicts (the step updates the state in place)."""
    it = iter(placed)

    def walk(d: Dict[str, Any]) -> None:
        for k in sorted(d):  # :func:`leaves` order
            if isinstance(d[k], dict):
                walk(d[k])
                continue
            where = next(it)
            if where is not None and tuple(d[k].placements) != where[1]:
                d[k] = d[k].redistribute(*where)

    walk(state)
    return state
