"""Meta-tensor stand-ins for every model input and state (no allocation).

Port of ``repro/launch/specs.py``: where the reference returns
``jax.ShapeDtypeStruct``s (``jax.eval_shape``), these are tensors on
``torch.device("meta")`` with the reference's shapes and dtypes.
``input_specs(arch, shape)`` returns the abstract batch for a cell: token
ids (+ labels) for training, prompt tokens for prefill, one-token batches
(+ positions) for decode.  Modality frontends are stubs: ``frames``
(audio) / ``prefix`` (vision) arrive as precomputed embeddings.  The
parameters, cache and train state run the port's own initializers on
meta, drawing from a generator that reports the meta device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models import model as model_lib

__all__ = ["input_specs", "abstract_params", "abstract_cache", "abstract_train_state", "META"]

META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta: the initializers allocate on
    their generator's device, and meta tensors ignore the draws."""

    device = META


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, arch.dtype)
    if shape.kind in ("train", "prefill"):
        s_text = s - (arch.n_prefix_tokens if arch.frontend == "vision" else 0)
        batch: Dict[str, Any] = {"tokens": _sds((b, s_text), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _sds((b, s_text), torch.int32)
        if arch.frontend == "vision":
            batch["prefix"] = _sds((b, arch.n_prefix_tokens, arch.d_model), dt)
        if arch.is_encdec:
            batch["frames"] = _sds((b, arch.encoder_seq, arch.d_model), dt)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _sds((b, 1), torch.int32), "positions": _sds((b,), torch.int32)}


def abstract_params(arch: ArchConfig) -> Any:
    return model_lib.init_params(_MetaGenerator(), arch)


def abstract_cache(arch: ArchConfig, batch: int, context: int) -> Any:
    return model_lib.init_cache(arch, batch, context, device=META)


def abstract_train_state(arch: ArchConfig, tcfg=None) -> Any:
    from ..train import init_train_state

    return init_train_state(_MetaGenerator(), arch, tcfg)
