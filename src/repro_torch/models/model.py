"""LM assembly: the dense decoder, MoE, SSM and hybrid branches.

Port of the dense, MoE (deepseek-moe), SSM (mamba2) and hybrid (zamba2)
branches of ``repro/models/model.py``:

* ``init_params(gen, cfg)``            — stacked per-layer params (leading ``L``)
* ``init_cache(cfg, batch, context)``   — stacked decode cache
* ``prefill(params, cfg, batch, cache)`` → (last-token logits, cache)
* ``decode_step(params, cfg, tokens, positions, cache)`` → (logits, cache)

Parameters and caches keep the JAX pytree's keys and shapes, so
:mod:`repro_torch.bridge` maps one onto the other 1:1.  A Python loop over
the layers replaces ``lax.scan``; each layer reads views of the stacked
tensors, so cache writes land in the stacked cache in place (where the JAX
package donates it).  The hybrid's shared attention+MLP block runs after
every ``attn_every``-th layer on its own slice ``idx // attn_every`` of
the stacked ``shared_attn`` cache, where the reference has ``lax.cond``.
A MoE layer's FFN is :func:`repro_torch.models.moe.moe_apply` (its aux
loss is dropped, as the reference's serving path drops it).  Other
families (MLA, encoder-decoder, VLM) raise ``NotImplementedError`` until
their slice is ported (ROADMAP.md, queue A); so do chunked-local
attention layers (``llama4-scout``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import Params, dense_init, embed_init, ffn_apply, ffn_init, rms_norm

__all__ = ["init_params", "init_cache", "prefill", "decode_step", "model_dtype"]


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: ArchConfig) -> None:
    plain = not cfg.is_encdec and cfg.frontend == "none"
    decoder = cfg.family in ("dense", "moe") and cfg.attn_kind in ("full", "swa")
    hybrid = cfg.family == "hybrid" and cfg.attn_kind == "swa" and cfg.attn_every > 0
    if not (plain and (decoder or cfg.family == "ssm" or hybrid)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attn_kind!r} attention is not "
            "ported yet; the port has the GQA decoder (dense or MoE, full or SWA attention), "
            "the SSM and the SWA hybrid only (ROADMAP.md, queue A)"
        )


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: views, not copies."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _put(stacked: Any, tree: Any, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, i)
    else:
        stacked[i] = tree


def _init_stacked(make, n: int) -> Any:
    """``n`` trees from ``make()`` stacked on a leading dim, drawn in order
    and copied one at a time into preallocated leaves, so the peak is the
    stack plus one tree (a list of trees and their stack would hold two
    copies of the weights)."""
    first = make()
    stacked = _map(first, lambda t: t.new_empty((n,) + t.shape))
    _put(stacked, first, 0)
    del first
    for i in range(1, n):
        _put(stacked, make(), i)
    return stacked


# ------------------------------------------------------------------- params
def _block_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """Pre-norm attention + FFN (``moe`` in a MoE layer): a dense or MoE
    layer, or the hybrid's shared block."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)  # noqa: E731
    p = {"ln1": ones(), "attn": attn.attn_init(gen, cfg, dtype), "ln2": ones()}
    if cfg.is_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_ffn)
    return p


def _layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    if cfg.family in ("ssm", "hybrid"):
        return {
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
            "ssm": ssm_mod.ssm_init(gen, cfg, dtype),
        }
    return _block_init(gen, cfg, dtype)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    _check_ported(cfg)
    dtype = model_dtype(cfg)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, scale=1.0 / math.sqrt(cfg.d_model))
    p["layers"] = _init_stacked(lambda: _layer_init(gen, cfg, dtype), cfg.n_layers)
    if cfg.family == "hybrid":
        p["shared_block"] = _block_init(gen, cfg, dtype)
    return p


def _embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]  # (V, d)
    return torch.einsum("bsd,vd->bsv", x, head)


# ------------------------------------------------------------------- caches
def _stacked(one: Params, n: int) -> Params:
    return {k: v[None].expand((n,) + v.shape).clone() for k, v in one.items()}


def init_cache(cfg: ArchConfig, batch: int, context: int, device: Union[str, torch.device, None] = "cuda") -> Params:
    """Stacked (per-layer leading dim) decode cache: zero K/V with every
    position tag -1 (``kv``, dense), zero SSM and conv state (``ssm``), and
    for the hybrid one K/V ring per shared-block invocation
    (``shared_attn``)."""
    _check_ported(cfg)
    dtype, dev = model_dtype(cfg), resolve_device(device)
    L = cfg.n_layers
    if cfg.family in ("dense", "moe"):
        return {"kv": _stacked(attn.init_kv_cache(cfg, batch, context, dtype, dev), L)}
    cache = {"ssm": _stacked(ssm_mod.init_ssm_cache(cfg, batch, dtype, dev), L)}
    if cfg.family == "hybrid":
        n_inv = (L + cfg.attn_every - 1) // cfg.attn_every
        cache["shared_attn"] = _stacked(attn.init_kv_cache(cfg, batch, context, dtype, dev), n_inv)
    return cache


# ---------------------------------------------------------- prefill / decode
def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: Params) -> Tuple[torch.Tensor, Params]:
    """Process the prompt ``batch["tokens"]`` (B, S); returns (logits for
    the last position (B, 1, V), cache filled in place)."""
    _check_ported(cfg)
    x = _embed_tokens(params, batch["tokens"])
    for i in range(cfg.n_layers):
        lp = _index(params["layers"], i)
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if "ssm" in lp:
            a, _ = ssm_mod.ssm_apply(lp["ssm"], hn, cfg, state=_index(cache["ssm"], i))
            x = x + a
        else:
            a, _ = attn.attention_prefill(lp["attn"], hn, cfg, _index(cache["kv"], i), cfg.attn_kind, cfg.window)
            x = x + a
            x = x + _channel(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
        if "shared_block" in params and i % cfg.attn_every == 0:
            x = _shared_block(params["shared_block"], cfg, x, _index(cache["shared_attn"], i // cfg.attn_every))
    return _logits(params, cfg, x[:, -1:, :]), cache


def _channel(lp: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """A layer's channel mixer: the MoE FFN or the dense FFN."""
    if "moe" in lp:
        return moe_mod.moe_apply(lp["moe"], h, cfg)[0]
    return ffn_apply(lp["ffn"], h, gated=cfg.gated_ffn)


def _shared_block(sp: Params, cfg: ArchConfig, x: torch.Tensor, sa: Params, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hybrid's shared attention+MLP block on its cache slice ``sa``:
    prompt attention (``positions`` None) or one decode step."""
    hn = rms_norm(x, sp["ln1"], cfg.norm_eps)
    if positions is None:
        a, _ = attn.attention_prefill(sp["attn"], hn, cfg, sa, cfg.attn_kind, cfg.window)
    else:
        a, _ = attn.attention_decode(sp["attn"], hn, cfg, sa, positions, cfg.attn_kind, cfg.window)
    x = x + a
    return x + ffn_apply(sp["ffn"], rms_norm(x, sp["ln2"], cfg.norm_eps), gated=cfg.gated_ffn)


def decode_step(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # (B, 1)
    positions: torch.Tensor,  # (B,) absolute position of the new token
    cache: Params,
) -> Tuple[torch.Tensor, Params]:
    """One token per row; returns (logits (B, 1, V), cache updated in place)."""
    _check_ported(cfg)
    x = _embed_tokens(params, tokens)
    for i in range(cfg.n_layers):
        lp = _index(params["layers"], i)
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if "ssm" in lp:
            a, _ = ssm_mod.ssm_decode(lp["ssm"], hn, cfg, _index(cache["ssm"], i))
            x = x + a
        else:
            a, _ = attn.attention_decode(lp["attn"], hn, cfg, _index(cache["kv"], i), positions, cfg.attn_kind, cfg.window)
            x = x + a
            x = x + _channel(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
        if "shared_block" in params and i % cfg.attn_every == 0:
            x = _shared_block(params["shared_block"], cfg, x, _index(cache["shared_attn"], i // cfg.attn_every), positions)
    return _logits(params, cfg, x), cache
