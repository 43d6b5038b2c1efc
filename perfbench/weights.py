"""Random weights from the seed, in the port's parameter format.

The benchmark makes the weights and hands the same tensors to the port and
to the plain reference, so neither side takes anything the other made.
Each stacked leaf is drawn in one call on the device, in the type it is
served in (bf16, and float32 for the router, which the port keeps in
float32), from a ``torch.Generator`` on that device.  Scales are fan-in (1/sqrt of the input width) for every
product, 1 for the embedding.  The layout (keys and shapes) is the port's
input format, read by ``repro_torch.models``; the reference reads the same
tree.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

Layout = Dict[str, Any]  # nested dict of (shape, dtype, init) leaves


def _normal(shape, fan_in, dtype="model"):
    return (tuple(shape), dtype, ("normal", 1.0 / math.sqrt(fan_in)))


def _ones(shape):
    return (tuple(shape), "model", ("const", 1.0))


def _attn(cfg, lead=()):
    d, h, kv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    return {
        "wq": _normal(lead + (d, h, hd), d), "wk": _normal(lead + (d, kv, hd), d),
        "wv": _normal(lead + (d, kv, hd), d), "wo": _normal(lead + (h, hd, d), h * hd),
    }


def _ffn(d, f, lead=()):
    return {"w_up": _normal(lead + (d, f), d), "w_gate": _normal(lead + (d, f), d), "w_down": _normal(lead + (f, d), f)}


def layout(cfg: Dict[str, Any]) -> Layout:
    """The parameter tree of the port's ``moe`` family (all layers MoE)."""
    d, v, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    lead = (L,)
    tree: Layout = {"embed": ((v, d), "model", ("normal", 1.0)), "ln_f": _ones((d,)), "lm_head": _normal((v, d), d)}
    if cfg["family"] == "moe":
        e, f, ns = cfg["n_experts"], cfg["d_ff"], cfg["n_shared_experts"]
        moe = {
            "router": _normal(lead + (d, e), d, "float32"),
            "w_up": _normal(lead + (e, d, f), d), "w_gate": _normal(lead + (e, d, f), d),
            "w_down": _normal(lead + (e, f, d), f),
        }
        if ns:
            moe["shared"] = _ffn(d, f * ns, lead)
        tree["layers"] = {"ln1": _ones(lead + (d,)), "attn": _attn(cfg, lead), "ln2": _ones(lead + (d,)), "moe": moe}
    else:
        raise ValueError(f"no weight layout for the family {cfg['family']!r}")
    return tree


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

