"""Plain float32 reference of the port's MoE decoder (deepseek-moe-16b).

Every layer: pre-norm causal self-attention (RoPE, split halves), then a
pre-norm MoE FFN: a float32 softmax router, the top-k experts per token
with gates renormalised over the k, SwiGLU experts, plus the shared
experts as one SwiGLU of width ``d_ff * n_shared_experts``.  Imports
nothing of the port.

It computes what the served model computes, which departs from the
published model in two ways the reference must follow:

* every layer is MoE (the published first layer is dense);
* a prompt is routed as one group with a capacity per expert of
  ``max(ceil(P * k / E * capacity_factor), 4)`` token slots, filled in
  slot-major order (every token's first choice, then every token's
  second, ...); a slot past the capacity is dropped.  A decoded token is a
  group of its own, whose k distinct experts never exceed the capacity.

The layers run one at a time over every request, each layer's weights
converted to float32 once (the float32 model does not fit beside the bf16
weights).

The family's parameter tree (:func:`layout`) and its products a token
(:func:`per_token_flops`, :func:`attention_calls`) sit beside the forward
pass that reads them; the benchmark finds them by the configuration's
``reference`` key.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .common import (attention, attention_layout, attention_proj_flops, head_layout, head_logits, layer, normal,
                     ones, rms_norm, served_positions, swiglu, swiglu_flops, swiglu_layout)


def layout(cfg):
    """Every layer stacked on a leading L: pre-norm attention, then the MoE
    FFN (its float32 router, the routed experts, the shared experts as one
    SwiGLU of width ``d_ff * n_shared_experts``)."""
    d, L = cfg["d_model"], cfg["n_layers"]
    e, f, ns = cfg["n_experts"], cfg["d_ff"], cfg["n_shared_experts"]
    lead = (L,)
    moe = {
        "router": normal(lead + (d, e), d, "float32"),
        "w_up": normal(lead + (e, d, f), d), "w_gate": normal(lead + (e, d, f), d),
        "w_down": normal(lead + (e, f, d), f),
    }
    if ns:
        moe["shared"] = swiglu_layout(d, f * ns, lead)
    return {**head_layout(cfg),
            "layers": {"ln1": ones(lead + (d,)), "attn": attention_layout(cfg, lead), "ln2": ones(lead + (d,)), "moe": moe}}


def per_token_flops(cfg) -> float:
    """A layer: the attention projections, the router 2 D E, k routed and
    the shared SwiGLU experts."""
    d, f = cfg["d_model"], cfg["d_ff"]
    moe = 2 * d * cfg["n_experts"] + (cfg["top_k"] + cfg["n_shared_experts"]) * swiglu_flops(d, f)
    return cfg["n_layers"] * (attention_proj_flops(cfg) + moe)


def attention_calls(cfg) -> int:
    return cfg["n_layers"]


def capacity(tokens: int, cfg) -> int:
    return max(int(math.ceil(tokens * cfg["top_k"] / cfg["n_experts"] * cfg["capacity_factor"])), 4)


def route(x: torch.Tensor, router: torch.Tensor, cfg, prompt_len: int):
    """(experts (S,k), gates (S,k), kept (S,k)) for hidden states x (S, D)."""
    probs = torch.softmax(x @ router, dim=-1)
    top, idx = torch.topk(probs, cfg["top_k"], dim=-1)
    gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    kept = torch.ones_like(idx, dtype=torch.bool)
    p, k, e = prompt_len, cfg["top_k"], cfg["n_experts"]
    order = idx[:p].T.reshape(-1)  # the prompt's slots, slot-major
    hot = F.one_hot(order, e)
    rank = (torch.cumsum(hot, 0) - hot).gather(1, order[:, None])[:, 0]  # earlier slots on the same expert
    kept[:p] = (rank < capacity(p, cfg)).view(k, p).T
    return idx, gates, kept


def moe(p, x: torch.Tensor, cfg, prompt_len: int, mode: str) -> torch.Tensor:
    idx, gates, kept = route(x, p["router"], cfg, prompt_len)
    out = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        tok, slot = torch.nonzero((idx == e) & kept, as_tuple=True)
        if tok.numel():
            w = {"w_gate": p["w_gate"][e], "w_up": p["w_up"][e], "w_down": p["w_down"][e]}
            out.index_add_(0, tok, swiglu(w, x[tok], mode) * gates[tok, slot, None])
    if "shared" in p:
        out = out + swiglu(p["shared"], x, mode)
    return out


def served_logits(params, cfg, requests: Sequence[Tuple[List[int], List[int]]], mode: str = "f32") -> List[torch.Tensor]:
    """Per request (prompt, served tokens): the logits (T, V) at the
    positions that chose each served token."""
    seqs = served_positions(requests)
    emb = params["embed"]
    hs = [emb[torch.tensor(ids, device=emb.device)].float() for ids, _, _ in seqs]
    for i in range(cfg["n_layers"]):
        lp = layer(params["layers"], i)
        for j, (_, plen, _) in enumerate(seqs):
            h = hs[j]
            h = h + attention(lp["attn"], rms_norm(h, lp["ln1"], cfg["norm_eps"]), cfg, 0, mode)
            hs[j] = h + moe(lp["moe"], rms_norm(h, lp["ln2"], cfg["norm_eps"]), cfg, plen, mode)
        del lp
    return [head_logits(params, cfg, h[pos], mode) for h, (_, _, pos) in zip(hs, seqs)]
