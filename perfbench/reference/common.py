"""Plain float32 building blocks of the references.

Imports nothing of the port.  Every product goes through :func:`linear`,
which in the control's mode ``"fp8"`` rounds both operands to float8
(e4m3, a scale per row of the activations and per output column of the
weights) before the float32 product: the reference computed one precision
below the configuration's bf16.  TF32 is off for the whole process that
imports this module's :func:`strict_f32`.

Beside each block, the leaves of its parameters (for a family's
``layout``) and its products' operations (for ``per_token_flops``): a leaf
is ``(shape, dtype, init)``, drawn by ``perfbench/weights.py``, with dtype
``"model"`` for the configuration's own type.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
MODES = ("f32", "fp8")


def strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``'s complement."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; in ``"fp8"`` both operands rounded first."""
    if mode == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x (S, H, hd) by position: split halves (the first half pairs with the second)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (pos.double()[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def normal(shape, fan_in, dtype="model"):
    """A leaf drawn from a normal of scale 1/sqrt(fan_in)."""
    return (tuple(shape), dtype, ("normal", 1.0 / math.sqrt(fan_in)))


def ones(shape):
    return (tuple(shape), "model", ("const", 1.0))


def head_dim(cfg) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def attention_layout(cfg, lead=()):
    """GQA projections, in the port's (D, H, hd) and (H, hd, D) layout."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    return {
        "wq": normal(lead + (d, h, hd), d), "wk": normal(lead + (d, kv, hd), d),
        "wv": normal(lead + (d, kv, hd), d), "wo": normal(lead + (h, hd, d), h * hd),
    }


def attention_proj_flops(cfg) -> float:
    """The four projections of :func:`attention`, a token: 2 D (H hd + 2 KV hd) + 2 H hd D."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    return 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, window: int, mode: str) -> torch.Tensor:
    """Causal GQA self-attention over one sequence x (S, D), keys within
    ``window`` positions when it is > 0; query head h reads kv head h // (H / KV)."""
    s, d = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    q = linear(x, p["wq"].reshape(d, h * hd), mode).view(s, h, hd)
    k = linear(x, p["wk"].reshape(d, kv * hd), mode).view(s, kv, hd)
    v = linear(x, p["wv"].reshape(d, kv * hd), mode).view(s, kv, hd)
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    visible = pos[None, :] <= pos[:, None]
    if window:
        visible &= pos[None, :] > pos[:, None] - window
    out = torch.empty((s, h, hd), device=x.device)
    for h0 in range(0, h, 4):  # a few heads at a time: (4, S, S) scores
        sc = torch.einsum("qhk,shk->hqs", q[:, h0:h0 + 4], k[:, h0:h0 + 4]) / math.sqrt(hd)
        pr = torch.softmax(sc.masked_fill(~visible, -math.inf), dim=-1)
        out[:, h0:h0 + 4] = torch.einsum("hqs,shk->qhk", pr, v[:, h0:h0 + 4])
    return linear(out.reshape(s, h * hd), p["wo"].reshape(h * hd, d), mode)


def swiglu_layout(d: int, f: int, lead=()):
    return {"w_up": normal(lead + (d, f), d), "w_gate": normal(lead + (d, f), d), "w_down": normal(lead + (f, d), f)}


def swiglu_flops(d: int, f: int) -> float:
    """The three products of :func:`swiglu` of width f, a token: 6 D F."""
    return 6 * d * f


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor, mode: str) -> torch.Tensor:
    return linear(F.silu(linear(x, p["w_gate"], mode)) * linear(x, p["w_up"], mode), p["w_down"], mode)


def to_f32(tree):
    """A float32 copy of a (nested) parameter dict."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    return tree.float()


def layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree, in float32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def served_positions(requests: Sequence[Tuple[List[int], List[int]]]):
    """Per request: the token ids the reference reads (the prompt and every
    served token but the last), and the positions whose logits chose the
    served tokens (the prompt's last, then each served one's)."""
    out = []
    for prompt, served in requests:
        ids = list(prompt) + list(served[:-1])
        out.append((ids, len(prompt), list(range(len(prompt) - 1, len(ids)))))
    return out


def head_layout(cfg):
    """The embedding (scale 1), the final norm and the untied head that :func:`head_logits` reads."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    return {"embed": normal((v, d), 1), "ln_f": ones((d,)), "lm_head": normal((v, d), d)}


def head_logits(params, cfg, h: torch.Tensor, mode: str) -> torch.Tensor:
    """Logits (S, V) of hidden states h (S, D)."""
    x = rms_norm(h, params["ln_f"].float(), cfg["norm_eps"])
    return linear(x, params["lm_head"].float().T, mode)
