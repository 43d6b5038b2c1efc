"""Model FLOPs: the products a token needs, counted as 2 operations a
multiply-add, from a configuration file's sizes.  Norms, activations and
the embedding lookup are left out (a few operations a value, against
thousands for a product).

Per token, per layer:
* attention projections  2 D (H hd + 2 KV hd) + 2 H hd D
* attention scores       4 H hd v, v = the keys the token sees (causal, within the window)
* SwiGLU of width F      6 D F
* MoE                    2 D E (router) + k 6 D F (routed) + 6 D F n_shared (shared)
and once a token whose logits are computed: 2 D V.
"""
from __future__ import annotations

from typing import Dict


def _hd(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def attn_proj(cfg: Dict) -> float:
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg)
    return 2 * d * (h * hd + 2 * kv * hd) + 2 * h * hd * d


def attn_scores(cfg: Dict, pairs: float) -> float:
    return 4 * cfg["n_heads"] * _hd(cfg) * pairs


def moe_ffn(cfg: Dict) -> float:
    d, f = cfg["d_model"], cfg["d_ff"]
    return 2 * d * cfg["n_experts"] + cfg["top_k"] * 6 * d * f + cfg["n_shared_experts"] * 6 * d * f


def attention_layers(cfg: Dict) -> int:
    """Self-attention calls a token passes through."""
    return cfg["n_layers"]


def per_token(cfg: Dict) -> float:
    """Everything but the attention scores and the head."""
    if cfg["family"] == "moe":
        return cfg["n_layers"] * (attn_proj(cfg) + moe_ffn(cfg))
    raise ValueError(f"no FLOP count for the family {cfg['family']!r}")


def window(cfg: Dict) -> int:
    return cfg["window"] if cfg.get("attn_kind") == "swa" and cfg.get("window") else 0


def visible_pairs(s: int, win: int = 0) -> int:
    """(query, key) pairs of a causal prompt of s tokens, keys within ``win`` (0: all)."""
    if not win or win >= s:
        return s * (s + 1) // 2
    return win * (win + 1) // 2 + (s - win) * win


def prefill(cfg: Dict, s: int) -> float:
    """A prompt of s tokens, logits of its last position only."""
    pairs = visible_pairs(s, window(cfg))
    return s * per_token(cfg) + attention_layers(cfg) * attn_scores(cfg, pairs) + 2 * cfg["d_model"] * cfg["vocab_size"]


def decode(cfg: Dict, position: int) -> float:
    """One token at ``position`` (0-based), which sees position + 1 keys."""
    seen = position + 1
    if window(cfg):
        seen = min(seen, window(cfg))
    return per_token(cfg) + attention_layers(cfg) * attn_scores(cfg, seen) + 2 * cfg["d_model"] * cfg["vocab_size"]

