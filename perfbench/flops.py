"""Model FLOPs: the products a token needs, counted as 2 operations a
multiply-add, from a configuration file's sizes.  Norms, activations and
the embedding lookup are left out (a few operations a value, against
thousands for a product).

What depends on the family comes from its reference module
(``reference/<cfg["reference"]>.py``, found by ``cells.family``):
* ``per_token_flops(cfg)``   every product of a token but the attention scores and the head
* ``attention_calls(cfg)``   the self-attention calls a token passes through
* ``attention_score_flops(cfg, pairs)``, optional: one call's scores over
  ``pairs`` visible (query, key) pairs; by default 4 H hd a pair
What every family shares is here: the visible pairs of a causal prompt
(within a sliding window), and the head, 2 D V a token whose logits are
computed.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from perfbench.cells import family
from perfbench.reference.common import head_dim


def attn_scores(cfg: Dict) -> Callable[[float], float]:
    """One attention call's scores as a function of its visible pairs."""
    own = family(cfg, "attention_score_flops", required=False)
    if own is not None:
        return lambda pairs: own(cfg, pairs)
    per_pair = 4 * cfg["n_heads"] * head_dim(cfg)
    return lambda pairs: per_pair * pairs


def attention_layers(cfg: Dict) -> int:
    """Self-attention calls a token passes through."""
    return family(cfg, "attention_calls")(cfg)


def per_token(cfg: Dict) -> float:
    """Everything but the attention scores and the head."""
    return family(cfg, "per_token_flops")(cfg)


def window(cfg: Dict) -> int:
    return cfg["window"] if cfg.get("attn_kind") == "swa" and cfg.get("window") else 0


def visible_pairs(s: int, win: int = 0) -> int:
    """(query, key) pairs of a causal prompt of s tokens, keys within ``win`` (0: all)."""
    if not win or win >= s:
        return s * (s + 1) // 2
    return win * (win + 1) // 2 + (s - win) * win


def counters(cfg: Dict) -> Tuple[Callable[[int], float], Callable[[int], float]]:
    """``(prefill(s), decode(position))`` of ``cfg``, its family's functions
    looked up once: a prompt of s tokens with the logits of its last
    position only, and one token at ``position`` (0-based), which sees
    position + 1 keys."""
    per, calls, scores, win = per_token(cfg), attention_layers(cfg), attn_scores(cfg), window(cfg)
    head = 2 * cfg["d_model"] * cfg["vocab_size"]

    def prefill(s: int) -> float:
        return s * per + calls * scores(visible_pairs(s, win)) + head

    def decode(position: int) -> float:
        seen = min(position + 1, win) if win else position + 1
        return per + calls * scores(seen) + head

    return prefill, decode


def prefill(cfg: Dict, s: int) -> float:
    """A prompt of s tokens, logits of its last position only."""
    return counters(cfg)[0](s)


def decode(cfg: Dict, position: int) -> float:
    """One token at ``position`` (0-based), which sees position + 1 keys."""
    return counters(cfg)[1](position)
