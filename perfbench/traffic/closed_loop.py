"""Closed loop: ``clients`` clients, each with one request in flight, the
next sent as soon as the last one's final token arrives.

Round r holds the r-th request of every client; its prompt and output
lengths are the quantiles (i + frac(1/2 + r * golden ratio)) / clients of the
mix's distributions, in an order drawn from the seed, so every seed sends
the same lengths in another order.  Token ids are drawn from the seed.
Rounds are drawn in order from a generator nothing else reads, so the
timing of the run cannot change what a client sends.  Before the window
opens, the first round fills every slot.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from perfbench.traffic.lengths import GOLDEN, stratified

Spec = Tuple[Optional[int], float, List[int], int]  # (client, due seconds after opening, prompt, max_new)


class Traffic:
    open_loop = False

    def __init__(self, mix: Dict, cell: Dict, rng, seconds: float, vocab: int):
        self.clients, self.mix, self.rng, self.vocab = mix["clients"], mix, rng, vocab
        self.rounds = []
        self.sent = [0] * self.clients
        for _ in range(2):
            self._draw_round()

    def _draw_round(self) -> None:
        n, off = self.clients, (0.5 + len(self.rounds) * GOLDEN) % 1.0
        p, o = stratified(self.mix["prompt"], n, self.rng, off), stratified(self.mix["output"], n, self.rng, off)
        self.rounds.append([(self.rng.integers(0, self.vocab, p[c]).tolist(), o[c]) for c in range(n)])

    def _spec(self, client: int, due: float) -> Spec:
        r = self.sent[client]
        while r >= len(self.rounds):
            self._draw_round()
        self.sent[client] += 1
        prompt, out = self.rounds[r][client]
        return client, due, prompt, out

    def prime(self) -> List[Spec]:
        """The first round, sent before the window opens."""
        return [self._spec(c, 0.0) for c in range(self.clients)]

    def due(self, now: float, freed: List[int]) -> List[Spec]:
        """The requests of the clients whose last request finished."""
        return [self._spec(c, now) for c in freed]

    def next_due(self) -> float:
        return math.inf

    def lengths(self) -> Tuple[List[int], List[int]]:
        return [len(p) for r in self.rounds for p, _ in r], [o for r in self.rounds for _, o in r]
