"""Open loop: requests due at Poisson arrivals of the cell's ``rate``
(requests a second), sent when due whether or not earlier ones finished.

Every seed offers the same N = round(rate x window) requests inside the
window: the inter-arrival gaps are the exponential distribution's
quantiles (i + 1/2) / N, scaled so that the N arrivals fill the window as
N + 1 gaps would (a Poisson process given its count in the window); the
prompt and output lengths are the quantiles of the mix's distributions.
The seed draws the order of the gaps and of the lengths, and the token
ids.  No request arrives after the window.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from perfbench.traffic.lengths import stratified

Spec = Tuple[None, float, List[int], int]


class Traffic:
    open_loop = True

    def __init__(self, mix: Dict, cell: Dict, rng, seconds: float, vocab: int):
        n = max(1, round(cell["rate"] * seconds))
        gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
        scale = seconds * n / ((n + 1) * sum(gaps))
        gaps = [gaps[i] * scale for i in rng.permutation(n)]
        prompts = stratified(mix["prompt"], n, rng)
        outputs = stratified(mix["output"], n, rng)
        t, self.schedule = 0.0, []
        for g, p, o in zip(gaps, prompts, outputs):
            t += g
            self.schedule.append((None, t, rng.integers(0, vocab, p).tolist(), o))
        self.next = 0

    def prime(self) -> List[Spec]:
        return []

    def due(self, now: float, freed: List[int]) -> List[Spec]:
        """Every request whose arrival time has come."""
        out = []
        while self.next < len(self.schedule) and self.schedule[self.next][1] <= now:
            out.append(self.schedule[self.next])
            self.next += 1
        return out

    def next_due(self) -> float:
        return self.schedule[self.next][1] if self.next < len(self.schedule) else math.inf

    def lengths(self) -> Tuple[List[int], List[int]]:
        return [len(s[2]) for s in self.schedule], [s[3] for s in self.schedule]
