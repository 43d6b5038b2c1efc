"""Lengths drawn by stratified quantiles: every seed gets the same set of
lengths (the quantiles (i + offset) / n of the distribution), and the seed
only orders them.  So two seeds do the same work in another order."""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

GOLDEN = (math.sqrt(5) - 1) / 2


def quantile(dist: Dict, q: float) -> int:
    """The q-quantile of a length distribution of a mix file, as a whole number."""
    kind = dist["dist"]
    if kind == "loguniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        x = math.exp(lo + q * (hi - lo))
    elif kind == "uniform":
        x = dist["min"] + q * (dist["max"] - dist["min"])
    elif kind == "lognormal":  # given by its median, or by its mean: median = mean exp(-sigma^2 / 2)
        mu = math.log(dist["median"]) if "median" in dist else math.log(dist["mean"]) - dist["sigma"] ** 2 / 2
        x = math.exp(mu + dist["sigma"] * NormalDist().inv_cdf(q))
        x = min(max(x, dist["min"]), dist["max"])
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return int(round(x))


def stratified(dist: Dict, n: int, rng: np.random.Generator, offset: float = 0.5) -> List[int]:
    """n lengths at the quantiles (i + offset) / n, in an order drawn from rng."""
    xs = [quantile(dist, (i + offset) / n) for i in range(n)]
    return [xs[i] for i in rng.permutation(n)]

