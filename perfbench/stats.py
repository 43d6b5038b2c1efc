"""Percentiles over all samples and rates over all the work of a window."""
from __future__ import annotations

import math
from typing import Iterable


def percentile(values: Iterable[float], q: float) -> float:
    """The q-th percentile (0..100) of every value, interpolated linearly
    between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return work / seconds

