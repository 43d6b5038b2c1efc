"""Independent streams derived from the run's ``--seed``."""
from __future__ import annotations

import numpy as np

STREAMS = ("weights", "traffic", "sample")


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream``, a pure function of (seed, stream)."""
    entropy = [seed % (1 << 64), STREAMS.index(stream)]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))
