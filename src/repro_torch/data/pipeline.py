"""Sharded synthetic data pipeline with executor-driven prefetch.

Port's copy of ``repro/data/pipeline.py``, unchanged but for its imports:
batches are numpy arrays, the same bytes as the reference's for the same
(seed, index); the trainer moves them to its device.

The pipeline is an AMT consumer of the parcelport runtime (paper §2.2.2
applied to the framework): batch *construction* runs as tasks on the
:class:`~repro_torch.core.executor.AMTExecutor` worker threads, finished batches
flow back through a completion queue (LCRQ), and the trainer pops them —
never blocking on data unless the queue is empty (over-decomposition =
prefetch depth).

Data is synthetic but *deterministic and resumable*: batch ``i`` is a pure
function of (seed, i), so restart-from-checkpoint reproduces the exact
stream without data-state checkpoints.  Host-level straggler mitigation
comes from the executor's work stealing.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig
from ..core.comm.completion import LCRQueue
from ..core.executor import AMTExecutor

__all__ = ["SyntheticLM", "PrefetchingLoader"]


@dataclass
class SyntheticLM:
    """Deterministic synthetic LM stream: Zipf-ish tokens + next-token labels."""

    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0

    def make_batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ index)
        v = self.cfg.vocab_size
        # zipfian-ish marginal over the vocab, cheap to sample
        u = rng.random((self.batch, self.seq + 1))
        toks = np.minimum((u ** 3.0 * v).astype(np.int32), v - 1)
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
        }
        if self.cfg.frontend == "vision":
            out["prefix"] = rng.standard_normal(
                (self.batch, self.cfg.n_prefix_tokens, self.cfg.d_model), dtype=np.float32
            )
        if self.cfg.is_encdec:
            out["frames"] = rng.standard_normal(
                (self.batch, self.cfg.encoder_seq, self.cfg.d_model), dtype=np.float32
            )
        return out


class PrefetchingLoader:
    """Prefetch ``depth`` batches ahead through the AMT executor."""

    def __init__(
        self,
        source: SyntheticLM,
        executor: AMTExecutor,
        depth: int = 4,
        start_index: int = 0,
    ):
        self.source = source
        self.executor = executor
        self.depth = depth
        self.ready = LCRQueue()
        self._next_submit = start_index
        self._next_emit = start_index
        self._lock = threading.Lock()
        self._stash: Dict[int, Any] = {}
        for _ in range(depth):
            self._submit_one()

    def _submit_one(self) -> None:
        idx = self._next_submit
        self._next_submit += 1
        self.executor.submit(lambda i=idx: self.ready.push((i, self.source.make_batch(i))))

    def next(self, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        """Pop the next in-order batch; pumps executor progress while waiting."""
        import time

        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._next_emit in self._stash:
                    batch = self._stash.pop(self._next_emit)
                    self._next_emit += 1
                    self._submit_one()
                    return batch
            item = self.ready.pop()
            if item is not None:
                with self._lock:
                    self._stash[item[0]] = item[1]
                continue
            self.executor.progress()
            if time.monotonic() > deadline:
                raise TimeoutError("data pipeline stalled")
            time.sleep(1e-4)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
