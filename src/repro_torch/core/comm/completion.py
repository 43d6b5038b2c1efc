"""Completion queues for the serving channel (paper §3.3.2, §5.2).

Port's copy of :class:`CompletionQueue` and :class:`LCRQueue` from
``repro/core/completion.py``, without the lockset sanitizer's hooks: an
LCRQ-style FAA-based MPMC array queue (Morrison & Afek, PPoPP'13), a
linked list of fixed-size ring segments with enqueue/dequeue via
fetch-and-add tickets.  CPython's GIL makes ``next(itertools.count())`` a
true fetch-and-add and ``dict.setdefault`` a CAS, so the structure stays
lock-free at the Python level.  Both classes conform to the
``signal(item)`` / ``reap()`` completion-target surface of
:mod:`.interface`.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Optional

__all__ = ["CompletionQueue", "LCRQueue"]


class CompletionQueue:
    """Interface: multi-producer multi-consumer completion queue."""

    cost_model_name = "abstract"

    def push(self, item: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def pop(self) -> Optional[Any]:  # pragma: no cover - interface
        raise NotImplementedError

    # -- unified CompletionTarget surface (repro.core.comm.interface) -------
    def signal(self, item: Any) -> None:
        """Producer side of :class:`~repro.core.comm.interface.
        CompletionTarget`: for a queue, signalling is enqueuing."""
        self.push(item)

    def reap(self) -> Optional[Any]:
        """Consumer side: one completed item, or ``None``."""
        return self.pop()

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError


_TAKEN = object()  # tombstone: a dequeuer claimed this slot before any enqueuer


class _CRQSegment:
    """One fixed-size ring of an LCRQ: slots claimed by FAA tickets.

    ``slots`` is a dict so we can use ``dict.setdefault`` — a single C-level
    operation, hence atomic under the GIL — as the slot-resolution CAS:
    every ticket resolves exactly once, either enqueuer-first (item stored;
    the dequeuer with that ticket returns it) or dequeuer-first (tombstone
    stored; the enqueuer observes it and retries with a fresh ticket).  This
    is the same safe/unsafe-slot protocol as the real CRQ.
    """

    __slots__ = ("slots", "head", "tail", "next", "size")

    def __init__(self, size: int):
        self.size = size
        self.slots: dict = {}
        self.head = itertools.count()  # dequeue ticket source (FAA)
        self.tail = itertools.count()  # enqueue ticket source (FAA)
        self.next: Optional["_CRQSegment"] = None


class LCRQueue(CompletionQueue):
    """FAA-based MPMC queue structured like LCRQ (Morrison & Afek).

    Enqueue/dequeue each take a ticket via fetch-and-add; when a segment's
    tickets are exhausted a new segment is linked (the "CRQ of rings"
    construction; the link lock is amortized over ``segment_size`` ops,
    standing in for the CAS on the ring list).  Lossless and duplicate-free
    under arbitrary thread interleavings — see :class:`_CRQSegment`.
    """

    cost_model_name = "lcrq"
    _BURN_BUDGET = 4  # empty-slot tombstones one pop() may place

    def __init__(self, segment_size: int = 1024):
        self._segment_size = segment_size
        seg = _CRQSegment(segment_size)
        self._head_seg = seg
        self._tail_seg = seg
        self._link_lock = threading.Lock()  # only for linking new segments
        self._pushed = 0  # stats only (racy increments are acceptable)
        self._popped = 0

    def push(self, item: Any) -> None:
        if item is None:
            raise ValueError("None is reserved for 'queue empty'")
        # deliberately lock-free: correctness is the FAA protocol
        while True:
            seg = self._tail_seg
            t = next(seg.tail)
            if t < seg.size:
                if seg.slots.setdefault(t, item) is item:
                    self._pushed += 1
                    return
                continue  # slot tombstoned by an overtaking dequeuer: retry
            # Segment exhausted: link a fresh one.
            with self._link_lock:
                if self._tail_seg is seg:
                    new_seg = _CRQSegment(self._segment_size)
                    seg.next = new_seg
                    self._tail_seg = new_seg

    def pop(self) -> Optional[Any]:
        burns = 0
        while True:
            seg = self._head_seg
            h = next(seg.head)
            if h < seg.size:
                item = seg.slots.get(h)
                if item is None:
                    # Our ticket beat any enqueuer.  Spin briefly (an
                    # in-flight push may land), then tombstone and give up
                    # after a small budget — the caller polls in a loop.
                    for _ in range(32):
                        item = seg.slots.get(h)
                        if item is not None:
                            break
                    if item is None:
                        item = seg.slots.setdefault(h, _TAKEN)
                        if item is _TAKEN:
                            burns += 1
                            if burns >= self._BURN_BUDGET:
                                return None
                            continue
                if item is _TAKEN:
                    continue  # tombstone from another dequeuer: skip
                self._popped += 1
                return item
            nxt = seg.next
            if nxt is None:
                return None
            with self._link_lock:
                if self._head_seg is seg and seg.next is not None:
                    self._head_seg = seg.next

    def __len__(self) -> int:
        return max(0, self._pushed - self._popped)
