"""Completion mechanisms (paper §3.3.2, §5.2).

The paper studies four ways a communication runtime can hand completed
operations back to its client:

* :class:`LCRQueue` — an LCRQ-style FAA-based MPMC array queue (Morrison &
  Afek, PPoPP'13), LCI's default completion queue.  The real LCRQ relies on
  x86 ``FAA``/``CAS2``; here we implement the same *structure* (a linked list
  of fixed-size ring segments, enqueue/dequeue via fetch-and-add tickets)
  with CPython primitives.  CPython's GIL makes each bytecode atomic enough
  for ``itertools.count`` to serve as a true fetch-and-add, which preserves
  the algorithm's lock-freedom property at the Python level.
* :class:`MichaelScottQueue` — the classic CAS-based linked-list MPMC queue
  (the paper's ``queue_ms`` variant).
* :class:`LockQueue` — a deque behind a mutex (the ``queue_lock`` variant).
* :class:`Synchronizer` — a single-slot completion object, equivalent to an
  MPI request (the ``*_sync`` variants); :class:`SynchronizerPool` mirrors
  the MPI parcelport's shared request pools.

All queues implement ``push(item)`` / ``pop() -> item | None`` (non-blocking)
and report ``cost_model_name`` so the amtsim layer can attach calibrated
costs to the same structures.

Every class here also conforms to the unified
:class:`repro_torch.core.comm.interface.CompletionTarget` surface —
``signal(item)`` / ``reap() -> item | None`` — so a communication backend
hands completions to *any* of them through one call, and the parcelports
collect them the same way regardless of which mechanism a variant selects
(queue vs synchronizer vs pool is a calibrated-cost question, not an
interface question).
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, List, Optional, Tuple

from ..analysis.sanitizer import note_exercise

__all__ = [
    "CompletionQueue",
    "LCRQueue",
    "MichaelScottQueue",
    "LockQueue",
    "Synchronizer",
    "SynchronizerPool",
    "make_completion_queue",
]


class CompletionQueue:
    """Interface: multi-producer multi-consumer completion queue."""

    cost_model_name = "abstract"

    def push(self, item: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def pop(self) -> Optional[Any]:  # pragma: no cover - interface
        raise NotImplementedError

    def drain(self, max_n: int = 16) -> List[Any]:
        """Pop up to ``max_n`` items (stops at the first empty poll) — the
        parcelport's completion-dispatch batch."""
        out: List[Any] = []
        for _ in range(max_n):
            item = self.pop()
            if item is None:
                break
            out.append(item)
        return out

    # -- unified CompletionTarget surface (repro_torch.core.comm.interface) --
    def signal(self, item: Any) -> None:
        """Producer side of :class:`~repro_torch.core.comm.interface.
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
        # deliberately lock-free: the sanitizer counts traffic here but
        # does not lockset-check it (correctness is the FAA protocol)
        note_exercise("LCRQueue", id(self))
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
        note_exercise("LCRQueue", id(self))
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


class _MSNode:
    __slots__ = ("value", "next")

    def __init__(self, value: Any):
        self.value = value
        self.next: Optional["_MSNode"] = None


class MichaelScottQueue(CompletionQueue):
    """CAS-based linked-list MPMC queue (Michael & Scott, PODC'96).

    CPython has no CAS; we emulate the per-pointer CAS with a tiny lock per
    operation, which preserves the algorithm's *structure* (separate
    head/tail contention points) — the amtsim cost model is what carries the
    performance distinction vs LCRQ (paper Fig 7: MS is not enough to reach
    peak message rate).
    """

    cost_model_name = "ms"

    def __init__(self):
        dummy = _MSNode(None)
        self._head = dummy
        self._tail = dummy
        self._head_lock = threading.Lock()
        self._tail_lock = threading.Lock()

    def push(self, item: Any) -> None:
        node = _MSNode(item)
        with self._tail_lock:
            self._tail.next = node
            self._tail = node

    def pop(self) -> Optional[Any]:
        with self._head_lock:
            nxt = self._head.next
            if nxt is None:
                return None
            self._head = nxt
            value = nxt.value
            nxt.value = None
            return value

    def __len__(self) -> int:
        n = 0
        node = self._head.next
        while node is not None:
            n += 1
            node = node.next
        return n


class LockQueue(CompletionQueue):
    """Single coarse lock around a deque (the ``queue_lock`` variant)."""

    cost_model_name = "lock"

    def __init__(self):
        self._q: deque = deque()
        self._lock = threading.Lock()

    def push(self, item: Any) -> None:
        with self._lock:
            self._q.append(item)

    def pop(self) -> Optional[Any]:
        with self._lock:
            if not self._q:
                return None
            return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)


class Synchronizer:
    """Single-slot completion object ≈ an MPI request (paper §5.1).

    "We specialize the completion queue to the case where it will never
    contain more than one entry."
    """

    cost_model_name = "sync"
    __slots__ = ("_item", "_signaled")

    def __init__(self):
        self._item: Any = None
        self._signaled = False

    def signal(self, item: Any = True) -> None:
        self._item = item
        self._signaled = True  # single GIL-atomic store = the 4B signal write

    def test(self) -> Optional[Any]:
        """Non-blocking test; returns the item once, like MPI_Test."""
        if self._signaled:
            self._signaled = False
            item = self._item
            self._item = None
            return item
        return None

    def reap(self) -> Optional[Any]:
        """Unified CompletionTarget surface: reaping a synchronizer is one
        nonblocking test."""
        return self.test()

    @property
    def ready(self) -> bool:
        return self._signaled


class SynchronizerPool:
    """Shared pool of pending synchronizers, polled round-robin one per call
    under a try-lock — the exact structure of the MPI parcelport's request
    pools (paper §3.3.2: C++ deque + HPX try-lock, one ``MPI_Test`` per
    ``background_work``)."""

    cost_model_name = "sync_pool"

    def __init__(self):
        self._pool: deque = deque()
        self._lock = threading.Lock()

    def add(self, sync: Synchronizer, payload: Any = None) -> None:
        with self._lock:
            self._pool.append((sync, payload))

    def poll_one(self) -> Optional[Tuple[Any, Any]]:
        """Try-lock; test one request round-robin.  Returns ``(payload,
        completion_item)`` for a completed request, else None (nothing
        ready, nothing pending, or lock not acquired)."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            if not self._pool:
                return None
            sync, payload = self._pool.popleft()
            item = sync.test()
            if item is None:
                self._pool.append((sync, payload))  # re-queue, round robin
                return None
            return (payload, item)
        finally:
            self._lock.release()

    def reap(self) -> Optional[Tuple[Any, Any]]:
        """Unified CompletionTarget surface: one round-robin poll.  (The
        pool is a *poller over* synchronizers, so it has no ``signal`` —
        producers signal the member synchronizer directly.)"""
        return self.poll_one()

    def __len__(self) -> int:
        return len(self._pool)


def make_completion_queue(kind: str) -> CompletionQueue:
    """Factory used by parcelport variants (paper Fig 7)."""
    if kind == "lcrq":
        return LCRQueue()
    if kind == "ms":
        return MichaelScottQueue()
    if kind == "lock":
        return LockQueue()
    raise ValueError(f"unknown completion queue kind: {kind}")
