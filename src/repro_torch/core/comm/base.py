"""The sender-side throttle the serving channel parks refused posts in.

Port's copy of :class:`InjectionThrottle` from ``repro/core/comm/base.py``
(verbatim); the parcelport machinery around it is not part of the port.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable

__all__ = ["InjectionThrottle"]


class InjectionThrottle:
    """Park-and-retry machinery for backpressured comm-interface posts
    (paper §3.3.4) — the sender-side throttle, shared verbatim by every
    parcelport AND the serving stack's request/response channel: a post the
    backend refused (falsy :class:`~repro.core.comm.interface.PostStatus`)
    parks as a thunk and is retried under a bounded per-call budget,
    stopping at the first refusal (the backend has not freed resources, so
    the rest would fail too — throttle instead of hammering)."""

    def __init__(self, retry_budget: int = 8):
        self.retry_budget = retry_budget
        self.parks = 0  # EAGAIN-parked posts (backpressure observability)
        self._q: deque = deque()
        # One lock serializes posting AND draining end to end: the FIFO
        # non-overtaking guarantee below must hold even when one thread
        # drains retries while another posts fresh work (e.g. the serve
        # loop flushing a token batch during an executor worker's pump).
        self._lock = threading.Lock()

    def post_or_park(self, thunk: Callable[[], Any]) -> bool:
        """Run a comm-interface post; if it EAGAINs, park it for retry.

        Non-overtaking (FIFO): while parked posts exist, a fresh post
        parks BEHIND them instead of attempting — otherwise a post issued
        after the backend freed resources would bypass an earlier parked
        one, reordering traffic the client issued in order (the serving
        channel's token batches rely on this)."""
        with self._lock:
            if self._q:
                self.parks += 1
                self._q.append(thunk)
                return False
            if thunk():
                return True
            self.parks += 1
            self._q.append(thunk)
            return False

    def drain(self) -> bool:
        """Retry up to ``retry_budget`` parked posts, oldest first.  The
        head stays queued until its retry succeeds, so a concurrent
        ``post_or_park`` always observes it and parks behind."""
        moved = False
        with self._lock:
            for _ in range(self.retry_budget):
                if not self._q:
                    break
                if self._q[0]():
                    self._q.popleft()
                    moved = True
                else:
                    break
        return moved

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
