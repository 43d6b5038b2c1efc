"""The one thread-spawn surface for the port's worker threads.

Port's copy of :func:`spawn_worker` and :func:`join_workers` (and the
census behind them) from ``repro/core/comm/membership.py``; the member
lifecycle, progress pools and elastic controller there wait for the fleet
slice (ROADMAP.md, queue A).
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, List, Tuple

__all__ = ["spawn_worker", "join_workers", "live_worker_count"]

# every worker thread of the port is created and joined here, so the census
# below is exact and leak regressions have one place to look
_spawned: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()


def spawn_worker(
    target: Callable[..., None],
    *,
    name: str,
    args: Tuple[Any, ...] = (),
    daemon: bool = True,
) -> threading.Thread:
    """Start one worker thread."""
    t = threading.Thread(target=target, args=args, name=name, daemon=daemon)
    _spawned.add(t)
    t.start()
    return t


def join_workers(threads: List[threading.Thread], timeout: float = 5.0) -> None:
    """Join each thread with a bounded per-thread timeout (a wedged worker
    must not hang teardown — the daemon flag is the backstop)."""
    for t in threads:
        t.join(timeout=timeout)


def live_worker_count() -> int:
    """Census of live worker threads spawned through :func:`spawn_worker`."""
    return sum(1 for t in _spawned if t.is_alive())
