"""Thread-local worker identities.

Port's copy of ``repro/core/worker.py``.  The executor assigns ids; unknown
threads (e.g. the main thread in tests) get one lazily from a global
counter.
"""
from __future__ import annotations

import itertools
import threading

__all__ = ["set_worker_id", "get_worker_id"]

_tls = threading.local()
_counter = itertools.count()


def set_worker_id(wid: int) -> None:
    _tls.wid = wid


def get_worker_id() -> int:
    wid = getattr(_tls, "wid", None)
    if wid is None:
        wid = next(_counter)
        _tls.wid = wid
    return wid
