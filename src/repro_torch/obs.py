"""The port's tracer: spans at layer boundaries, request waits, and ranges
inside the model on the profiler's timeline.

One clock, ``time.perf_counter_ns`` (CLOCK_MONOTONIC on Linux), for every
time the serving stack keeps: the spans, ``DecodeCore``'s counters and the
``Request`` timestamps (:func:`now`, in seconds).

* :func:`span` times a layer boundary.  Its record,
  ``(name, start_ns, end_ns, parent, rid, profiled)``, goes into a ring of
  :data:`CAPACITY` records kept in the process: ``parent`` is the
  enclosing span's ``start_ns`` (None at the top; starts are distinct
  within a thread), ``rid`` the request id the spans of one request share,
  ``profiled`` whether a ``torch.profiler`` session was recording when the
  span opened.  While one records, the span is also a
  ``record_function("repro::" + name)`` range, so it shows on the card's
  timeline beside its kernels.
* :func:`interval` records a request's wait that is not a call (no parent).
* :func:`range` is for ranges inside the model: the ``repro::`` range
  alone, and only while a profiler records; otherwise one shared no-op.
* :func:`spans` copies the ring out with the count of records it dropped;
  :func:`clear` empties it.

The profiler stamps its host events on the Unix clock, not this one: the
offset between the two is read when a profiled span opens after an
unprofiled one (a session's first), and :func:`from_profiler_ns` converts.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "now", "now_ns", "span", "interval", "range", "spans", "clear", "from_profiler_ns"]

CAPACITY = 65_536  # records the ring keeps; older ones are dropped and counted

now_ns = time.perf_counter_ns  # the tracer's clock
now = time.perf_counter  # the same clock in seconds

Record = Tuple[str, int, int, Optional[int], Optional[int], bool]

_ring: "collections.deque[Record]" = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_appended = 0  # records appended since the last clear
_in_session = False  # whether the last span opened while a profiler recorded
_offset_ns = time.time_ns() - time.perf_counter_ns()  # Unix clock minus the tracer's
_NOOP = contextlib.nullcontext()


class _Open(threading.local):
    def __init__(self):
        self.span: Optional[_Span] = None  # the innermost open span of this thread


_open = _Open()


def _append(rec: Record) -> None:
    global _appended
    with _lock:
        _ring.append(rec)
        _appended += 1


class _Span:
    __slots__ = ("name", "rid", "start_ns", "end_ns", "profiled", "_outer", "_range")

    def __init__(self, name: str, rid: Optional[int]):
        self.name, self.rid = name, rid
        self.start_ns = self.end_ns = 0
        self._range = None

    def __enter__(self) -> "_Span":
        global _in_session, _offset_ns
        self._outer = _open.span
        _open.span = self
        self.profiled = _profiler._is_profiler_enabled  # a torch.profiler session records
        if self.profiled:
            if not _in_session:
                _offset_ns = time.time_ns() - time.perf_counter_ns()
            self._range = torch.profiler.record_function("repro::" + self.name)
            self._range.__enter__()
        _in_session = self.profiled
        self.start_ns = time.perf_counter_ns()
        return self

    def then(self, name: str) -> None:
        """End this span and open the next one, ``name``, at the same clock
        read: the two share their boundary (read after the next range
        opens, as a span's start is)."""
        if self.profiled:
            self._range.__exit__(None, None, None)
            self._range = torch.profiler.record_function("repro::" + name)
            self._range.__enter__()
        t = time.perf_counter_ns()
        self._record(t)
        self.name, self.start_ns = name, t

    def _record(self, t: int) -> None:
        self.end_ns = t
        outer = self._outer
        _append((self.name, self.start_ns, t, None if outer is None else outer.start_ns, self.rid, self.profiled))

    def __exit__(self, *exc) -> None:
        self._record(time.perf_counter_ns())
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _open.span = self._outer


def span(name: str, rid: Optional[int] = None) -> _Span:
    """A context manager that records ``name`` from entry to exit; the
    object it gives has ``start_ns``, ``end_ns`` (after exit) and
    :meth:`_Span.then`."""
    return _Span(name, rid)


def interval(name: str, rid: Optional[int], start_ns: int, end_ns: int) -> None:
    """Record a request's wait from ``start_ns`` to ``end_ns`` (the tracer's
    clock), with no parent."""
    _append((name, start_ns, end_ns, None, rid, _profiler._is_profiler_enabled))


def range(name: str):  # noqa: A001 -- the tracer's name for a model range
    """``record_function("repro::" + name)`` while a profiler records, else
    a shared no-op (no clock read)."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return torch.profiler.record_function("repro::" + name)


def spans() -> Tuple[List[Record], int]:
    """A copy of the ring, oldest first, and the records it dropped."""
    with _lock:
        return list(_ring), _appended - len(_ring)


def clear() -> None:
    global _appended
    with _lock:
        _ring.clear()
        _appended = 0


def from_profiler_ns(t: int) -> int:
    """A profiler host time (Unix clock, ns: the session's
    ``kineto_results.trace_start_ns()`` plus an event's start in µs) on
    the tracer's clock."""
    return t - _offset_ns
