"""Eraser-style lockset race sanitizer.

Port of ``repro/analysis/sanitizer.py`` (the standard library only, so
the port keeps its own copy).  Enabled by ``REPRO_SANITIZE=1`` (or
programmatically via :func:`enable`).  When disabled — the default —
:func:`make_lock` returns a plain ``threading.Lock`` and every ``note_*``
hook returns immediately, so the instrumented hot paths pay one
truthiness check.

When enabled:

* :func:`make_lock` returns a :class:`SanLock` that records, per thread,
  the set of tracked locks currently held.
* :func:`note_access` runs the classic Eraser state machine per shared
  location (``virgin → exclusive → shared``): the location's *candidate
  lockset* is intersected with the locks held at each access once a
  second thread shows up; an empty candidate set on a shared **write** is
  a race report (every shared structure has ONE lock that all its
  writers hold).
* :func:`note_exercise` counts operations on deliberately lock-free
  structures without lockset checking — they are *exercised*, proving
  the sanitizer actually drove them.

Reports carry the structure name, the racing threads, and the access
site (``file:line`` of the caller) so a report is actionable without a
debugger.  :func:`session_report` is the one-call summary a test asserts
on.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

__all__ = [
    "enabled",
    "enable",
    "make_lock",
    "SanLock",
    "note_access",
    "note_exercise",
    "race_reports",
    "exercised_structures",
    "reset",
    "session_report",
]

_ENABLED = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")

_tls = threading.local()


def _held() -> Set["SanLock"]:
    try:
        return _tls.held
    except AttributeError:
        _tls.held = set()
        return _tls.held


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Flip the sanitizer (tests).  Only structures *constructed after*
    enabling get tracked locks — enable before building the world."""
    global _ENABLED
    _ENABLED = on


class SanLock:
    """A ``threading.Lock`` that maintains the per-thread held set.

    Duck-types the small surface the repo uses: ``acquire`` / ``release``
    / context manager / ``locked``.  Non-reentrant, like the primitive it
    wraps."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str):
        self._lock = threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held().add(self)
        return ok

    def release(self) -> None:
        _held().discard(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SanLock({self.name!r})"


def make_lock(name: str):
    """The lock constructor instrumented modules use: a plain
    ``threading.Lock`` normally, a tracked :class:`SanLock` under
    ``REPRO_SANITIZE=1``.  The static passes treat both as lock
    constructors."""
    if _ENABLED:
        return SanLock(name)
    return threading.Lock()


# ------------------------------------------------------------- state machine
_VIRGIN, _EXCLUSIVE, _SHARED = 0, 1, 2


class _Shadow:
    __slots__ = ("state", "owner", "lockset", "threads", "accesses", "reported")

    def __init__(self) -> None:
        self.state = _VIRGIN
        self.owner: Optional[int] = None
        self.lockset: Optional[FrozenSet[str]] = None
        self.threads: Set[int] = set()
        self.accesses = 0
        self.reported = False


_reg_lock = threading.Lock()
_shadows: Dict[Tuple[str, int], _Shadow] = {}
_exercised: Dict[str, int] = {}
_reports: List[Dict[str, Any]] = []


def _caller_site(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
        return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    except Exception:  # pragma: no cover - platform without _getframe
        return "<unknown>"


def note_access(struct: str, inst: int = 0, write: bool = True) -> None:
    """Record one access to shared location ``(struct, inst)``.

    ``struct`` is the structure name (aggregation key for reports, e.g.
    ``"Membership._members"``); ``inst`` distinguishes instances (pass
    ``id(self)``)."""
    if not _ENABLED:
        return
    tid = threading.get_ident()
    held = frozenset(l.name for l in _held())
    with _reg_lock:
        sh = _shadows.setdefault((struct, inst), _Shadow())
        sh.accesses += 1
        sh.threads.add(tid)
        if sh.state == _VIRGIN:
            sh.state = _EXCLUSIVE
            sh.owner = tid
            sh.lockset = held
            return
        if sh.state == _EXCLUSIVE and sh.owner == tid:
            # still single-threaded: keep the most recent candidate set
            sh.lockset = held
            return
        sh.state = _SHARED
        sh.lockset = (sh.lockset or frozenset()) & held
        if not sh.lockset and write and not sh.reported:
            sh.reported = True
            _reports.append(
                {
                    "struct": struct,
                    "instance": inst,
                    "threads": sorted(sh.threads),
                    "site": _caller_site(),
                    "message": (
                        f"lockset race: {struct} written by {len(sh.threads)} threads "
                        f"with no common lock (at {_caller_site()})"
                    ),
                }
            )


def note_exercise(struct: str, inst: int = 0) -> None:
    """Count one operation on a deliberately lock-free structure."""
    if not _ENABLED:
        return
    with _reg_lock:
        _exercised[struct] = _exercised.get(struct, 0) + 1


def race_reports() -> List[Dict[str, Any]]:
    with _reg_lock:
        return list(_reports)


def exercised_structures() -> Dict[str, int]:
    """Structures the sanitizer actually saw traffic on: every lockset-
    checked shadow location (by structure name) plus the lock-free
    exercise counters."""
    with _reg_lock:
        out = dict(_exercised)
        for (struct, _inst), sh in _shadows.items():
            out[struct] = out.get(struct, 0) + sh.accesses
        return out


def reset() -> None:
    with _reg_lock:
        _shadows.clear()
        _exercised.clear()
        _reports.clear()


def session_report() -> Dict[str, Any]:
    """The one-call summary the sanitizer test leg asserts on."""
    return {
        "enabled": _ENABLED,
        "races": race_reports(),
        "exercised": exercised_structures(),
    }
