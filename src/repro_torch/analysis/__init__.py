"""repro_torch.analysis — the concurrency static-analysis subsystem.

Two halves, one discipline:

* **Static passes** (:mod:`.facts`, :mod:`.callgraph`, :mod:`.passes`,
  :mod:`.gates`, :mod:`.registry`) — one cached AST walk per module of
  ``src/repro_torch`` feeds a pass registry: a lock-order/deadlock
  analyzer, the blocking-under-lock lint (the paper's §5.3 "blocking
  under a lock is catastrophic" result as a machine-checked rule), the
  unchecked-``PostStatus`` lint (an ignored EAGAIN is a silently dropped
  parcel), a capability-dominance dataflow pass, a thread-ownership
  pass, and eight API gates.  :mod:`.cli` runs them against the reviewed
  baseline ``tools/torch_analysis_baseline.json``
  (``python tools/torch_analyze.py --strict``).
* **Runtime sanitizer** (:mod:`.sanitizer`) — an Eraser-style lockset
  checker (``REPRO_SANITIZE=1``) that dynamically witnesses what the
  static passes claim: shared structures (completion rings, send rings,
  slab state bytes, the membership table) carry a candidate lockset that
  is intersected on every cross-thread access; an empty lockset on a
  shared mutation is a race report.

This module keeps imports lazy so the hot path — core modules importing
:func:`sanitizer.make_lock` — never pays for the static machinery.
"""
from __future__ import annotations

__all__ = [
    "facts",
    "callgraph",
    "registry",
    "passes",
    "gates",
    "sanitizer",
    "cli",
]


def __getattr__(name: str):
    if name in __all__:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
