"""The program's own spans (``repro_torch.obs``), read after the run: what
the metric readers built on them share.

A record is ``(name, start_ns, end_ns, parent, rid, profiled)`` on
``time.perf_counter_ns``, the clock of the run's ``open`` and ``close``
(``parent``: the enclosing span's start).  A reader keeps the records that
no profiler session recorded (``profiled`` false), since the profiler slows
the host.  Spans of a call are taken when they started in the window;
a request's intervals (``request.queue``, ``request.hold``) by its rid,
over the requests due in the window, as ``ttft_p75_ms`` takes them.  A
program without the tracer, or a ring that dropped records that may lie in
the window, gives None: the metric is left out.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from perfbench.stats import percentile

NAME, START, END, PARENT, RID, PROFILED = range(6)
WORK = ("prefill", "decode.dispatch")  # the spans of a step that prefilled or decoded


def program_spans() -> Optional[tuple]:
    """``repro_torch.obs.spans()``: the records and the count dropped;
    None where the program has no tracer."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.spans()


def records(run: Dict[str, Any]) -> Optional[List[tuple]]:
    """Every record the program kept, or None when it keeps none or its
    ring dropped records that may have started in the window (the oldest
    kept one ended after the window opened)."""
    got = program_spans()
    if got is None:
        return None
    recs, dropped = got
    if dropped and (not recs or recs[0][END] >= run["open"] * 1e9):
        return None
    return recs


def window_spans(run: Dict[str, Any], recs: List[tuple], name: str) -> List[tuple]:
    """The unprofiled spans ``name`` that started in the window."""
    lo, hi = run["open"] * 1e9, run["close"] * 1e9
    return [r for r in recs if r[NAME] == name and not r[PROFILED] and lo <= r[START] <= hi]


def mean_ms(run: Dict[str, Any], name: str) -> Optional[float]:
    """Mean duration of the spans ``name`` in ms."""
    recs = records(run)
    spans = window_spans(run, recs, name) if recs is not None else []
    return 1e-6 * sum(r[END] - r[START] for r in spans) / len(spans) if spans else None


def per_work_step_ms(run: Dict[str, Any], name: str) -> Optional[float]:
    """The spans ``name`` inside the ``engine.step`` spans that prefilled or
    decoded, summed a step, in ms."""
    recs = records(run)
    if recs is None:
        return None
    steps = {r[START]: r for r in window_spans(run, recs, "engine.step")}
    by_start = {r[START]: r for r in recs if r[PARENT] is not None or r[NAME] == "engine.step"}

    def step_of(r: tuple) -> Optional[int]:
        p = r[PARENT]
        while p is not None and p not in steps:
            p = by_start[p][PARENT] if p in by_start else None
        return p

    worked = {step_of(r) for r in recs if r[NAME] in WORK} - {None}
    if not worked:
        return None
    total = sum(r[END] - r[START] for r in recs if r[NAME] == name and step_of(r) in worked)
    return 1e-6 * total / len(worked)


def request_p75_ms(run: Dict[str, Any], name: str) -> Optional[float]:
    """75th percentile of the intervals ``name`` of the requests due in the
    window of an open loop (joined on rid), in ms."""
    if run["kind"] != "serve" or not run["open_loop"]:
        return None
    recs = records(run)
    if recs is None:
        return None
    due = {r["req"].rid for r in run["requests"] if run["open"] <= r["due"] < run["close"]}
    waits = [r[END] - r[START] for r in recs if r[NAME] == name and not r[PROFILED] and r[RID] in due]
    return 1e-6 * percentile(waits, 75) if waits else None
