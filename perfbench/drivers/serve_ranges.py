"""Serving as ``drivers/serve.py`` runs it, with the port's own model ranges
read from a traced run's ``ranges`` sessions as well.

The port opens a ``record_function("repro::<name>")`` range around each
part of a model call while a profiler records (``repro_torch.obs.range``).
On the card a range whose kernels all lie in ranges nested inside it, as
``perfbench::prefill``'s do, has no annotation at all; so the device time
of a range is read on the host side instead: the profiler gives each host
range the device time of every kernel launched inside it, nested ranges
included (``FunctionEvent.device_time_total``).  Before the sessions are summarised,
each complete ``ranges`` session gives the device seconds inside its
``perfbench::prefill`` ranges, and inside every ``repro::`` range that lies
in one, by name, beside the prompt tokens its steps prefilled
(``run["trace"]["repro_ranges"]``: ``{"prefill": s, "tokens": n,
"ranges": {name: s}}``, summed over the sessions).  A program without the
ranges gives no names.

The driver reaches into ``drivers/serve.py`` by replacing
``trace.Sessions`` for the length of the run, so a traced run whose trace
lacks ``repro_ranges`` is an error, not a metric read as None.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, Tuple

from perfbench import trace
from perfbench.drivers import serve

PHASE = "perfbench::prefill"


def prefill_ranges(prof) -> Tuple[float, Dict[str, float]]:
    """One session's device seconds inside its prefill ranges, and inside
    each ``repro::`` range that lies in one, by the range's name: the
    device time of the kernels launched inside each host range."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and (e.name == PHASE or e.name.startswith("repro::"))]
    phases = [(e.time_range.start, e.time_range.end) for e in host if e.name == PHASE]
    prefill = sum(e.device_time_total for e in host if e.name == PHASE) / 1e6
    names: Dict[str, float] = {}
    for e in host:
        s, t = e.time_range.start, e.time_range.end
        if e.name != PHASE and any(p0 <= s and t <= p1 for p0, p1 in phases):
            key = e.name.split("::", 1)[1]
            names[key] = names.get(key, 0.0) + e.device_time_total / 1e6
    return prefill, names


class RangeSessions(trace.Sessions):
    """``trace.Sessions`` that also reads the ``repro::`` ranges of its
    complete ``ranges`` sessions (:func:`prefill_ranges`)."""

    def summarize(self, peaks: Dict[str, float]) -> Dict[str, Any]:
        raw = list(self.raw)
        out = super().summarize(peaks)
        dropped = {d["session"] for d in out["dropped"]}
        total = {"prefill": 0.0, "tokens": 0, "ranges": {}}
        for i, s in enumerate(raw):
            if s["kind"] != "ranges" or i in dropped:
                continue
            prefill, names = prefill_ranges(s["prof"])
            total["prefill"] += prefill
            total["tokens"] += sum(s["tokens"])
            for k, v in names.items():
                total["ranges"][k] = total["ranges"].get(k, 0.0) + v
        out["repro_ranges"] = total
        if total["prefill"] > 0 and "shared_block" in total["ranges"]:
            print(f"shared block share of prefill card time: {100.0 * total['ranges']['shared_block'] / total['prefill']}%",
                  file=sys.stderr)
        return out


def run(ctx) -> Dict[str, Any]:
    saved = trace.Sessions
    trace.Sessions = RangeSessions  # drivers/serve.py looks it up when the run starts
    try:
        run = serve.run(ctx)
    finally:
        trace.Sessions = saved
    if ctx.trace and "repro_ranges" not in (run["trace"] or {}):
        raise RuntimeError("drivers/serve.py no longer takes trace.Sessions when its run starts: "
                           "the repro:: ranges were not read")
    return run
