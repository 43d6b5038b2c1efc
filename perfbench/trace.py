"""Profiler sessions of a traced run, and what is read from them.

A traced run profiles short sessions of a few engine or train steps, the
rest unprofiled.  Around every call of a kernel entry of
``repro_torch.kernels.ops`` (one module each under ``rooflines/``) the
benchmark opens a ``record_function`` range and records the call's
arguments, so every kernel launched inside the range is that entry's
device time, whatever kernel does the work behind it.

Sessions alternate between two kinds.  A ``device`` session traces the
card alone (CUDA activity): the busy and idle seconds come from it, since
tracing every host operator as well nearly doubles a decode step's host
time.  A ``ranges`` session traces host and card: each benchmark range
shows on the card as an annotation spanning the kernels launched inside
it, so an entry's device time is the kernels inside its span; the entries'
rooflines, the device operations and the idle gaps by host range come
from these.

A session counts only when it is complete: for every kernel of the port
(``port_kernels.json``), the kernel records in the session equal the change
in its ``launches`` counter.  The card's profiler loses records now and
then; a session that lost any is dropped and counted.
"""
from __future__ import annotations

import bisect
import importlib
import json
from typing import Any, Callable, Dict, List, Tuple

from perfbench.cells import HERE, load_module

HOST_RANGES = ("step", "prefill", "decode_step", "train_step")  # the benchmark's ranges that are not kernel entries


def port_kernels() -> Dict[str, Dict[str, Any]]:
    with open(HERE / "port_kernels.json") as f:
        return json.load(f)


def launch_counts(kernels: Dict[str, Dict[str, Any]]) -> Dict[str, int]:
    """The ``launches`` counter of each port kernel's wrapper."""
    out = {}
    for name, k in kernels.items():
        mod, attr = k["counter"].split(":")
        out[name] = getattr(importlib.import_module(mod), attr).launches
    return out


class Entries:
    """Ranges and argument records around the kernel entries of ``kernels/ops.py``."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops = ops
        self.modules = {p.stem: load_module("rooflines", p.stem) for p in sorted((HERE / "rooflines").glob("*.py"))
                        if p.stem != "__init__"}
        self.calls: List[Tuple[str, str, Dict[str, Any]]] = []  # (entry, phase, record) in call order
        self.phase = "other"
        self.recording = False
        self._orig: Dict[str, Callable] = {}

    def install(self) -> None:
        import torch

        for mod in self.modules.values():
            orig = getattr(self.ops, mod.ENTRY)
            self._orig[mod.ENTRY] = orig

            def wrapped(*args, _orig=orig, _mod=mod, **kwargs):
                if not self.recording:
                    return _orig(*args, **kwargs)
                rec = _mod.capture(args, kwargs)
                self.calls.append((_mod.ENTRY, self.phase, rec))
                with torch.profiler.record_function(f"perfbench::{_mod.ENTRY}"):
                    return _orig(*args, **kwargs)

            setattr(self.ops, mod.ENTRY, wrapped)

    def uninstall(self) -> None:
        for entry, orig in self._orig.items():
            setattr(self.ops, entry, orig)

    def module_of(self, entry: str):
        return next(m for m in self.modules.values() if m.ENTRY == entry)


class Sessions:
    """Short profiler sessions, started and stopped between steps."""

    def __init__(self, entries: Entries, every: int, length: int, ranges_on: str = "schedule"):
        self.entries, self.every, self.length, self.ranges_on = entries, every, length, ranges_on
        self.kernels = port_kernels()
        self.raw: List[Dict[str, Any]] = []
        self._prof = None
        self._steps = 0
        self._start_counts: Dict[str, int] = {}
        self._calls0 = 0
        self.kind = "device"
        self._last_end = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def ranges(self) -> bool:
        """Whether the running session records the benchmark's ranges."""
        return self._prof is not None and self.kind == "ranges"

    def before_step(self, work_steps: int, admitting: bool = False) -> None:
        """Start a session ``every // 2`` steps with work after the last one
        ended, ``device`` and ``ranges`` in turn; with ``ranges_on ==
        "admission"`` a ``ranges`` session waits for a step that admits a
        request, so that it traces a prefill."""
        if self._prof is not None or work_steps - self._last_end < self.every // 2:
            return
        kind = "ranges" if len(self.raw) % 2 else "device"
        if kind == "ranges" and self.ranges_on == "admission" and not admitting:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.kind = kind
        self._work_steps = work_steps
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.kind == "ranges" else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._start_counts = launch_counts(self.kernels)
        self._calls0 = len(self.entries.calls)
        self.entries.recording = self.kind == "ranges"
        self._steps = 0
        self._walls: List[float] = []
        self._tokens: List[int] = []

    def after_step(self, wall: float, prompt_tokens: int) -> None:
        """The step just run: its host wall and the prompt tokens it prefilled."""
        if self._prof is None:
            return
        self._walls.append(wall)
        self._tokens.append(prompt_tokens)
        self._steps += 1
        if self._steps >= self.length:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.entries.recording = False
        self._prof.__exit__(None, None, None)
        end = launch_counts(self.kernels)
        self._last_end = self._work_steps + self._steps
        self.raw.append({"prof": self._prof, "kind": self.kind, "launches": {k: end[k] - self._start_counts[k] for k in end},
                         "calls": self.entries.calls[self._calls0:], "walls": list(self._walls),
                         "tokens": list(self._tokens)})
        self._prof = None

    def summarize(self, peaks: Dict[str, float]) -> Dict[str, Any]:
        """Read every session: keep the complete ones.  Returns the dropped
        ones, the device's busy and window seconds (``device`` sessions; each
        such session's busy seconds beside its steps' prompt tokens in
        ``device_sessions``), each entry's bound and device seconds by
        phase, the device operations and the idle gaps by host range
        (``ranges`` sessions), and the mean host wall of a profiled step of
        each kind."""
        out = {"sessions": len(self.raw), "dropped": [], "busy_s": 0.0, "window_s": 0.0, "device_sessions": [],
               "entries": {}, "ops": {}, "gaps": {}, "step_walls": {}}
        for i, s in enumerate(self.raw):
            read = read_session(s["prof"], self.kernels)
            short = {k: (read["records"].get(k, 0), n) for k, n in s["launches"].items()
                     if read["records"].get(k, 0) != n * self.kernels[k]["records_per_launch"]}
            if short or not read["events"]:
                out["dropped"].append({"session": i, "kind": s["kind"], "records_vs_launches": short,
                                       "events": read["events"]})
                continue
            walls = out["step_walls"].setdefault(s["kind"], [])
            walls += s["walls"]
            if s["kind"] == "device":
                out["busy_s"] += read["busy_s"]
                out["window_s"] += sum(s["walls"])
                out["device_sessions"].append((read["busy_s"], s["tokens"]))
                continue
            for name, sec in read["ops"].items():
                out["ops"][name] = out["ops"].get(name, 0.0) + sec
            for name, sec in read["gaps"].items():
                out["gaps"][name] = out["gaps"].get(name, 0.0) + sec
            by_entry: Dict[str, List[float]] = {}
            for entry, t in read["ranges"]:
                by_entry.setdefault(entry, []).append(t)
            seen: Dict[str, int] = {}
            for entry, phase, rec in s["calls"]:
                j = seen.get(entry, 0)
                seen[entry] = j + 1
                times = by_entry.get(entry, [])
                if j >= len(times):
                    raise RuntimeError(f"session {i}: {entry} called {j + 1} times, {len(times)} ranges traced")
                flops, nbytes, dtype = self.entries.module_of(entry).work(rec)
                bound = max(flops / peaks[f"{dtype}_flops"], nbytes / peaks["hbm_bytes_per_s"])
                acc = out["entries"].setdefault(f"{entry}.{phase}", [0.0, 0.0, 0])
                acc[0] += bound
                acc[1] += times[j]
                acc[2] += 1
        out["complete"] = {k: sum(1 for s in self.raw if s["kind"] == k) - sum(1 for d in out["dropped"] if d["kind"] == k)
                           for k in ("device", "ranges")}
        out["step_walls"] = {k: sum(v) / len(v) for k, v in out["step_walls"].items() if v}
        self.raw = []
        return out


def read_session(prof, kernels: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """One session's device records: per port kernel the record count; the
    seconds in which any device operation ran (the union of their
    intervals); device seconds by operation name; each benchmark range's
    device seconds (every kernel inside its span on the card), in order; and the
    idle seconds between device operations inside each benchmark step,
    labelled by the innermost benchmark range the host was in."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev, spans, host = [], [], []
    for e in events:
        named = e.name.startswith("perfbench::")
        if e.device_type == DeviceType.CUDA:
            if named:  # the card's span of a benchmark range: its first kernel's start to its last's end
                entry = e.name.split("::", 1)[1]
                if entry not in HOST_RANGES:
                    spans.append((e.time_range.start, e.time_range.end, entry))
            elif not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end, e.name))
        elif named:
            host.append((e.time_range.start, e.time_range.end, e.name))
    records = {name: sum(1 for _, _, n in dev if any(sym in n for sym in k["device_names"])) for name, k in kernels.items()}
    dev.sort()
    busy, ops, cur_s, cur_e = 0.0, {}, None, None
    for s, e, n in dev:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps = idle_gaps(dev, host)
    starts = [s for s, _, _ in dev]
    ranges = []
    for s0, e0, entry in sorted(spans):
        i = bisect.bisect_left(starts, s0)
        t = 0.0
        while i < len(dev) and dev[i][0] < e0:
            t += min(dev[i][1], e0) - dev[i][0]
            i += 1
        ranges.append((entry, t / 1e6))
    return {"events": len(dev), "records": records, "busy_s": busy / 1e6, "ops": ops, "ranges": ranges, "gaps": gaps}


def idle_gaps(dev: List[Tuple[float, float, str]], host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds with no device operation inside each benchmark step, by the
    innermost benchmark range (on the host) at the gap's midpoint."""
    steps = [(s, e) for s, e, n in host if n in ("perfbench::step", "perfbench::train_step")]
    out: Dict[str, float] = {}
    for s0, e0 in steps:
        inside = [(max(s, s0), min(e, e0)) for s, e, _ in dev if e > s0 and s < e0]
        t = s0
        spans = []
        for s, e in sorted(inside):
            if s > t:
                spans.append((t, s))
            t = max(t, e)
        if e0 > t:
            spans.append((t, e0))
        for a, b in spans:
            mid = (a + b) / 2
            covering = [(e - s, n) for s, e, n in host if s <= mid <= e]
            label = min(covering)[1].split("::", 1)[1] if covering else "step"
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out
