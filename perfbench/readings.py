"""What the metric readers share: token times, and the counters of the
steps that ran outside the profiler's sessions."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

# indices into a step's counter snapshot (drivers/serve.py Probe.snapshot)
PREFILL_S, DECODE_S, STEPS, PREFILL_CALLS, PROMPT_TOKENS, DECODE_TOKENS, PREFILL_FLOPS, DECODE_FLOPS = range(8)


def in_window(run: Dict[str, Any], t: float) -> bool:
    return run["open"] <= t <= run["close"]


def token_times(run: Dict[str, Any]) -> List[List[float]]:
    return [r["times"] for r in run["requests"]]


def itl_gaps(run: Dict[str, Any]) -> List[float]:
    """Every gap between consecutive tokens of one request whose later token arrived in the window."""
    return [b - a for ts in token_times(run) for a, b in zip(ts, ts[1:]) if in_window(run, b)]


def ttft_waits(run: Dict[str, Any]) -> List[float]:
    """Open loop: every request due in the window, its first token's arrival
    minus its due time (one never served: its wait until the run stopped waiting)."""
    if run["kind"] != "serve" or not run["open_loop"]:
        return []
    due = [r for r in run["requests"] if run["open"] <= r["due"] < run["close"]]
    return [(r["times"][0] if r["times"] else run["t_end"]) - r["due"] for r in due]


def summaries(run: Dict[str, Any]) -> List[str]:
    """Lines for standard error: the TTFT and ITL distributions with their counts."""
    from perfbench.stats import percentile

    out = []
    waits = ttft_waits(run)
    if waits:
        p75, p90 = percentile(waits, 75), percentile(waits, 90)
        out.append(f"ttft over {len(waits)} requests due in the window: median {1e3 * percentile(waits, 50)} ms, "
                   f"p75 {1e3 * p75} ms, {sum(1 for w in waits if w > p75)} beyond it, "
                   f"p90 {1e3 * p90} ms, {sum(1 for w in waits if w > p90)} beyond it; "
                   f"every wait (ms) {sorted(round(1e3 * w, 3) for w in waits)}")
    gaps = itl_gaps(run) if run["kind"] == "serve" else []
    if gaps:
        qs = {q: round(1e3 * percentile(gaps, q), 3) for q in (50, 90, 95, 99)}
        out.append(f"itl over {len(gaps)} gaps: percentiles (ms) {qs}")
    return out


def unprofiled(run: Dict[str, Any]) -> Dict[str, float]:
    """Summed changes of every counter over the steps outside profiler
    sessions, with their host walls and count."""
    tot = {"wall": 0.0, "n": 0, "deltas": [0.0] * 8}
    for wall, traced, before, after in run.get("steps", []):
        if traced:
            continue
        tot["wall"] += wall
        tot["n"] += 1
        for i in range(8):
            tot["deltas"][i] += after[i] - before[i]
    return tot


def roofline(run: Dict[str, Any], key: str) -> Optional[float]:
    """Percent of the roofline: the entry's summed bound over its summed
    device time, over its calls in one phase in complete sessions."""
    tr = run.get("trace")
    acc = tr and tr["entries"].get(key)
    if not acc or acc[1] <= 0:
        return None
    return 100.0 * acc[0] / acc[1]


def _line(points: List[tuple]) -> Callable[[float], float]:
    """The least-squares line of wall against prompt tokens over ``(wall,
    tokens)`` points; their mean where the tokens do not vary."""
    n = len(points)
    mw, mt = sum(w for w, _ in points) / n, sum(t for _, t in points) / n
    var = sum((t - mt) ** 2 for _, t in points)
    slope = sum((t - mt) * (w - mw) for w, t in points) / var if var else 0.0
    return lambda t: mw + slope * (t - mt)


def idle_by_kind(run: Dict[str, Any]) -> Optional[Dict[str, Dict[str, float]]]:
    """The pieces of :func:`idle_share` by step kind (``admitting``: the step
    prefilled a prompt; ``plain``: every other step with work).  Of the
    window's unprofiled work steps: their count and summed wall.  Of the
    complete card-only sessions of the kind (a session that caught an
    admitting step is ``admitting``): their count and steps, busy seconds, and the
    walls their steps take unprofiled, each step by its own kind's line of
    wall against prompt tokens (the prompts a session catches may be longer
    or shorter than the window's)."""
    tr = run.get("trace")
    walls = run.get("work_walls")
    if not tr or not tr.get("device_sessions") or not walls:
        return None
    kind = lambda tokens: "admitting" if tokens else "plain"  # noqa: E731
    steps: Dict[str, List[tuple]] = {}
    for w, t in walls:
        steps.setdefault(kind(t), []).append((w, t))
    line = {k: _line(v) for k, v in steps.items()}
    out = {k: {"steps": len(v), "wall_s": sum(w for w, _ in v), "sessions": 0, "session_steps": 0, "busy_s": 0.0,
               "expected_s": 0.0} for k, v in steps.items()}
    for busy, tokens in tr["device_sessions"]:
        if any(kind(t) not in line for t in tokens):
            continue  # a step of a kind no unprofiled step has: nothing to hold it against
        k = out[kind(sum(tokens))]
        k["sessions"] += 1
        k["session_steps"] += len(tokens)
        k["busy_s"] += busy
        k["expected_s"] += sum(line[kind(t)](t) for t in tokens)
    return out


def idle_share(run: Dict[str, Any]) -> Optional[float]:
    """Percent of the window's unprofiled work-step wall in which no device
    operation ran.  Each kind's busy share is its card-only sessions' busy
    seconds over the walls their steps take unprofiled (a kind no session
    caught takes that of all sessions); the kinds are weighted by their
    unprofiled work steps' summed walls, so by their share of the steps
    times their mean wall.  The profiler slows the host, so the profiled
    steps' own walls would read the card idler; and the sessions catch
    admitting and plain steps in other shares than the window holds them,
    so one ratio over all steps would hold a prefill's busy time against
    decode steps' walls, and can read below 0."""
    kinds = idle_by_kind(run)
    if not kinds:
        return None
    caught = [k for k in kinds.values() if k["sessions"]]
    if not caught:
        return None
    pooled = sum(k["busy_s"] for k in caught) / sum(k["expected_s"] for k in caught)
    held = sum(k["wall_s"] * (k["busy_s"] / k["expected_s"] if k["sessions"] else pooled) for k in kinds.values())
    return 100.0 * (1.0 - held / sum(k["wall_s"] for k in kinds.values()))
