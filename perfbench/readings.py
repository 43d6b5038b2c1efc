"""What the metric readers share: token times, and the counters of the
steps that ran outside the profiler's sessions."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

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


def idle_share(run: Dict[str, Any]) -> Optional[float]:
    """Percent of a step's host wall in which no device operation ran: the
    device-busy seconds a step of the complete card-only sessions over the
    mean wall of the unprofiled steps with work.  The profiler slows the
    host, so the profiled steps' own walls would read the card idler."""
    tr = run.get("trace")
    walls = run.get("work_walls")
    if not tr or not tr["device_steps"] or not walls:
        return None
    busy = tr["busy_s"] / tr["device_steps"]
    return 100.0 * (1.0 - busy / (sum(walls) / len(walls)))
