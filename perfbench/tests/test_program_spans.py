"""The readers of the program's own spans (``perfbench/spans.py`` and the
metrics built on it): on synthetic span lists, the window and the
profiler filters, the rid join against the run's requests, and None where
the ring dropped records of the window or the program keeps none; then a
traced run of each cell at the smoke size on the CPU, which reports every
new metric."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.tests.helpers import smoke_cfg  # noqa: F401  (puts src/ on the path)

from perfbench import spans
from perfbench.cells import HERE, benchmark_entries, load_module, read_json
from perfbench.harness import count_requests, make_ctx
from perfbench.tests.test_run_cpu import small_cell

NEW = ("decode_dispatch_ms", "decode_sync_ms", "handoff_ms", "queue_wait_p75_ms", "first_token_hold_p75_ms")
MS = 1_000_000  # ns


def _run(open_loop=True, requests=()):
    return {"kind": "serve", "open": 10.0, "close": 20.0, "open_loop": open_loop,
            "requests": [{"req": SimpleNamespace(rid=rid), "due": due} for rid, due in requests]}


def _use(monkeypatch, recs, dropped=0):
    monkeypatch.setattr(spans, "program_spans", lambda: (list(recs), dropped))


def _step(t, work=True, profiled=False, handoffs=(1, 2)):
    """An engine step at ``t`` s: two hand-offs of ``handoffs`` ms, an admit
    and a prefill under it, and a decode split into dispatch and sync."""
    s = int(t * 1e9)
    out = [("engine.step", s, s + 100 * MS, None, None, profiled),
           ("handoff", s + 1, s + 1 + handoffs[0] * MS, s, None, profiled),
           ("admit", s + 2 * MS, s + 40 * MS, s, None, profiled)]
    if work:
        out += [("prefill", s + 3 * MS, s + 30 * MS, s + 2 * MS, 7, profiled),
                ("decode.dispatch", s + 41 * MS, s + 90 * MS, s, None, profiled),
                ("decode.sync", s + 90 * MS, s + 95 * MS, s, None, profiled)]
    out.append(("handoff", s + 96 * MS, s + 96 * MS + handoffs[1] * MS, s, None, profiled))
    return out


def test_spans_outside_the_window_or_profiled_are_left_out(monkeypatch):
    recs = _step(5.0) + _step(12.0) + _step(13.0, profiled=True) + _step(21.0)
    recs += [("decode.dispatch", 14 * 10**9, 14 * 10**9 + 29 * MS, None, None, False)]
    _use(monkeypatch, recs)
    run = _run()
    assert spans.mean_ms(run, "decode.dispatch") == pytest.approx((49 + 29) / 2)
    assert spans.mean_ms(run, "decode.sync") == pytest.approx(5.0)
    assert spans.mean_ms(run, "flush") is None


def test_handoff_sums_a_step_that_worked(monkeypatch):
    recs = (_step(11.0, handoffs=(1, 2)) + _step(12.0, handoffs=(3, 4)) + _step(13.0, work=False, handoffs=(50, 50))
            + _step(14.0, profiled=True, handoffs=(60, 60)) + _step(25.0, handoffs=(70, 70)))
    _use(monkeypatch, recs)
    assert spans.per_work_step_ms(_run(), "handoff") == pytest.approx((1 + 2 + 3 + 4) / 2)
    assert load_module("metrics", "handoff_ms").read(_run(), None) == pytest.approx(5.0)
    _use(monkeypatch, _step(13.0, work=False))
    assert spans.per_work_step_ms(_run(), "handoff") is None


def test_request_intervals_join_the_requests_due_in_the_window(monkeypatch):
    recs = [("request.queue", 11 * 10**9, 11 * 10**9 + w * MS, None, rid, prof)
            for rid, w, prof in [(1, 10, False), (2, 20, False), (3, 30, False), (4, 40, False), (5, 1000, True),
                                 (6, 2000, False)]]
    recs += [("request.hold", 12 * 10**9, 12 * 10**9 + 5 * MS, None, 1, False)]
    _use(monkeypatch, recs)
    run = _run(requests=[(1, 10.5), (2, 11.0), (3, 12.0), (4, 19.9), (5, 15.0), (6, 20.0), (7, 12.0)])
    # rid 5 profiled, rid 6 due at the close, rid 7 never admitted: left out
    assert spans.request_p75_ms(run, "request.queue") == pytest.approx(32.5)  # p75 of 10, 20, 30, 40
    assert load_module("metrics", "first_token_hold_p75_ms").read(run, None) == pytest.approx(5.0)
    assert spans.request_p75_ms(dict(run, open_loop=False), "request.queue") is None


def test_dropped_records_of_the_window_give_none(monkeypatch):
    recs = _step(12.0)
    _use(monkeypatch, recs, dropped=3)  # the oldest kept record lies in the window: others may have gone
    assert spans.mean_ms(_run(), "decode.sync") is None
    assert spans.per_work_step_ms(_run(), "handoff") is None
    _use(monkeypatch, _step(5.0) + recs, dropped=3)  # all dropped records ended before the window
    assert spans.mean_ms(_run(), "decode.sync") == pytest.approx(5.0)
    monkeypatch.setattr(spans, "program_spans", lambda: None)  # a program without the tracer
    assert all(load_module("metrics", m).read(_run(requests=[(1, 11.0)]), None) is None for m in NEW)


@pytest.mark.parametrize("name", ["deepseek-moe-16b.decode", "deepseek-moe-16b.longprompt"])
def test_traced_run_reports_the_new_metrics(monkeypatch, name):
    """The serving cell's traced run on the CPU (its card-only sessions
    trace the host, which the CPU build of the profiler needs); every new
    metric of the cell is read, and the profiled steps are left out."""
    from torch.profiler import ProfilerActivity

    from repro_torch import obs

    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: real(activities=sorted(set(activities) | {ProfilerActivity.CPU}, key=str)))
    torch.manual_seed(0)
    cell = small_cell(name)
    args = SimpleNamespace(seed=2**31 + 5, seconds=1.5, trace=1, control=0)
    ctx = make_ctx(args, cell, "cpu", time.perf_counter(), read_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"])
    obs.clear()
    run = load_module("drivers", "serve").run(ctx)
    count_requests(run)
    wanted = [m["name"] for m in benchmark_entries(name)["per_layer"] if m["name"] in NEW]
    assert len(wanted) == (3 if name.endswith("decode") else 2)
    got = {m: load_module("metrics", m).read(run, ctx) for m in wanted}
    assert all(v is not None and v >= 0 for v in got.values()), got
    recs, dropped = obs.spans()
    assert dropped == 0 and any(r[spans.PROFILED] for r in recs)
