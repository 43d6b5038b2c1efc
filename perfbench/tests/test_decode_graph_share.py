"""``decode_graph_share`` and ``decode_graph_share.serve``: on synthetic
span lists, the replayed steps among the window's unprofiled decode steps,
and None where the program has no graph runner; then a traced run of each
cell at the smoke size on the CPU, where no step replays (the runner is
built on a card only)."""
from __future__ import annotations

import importlib.util
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.tests.helpers import smoke_cfg  # noqa: F401  (puts src/ on the path)

from perfbench.cells import HERE, benchmark_entries, load_module, read_json
from perfbench.harness import make_ctx
from perfbench.tests.test_program_spans import MS, _run, _step, _use
from perfbench.tests.test_run_cpu import small_cell

NAMES = {"deepseek-moe-16b.decode": "decode_graph_share", "deepseek-moe-16b.longprompt": "decode_graph_share.serve"}


def _graphed(t, profiled=False):
    """A step at ``t`` s whose decode replayed: a ``decode.graph`` span under its ``decode.dispatch``."""
    recs = _step(t, profiled=profiled)
    dispatch = next(r for r in recs if r[0] == "decode.dispatch")
    return recs + [("decode.graph", dispatch[1] + MS, dispatch[1] + 40 * MS, dispatch[1], None, profiled)]


@pytest.mark.parametrize("name", sorted(NAMES.values()))
def test_share_counts_the_window_s_replayed_steps(monkeypatch, name):
    read = load_module("metrics", name).read
    # in the window: 3 replayed, 1 eager, 1 profiled (left out); outside it: 2 replayed
    recs = _graphed(5.0) + _graphed(11.0) + _graphed(12.0) + _step(13.0) + _graphed(14.0)
    recs += _graphed(15.0, profiled=True) + _graphed(21.0)
    _use(monkeypatch, recs)
    assert read(_run(), None) == pytest.approx(75.0)
    _use(monkeypatch, _step(12.0))
    assert read(_run(), None) == 0.0
    _use(monkeypatch, _step(12.0, work=False))  # no decode step in the window
    assert read(_run(), None) is None
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "repro_torch.models.decode_graph" else real(n, *a))
    _use(monkeypatch, recs)
    assert read(_run(), None) is None  # a program without the runner


@pytest.mark.parametrize("cell", sorted(NAMES))
def test_traced_cpu_run_reads_no_replayed_step(monkeypatch, cell):
    from torch.profiler import ProfilerActivity

    from repro_torch import obs

    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: real(activities=sorted(set(activities) | {ProfilerActivity.CPU}, key=str)))
    torch.manual_seed(0)
    c = small_cell(cell)
    args = SimpleNamespace(seed=2**31 + 9, seconds=1.0, trace=1, control=0)
    ctx = make_ctx(args, c, "cpu", time.perf_counter(), read_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"])
    obs.clear()
    run = load_module("drivers", "serve").run(ctx)
    assert NAMES[cell] in [m["name"] for m in benchmark_entries(cell)["per_layer"]]
    assert load_module("metrics", NAMES[cell]).read(run, ctx) == 0.0
