"""A whole run of each serving cell on the CPU at the smoke sizes, past
the harness's look for a card: the traffic, the engine loop, the metrics
and the check at the cell's own limits.  Then the same with the control
in the program's place, and with the timed path broken underneath
(``perfbench/faults.py``), where ``correct`` has to come out false."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.tests.helpers import smoke_cfg

from perfbench import faults, harness
from perfbench.cells import HERE, benchmark_entries, load_cell, read_json

CELLS = ["deepseek-moe-16b.decode", "deepseek-moe-16b.longprompt"]


# float32 on both sides at the smoke sizes: a sound run reads about 1e-6,
# the float8 control about 1e-2 (the committed limits are set for the
# cells' own sizes and bf16, where the two read 0.02-0.05 and 0.18-0.23)
SMOKE_LIMIT = 1e-3


def small_cell(name: str) -> dict:
    """The cell at the smoke configuration, with short prompts and answers;
    its ``check`` compares the numbers the committed cell compares, each
    with the smoke size's limit."""
    cell = load_cell(name)
    cell["cfg"] = smoke_cfg(cell["config"])
    mix = cell["mix"]
    mix["prompt"] = {"dist": "loguniform", "min": 4, "max": 20}
    mix["output"] = {"dist": "loguniform", "min": 6, "max": 16}
    cell["serve"].update(context=48, max_prefill=24)
    if mix["kind"] == "poisson":
        cell["rate"] = 12.0
    cell["trace"] = {"every": 4, "length": 2}
    cell["check"] = {k: (v if k == "sample" else SMOKE_LIMIT) for k, v in cell["check"].items()}
    return cell


def run_cell(cell, seed=3, seconds=1.5, control=False):
    args = SimpleNamespace(seed=seed, seconds=seconds, trace=0, control=int(control))
    peaks = read_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]
    ctx = harness.make_ctx(args, cell, "cpu", time.perf_counter(), peaks)
    wanted = benchmark_entries(cell["name"])["end_to_end"]
    return harness.execute(ctx, cell, wanted)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    torch.manual_seed(0)
    cell = small_cell(name)
    res = run_cell(cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in benchmark_entries(name)["end_to_end"]}
    assert set(res["metrics"]) == names
    assert set(res["check"]) == {k for k in cell["check"] if k != "sample"} | {"wrong_length", "failed"}
    assert res["check"]["served_mean_gap"]["value"] < 1e-4  # float32 on both sides
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in float8 in the program's place, judged on the cell's
    own numbers: the run comes out not correct."""
    cell = small_cell(name)
    res = run_cell(cell, control=True)
    assert not res["correct"], res["check"]
    assert res["check"]["served_mean_gap"]["value"] > cell["check"]["served_mean_gap"]


@pytest.mark.parametrize("how", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(monkeypatch, name, how):
    from repro_torch.serve import server as server_mod

    monkeypatch.setattr(server_mod, "decode_step", faults.broken_decode(server_mod.decode_step, how))
    res = run_cell(small_cell(name))
    assert not res["correct"], res["check"]
