"""The hybrid chat cell (``zamba2-1.2b.chat``) on the CPU at the smoke sizes:
whole runs through the harness come out correct, and not correct with the
control or a fault planted; the plain reference against the port's plain
path; the reference's FLOPs a token against a hand count; and a traced run
reads the cell's per-layer metrics that the CPU can give."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.tests.helpers import smoke_cfg

from perfbench import faults, flops
from perfbench.cells import HERE, benchmark_entries, load_module, read_json
from perfbench.harness import make_ctx
from perfbench.tests.test_reference import TOL, port_logits
from perfbench.tests.test_run_cpu import run_cell, small_cell
from perfbench.weights import make_params

CELL = "zamba2-1.2b.chat"


def test_sound_run_is_correct():
    torch.manual_seed(0)
    cell = small_cell(CELL)
    res = run_cell(cell, seed=2**31 + 3)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in benchmark_entries(CELL)["end_to_end"]} == {"ttft_p75_ms", "setup_s"}
    assert res["check"]["served_mean_gap"]["value"] < 1e-4  # float32 on both sides


def test_control_is_not_correct():
    cell = small_cell(CELL)
    res = run_cell(cell, seed=2**31 + 4, control=True)
    assert not res["correct"], res["check"]
    assert res["check"]["served_mean_gap"]["value"] > cell["check"]["served_mean_gap"]


@pytest.mark.parametrize("how", faults.FAULTS)
def test_broken_path_is_not_correct(monkeypatch, how):
    from repro_torch.serve import server as server_mod

    monkeypatch.setattr(server_mod, "decode_step", faults.broken_decode(server_mod.decode_step, how))
    res = run_cell(small_cell(CELL), seed=2**31 + 5)
    assert not res["correct"], res["check"]


def test_reference_matches_port_plain_path():
    cfg = smoke_cfg("zamba2-1.2b")
    params = make_params(cfg, 2**31 + 1234, "cpu")
    g = torch.Generator().manual_seed(5)
    reqs = [(torch.randint(0, cfg["vocab_size"], (plen,), generator=g).tolist(),
             torch.randint(0, cfg["vocab_size"], (n,), generator=g).tolist()) for plen, n in ((13, 9), (29, 4))]
    for (prompt, served), r in zip(reqs, load_module("reference", "hybrid_lm").served_logits(params, cfg, reqs)):
        p = port_logits(params, cfg, prompt, served)
        assert r.shape == p.shape
        assert (r - p).abs().max().item() / r.abs().max().item() < TOL


def test_hybrid_flops_by_hand():
    """Smoke sizes: d 64, 5 layers, d_in 128, 8 SSM heads of 16, 2 groups of
    state 16, conv 4 (conv_dim 192, in_proj out 328); 2 invocations of a
    block with attention input 128, 4 heads of 32, d_ff 128, adapters of rank 8."""
    cfg = smoke_cfg("zamba2-1.2b")
    mamba = 2 * 64 * 328 + 2 * 4 * 192 + 2 * 2 * 8 * 16 * 16 + 2 * 128 * 64
    shared = (2 * 128 * 3 * 128 + 2 * 128 * 64  # q, k, v, o
              + 2 * (3 * 128 * 8 + 8 * 3 * 128)  # q/k/v adapters
              + 2 * 64 * 256 + 2 * 128 * 64  # gate-up, down
              + 2 * (64 * 8 + 8 * 256)  # gate-up adapter
              + 2 * 64 * 64)  # the invocation's linear layer
    assert flops.per_token(cfg) == 5 * mamba + 2 * shared
    assert flops.attention_layers(cfg) == 2
    assert flops.attn_scores(cfg)(10) == 4 * 4 * 32 * 10  # head dim 32, not d / H = 16
    assert flops.prefill(cfg, 7) == 7 * (5 * mamba + 2 * shared) + 2 * 4 * 4 * 32 * 28 + 2 * 64 * 256


def test_ssd_roofline_by_hand():
    mod = load_module("rooflines", "ssd_chunk")
    a, x = torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8, 16, dtype=torch.bfloat16)
    b = torch.zeros(1, 2, 3, 8, 16, dtype=torch.bfloat16)
    rec = mod.capture((a, x, b, b), {})
    f, nbytes, dtype = mod.work(rec)
    assert dtype == "bfloat16"
    assert nbytes == 4 * 4 * 3 * 8 + 2 * 3 * 8 * (2 * 4 * 16 + 2 * 2 * 16) + 4 * 4 * 3 * 16 * 16
    assert f == 4 * 3 * (36 * (2 * 16 + 1 + 2 * 16) + 8 * 16 + 2 * 8 * 16 * 16)


def test_traced_run_reads_the_cells_metrics(monkeypatch):
    """A traced run on the CPU (its card-only sessions trace the host): the
    prefill reading comes out; the sessions hold no card records here, so
    the idle share and the SSD kernel's roofline (a card-only kernel) find
    nothing and are left out."""
    from torch.profiler import ProfilerActivity

    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: real(activities=sorted(set(activities) | {ProfilerActivity.CPU}, key=str)))
    torch.manual_seed(0)
    cell = small_cell(CELL)
    args = SimpleNamespace(seed=2**31 + 6, seconds=1.5, trace=1, control=0)
    ctx = make_ctx(args, cell, "cpu", time.perf_counter(), read_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"])
    run = load_module("drivers", cell["driver"]).run(ctx)
    wanted = {m["name"] for m in benchmark_entries(CELL)["per_layer"]}
    assert wanted == {"prefill_ms_per_ktok", "device_idle.serve", "ssd_scan_roofline.prefill",
                      "shared_block_ms_per_ktok.prefill"}
    got = {m: load_module("metrics", m).read(run, ctx) for m in wanted}
    assert got["prefill_ms_per_ktok"] > 0
    ranges = run["trace"]["repro_ranges"]
    assert ranges["prefill"] == 0.0 and ranges["ranges"] == {}  # no card records on the CPU
    assert all(got[m] is None for m in wanted - {"prefill_ms_per_ktok"})


def test_shared_block_ms_per_ktok_reads_the_card_time_inside_the_prefill_ranges():
    """Synthetic host ranges with the device time of the kernels launched
    inside each: a prefill holding a shared-block range and a mixer range;
    a shared-block range outside any prefill is left out.  The metric is
    that card time per 1,000 prompt tokens."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    ranges = load_module("drivers", "serve_ranges")
    host = lambda name, s, e, dev: NS(device_type=DeviceType.CPU, name=name, device_time_total=dev,  # noqa: E731
                                      time_range=NS(start=s, end=e))
    events = [host("perfbench::prefill", 100, 1000, 740.0), host("repro::shared_block", 200, 400, 180.0),
              host("repro::mixer", 400, 900, 480.0), host("repro::shared_block", 1200, 1300, 80.0),
              NS(device_type=DeviceType.CUDA, name="repro::shared_block", device_time_total=0.0,
                 time_range=NS(start=210, end=390))]
    prefill, names = ranges.prefill_ranges(NS(events=lambda: events))
    assert prefill == pytest.approx(740e-6)
    assert names == {"shared_block": pytest.approx(180e-6), "mixer": pytest.approx(480e-6)}
    read = load_module("metrics", "shared_block_ms_per_ktok.prefill").read
    got = {"prefill": prefill, "tokens": 2000, "ranges": names}
    assert read({"trace": {"repro_ranges": got}}, None) == pytest.approx(180e-3 / 2)
    assert read({"trace": {"repro_ranges": dict(got, ranges={})}}, None) is None
    assert read({"trace": {"repro_ranges": dict(got, tokens=0)}}, None) is None
    assert read({"trace": {}}, None) is None and read({"trace": None}, None) is None


def test_a_traced_run_without_the_ranges_is_an_error(monkeypatch):
    """Should ``drivers/serve.py`` stop taking ``trace.Sessions`` when its run
    starts, the cell's traced runs fail instead of reading None."""
    ranges = load_module("drivers", "serve_ranges")
    monkeypatch.setattr(ranges.serve, "run", lambda ctx: {"trace": {"sessions": 3}})
    with pytest.raises(RuntimeError, match="repro:: ranges were not read"):
        ranges.run(SimpleNamespace(trace=1))
    monkeypatch.setattr(ranges.serve, "run", lambda ctx: {"trace": None})
    assert ranges.run(SimpleNamespace(trace=0)) == {"trace": None}
