"""Generators, statistics, FLOP and roofline counts, profiler sessions,
finding cells by name, and what the benchmark imports."""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from perfbench.tests.helpers import HERE, ROOT, smoke_cfg

from perfbench import flops, stats
from perfbench.cells import benchmark_entries, load_cell, load_module, read_json
from perfbench.seeds import rng
from perfbench.trace import Sessions, read_session
from perfbench.weights import make_params

CELLS = ["deepseek-moe-16b.decode", "deepseek-moe-16b.longprompt"]


# ---------------------------------------------------------------- traffic
def _traffic(name, seed, seconds=45.0):
    cell = load_cell(name)
    gen = load_module("traffic", cell["mix"]["kind"])
    return gen.Traffic(cell["mix"], cell, rng(seed, "traffic"), seconds, cell["cfg"]["vocab_size"])


def _draw(t, n=40):
    out = list(t.prime())
    now = 0.0
    while len(out) < n:
        now += 0.5
        out += t.due(now, list(range(8)) if not t.open_loop else [])
    return [(c, round(d, 9), tuple(p), m) for c, d, p, m in out[:n]]


@pytest.mark.parametrize("name", CELLS)
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(name):
    a, b, c = _draw(_traffic(name, 2**31 + 5)), _draw(_traffic(name, 2**31 + 5)), _draw(_traffic(name, 7))
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_lengths(name):
    """The seed orders the lengths; it does not choose them."""
    p1, o1 = _traffic(name, 1).lengths()
    p2, o2 = _traffic(name, 99).lengths()
    assert sorted(p1) == sorted(p2) and sorted(o1) == sorted(o2)
    assert p1 != p2


@pytest.mark.parametrize("name", CELLS)
def test_lengths_stay_inside_the_mix(name):
    cell = load_cell(name)
    prompts, outputs = _traffic(name, 3).lengths()
    mix, sv = cell["mix"], cell["serve"]
    assert mix["prompt"]["min"] <= min(prompts) and max(prompts) <= mix["prompt"]["max"] <= sv["max_prefill"]
    assert mix["output"]["min"] <= min(outputs) and max(outputs) <= mix["output"]["max"]
    assert mix["prompt"]["max"] + mix["output"]["max"] <= sv["context"]


def test_poisson_offers_the_same_requests_in_the_window_for_every_seed():
    """N = rate x window arrivals, all inside the window, their gaps the
    exponential quantiles in the seed's order."""
    r = load_cell("deepseek-moe-16b.longprompt")["rate"]
    for seed in (4, 2**31 + 11):
        t = _traffic("deepseek-moe-16b.longprompt", seed, seconds=40.0)
        due = [s[1] for s in t.schedule]
        gaps = np.diff([0.0] + due)
        n = len(gaps)
        assert n == round(r * 40.0) and due[-1] < 40.0
        want = np.array(sorted(-math.log(1 - (i + 0.5) / n) for i in range(n)))
        assert np.allclose(sorted(gaps), want * 40.0 * n / ((n + 1) * want.sum()))
        assert abs(40.0 / (n + 1) - 1 / r) < 0.05 / r


def test_a_lognormal_given_by_its_mean_has_the_median_it_implies():
    from perfbench.traffic.lengths import quantile

    by_mean = {"dist": "lognormal", "mean": 338.0, "sigma": 1.0, "min": 1, "max": 10**6}
    by_median = dict(by_mean, median=338.0 * math.exp(-0.5))
    del by_median["mean"]
    for q in (0.05, 0.5, 0.9):
        assert quantile(by_mean, q) == quantile(by_median, q)
    assert quantile(by_mean, 0.5) == round(338.0 * math.exp(-0.5))


# ------------------------------------------------------------ statistics
def test_percentile_interpolates_over_all_samples():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 90) == 3.0
    rs = np.random.default_rng(0).random(37).tolist()
    for q in (10, 50, 90, 95):
        assert stats.percentile(rs, q) == pytest.approx(float(np.percentile(rs, q)))


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(450, 45.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def _run(times, open_=0.0, close=10.0, open_loop=True, dues=None):
    reqs = [{"times": ts, "due": (dues or [0.0] * len(times))[i]} for i, ts in enumerate(times)]
    return {"kind": "serve", "open": open_, "close": close, "t_end": close + 1, "requests": reqs,
            "open_loop": open_loop}


def test_token_metrics_read_every_request():
    run = _run([[1.0, 2.0, 3.0], [0.5, 5.0, 12.0]], dues=[0.5, 0.25])
    assert load_module("metrics", "tokens_per_s").read(run, None) == pytest.approx(5 / 10)
    gaps = [1.0, 1.0, 4.5]  # 12.0 lies past the close
    assert load_module("metrics", "itl_p95_ms").read(run, None) == pytest.approx(1e3 * np.percentile(gaps, 95))
    waits = [0.5, 0.25]
    assert load_module("metrics", "ttft_p75_ms").read(run, None) == pytest.approx(1e3 * np.percentile(waits, 75))


def test_ttft_counts_a_request_that_never_got_a_token_until_the_end():
    run = _run([[1.0], []], dues=[0.5, 2.0])
    assert load_module("metrics", "ttft_p75_ms").read(run, None) == pytest.approx(
        1e3 * np.percentile([0.5, 11.0 - 2.0], 75))


# ------------------------------------------------------- FLOPs, rooflines
def _cfg(name):
    return read_json(HERE / "configs" / f"{name}.json")


def test_moe_flops_by_hand():
    c = _cfg("deepseek-moe-16b")
    d, f, e, h, hd, L, V = 2048, 1408, 64, 16, 128, 28, 102400
    proj = 2 * d * (3 * h * hd) + 2 * h * hd * d
    moe = 2 * d * e + 6 * 6 * d * f + 2 * 6 * d * f
    assert flops.per_token(c) == L * (proj + moe)
    assert flops.decode(c, 99) == L * (proj + moe) + L * 4 * h * hd * 100 + 2 * d * V
    assert flops.prefill(c, 10) == 10 * L * (proj + moe) + L * 4 * h * hd * 55 + 2 * d * V
    # the active parameters of the published count, 2.8 B, to within the norms and the router
    assert abs(flops.per_token(c) / 2 - 2.8e9 + 2 * d * V / 2) / 2.8e9 < 0.1


# make_params of deepseek-moe-16b at the smoke sizes, seed 1234: SHA-256 of
# every leaf's bytes in the layout's key order, as drawn before the family's
# layout moved into reference/moe_lm.py
DEEPSEEK_SMOKE_DIGESTS = {
    "float32": "0c3f9bb19fba59a27f815430e1a320221fb60af839dd494a914becaf7c0d67e5",
    "bfloat16": "9d0a6375b576a6304d27b62a8d9ed27f0803c745e7a7295d7008ecdb799db224",
}


DEEPSEEK_KEYS = ["embed", "ln_f", "lm_head", "layers.ln1", "layers.attn.wq", "layers.attn.wk", "layers.attn.wv",
                 "layers.attn.wo", "layers.ln2", "layers.moe.router", "layers.moe.w_up", "layers.moe.w_gate",
                 "layers.moe.w_down", "layers.moe.shared.w_up", "layers.moe.shared.w_gate", "layers.moe.shared.w_down"]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        yield from (_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])


@pytest.mark.parametrize("dtype", sorted(DEEPSEEK_SMOKE_DIGESTS))
def test_deepseek_weights_are_drawn_bit_for_bit_as_before(dtype):
    leaves = list(_leaves(make_params(smoke_cfg("deepseek-moe-16b", dtype), 1234, "cpu")))
    assert [k for k, _ in leaves] == DEEPSEEK_KEYS  # the order the leaves are drawn and hashed in
    h = hashlib.sha256()
    for _, t in leaves:
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == DEEPSEEK_SMOKE_DIGESTS[dtype]


def test_a_reference_without_layout_names_its_file(tmp_path, monkeypatch):
    from perfbench import cells

    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "no_layout.py").write_text("def served_logits(params, cfg, requests, mode):\n    return []\n")
    real = cells.load_module
    monkeypatch.setattr(cells, "load_module", lambda kind, name: real(kind, name, tmp_path))
    cfg = dict(_cfg("deepseek-moe-16b"), reference="no_layout")
    with pytest.raises(AttributeError, match=r"reference/no_layout\.py has no layout\(\)"):
        make_params(cfg, 1, "cpu")
    with pytest.raises(AttributeError, match=r"reference/no_layout\.py has no per_token_flops\(\)"):
        flops.per_token(cfg)


def test_visible_pairs_by_hand():
    assert flops.visible_pairs(10, 4) == 4 * 5 // 2 + 6 * 4
    assert flops.visible_pairs(10) == 55


def test_attention_roofline_by_hand():
    att = load_module("rooflines", "attention")
    rec = {"q": (1, 8, 2, 4), "kv": 1, "dtype": "bfloat16", "causal": True, "window": 0, "chunk": 0}
    f, b, dt = att.work(rec)
    assert f == 4 * 1 * 2 * 4 * 36 and b == 2 * 8 * 4 * (2 * 2 + 2 * 1) and dt == "bfloat16"
    assert att.visible_pairs(8, True, 3, 0) == 1 + 2 + 3 * 6
    assert att.visible_pairs(8, True, 0, 4) == 2 * 10
    assert att.visible_pairs(5, False, 0, 0) == 25


def test_expert_roofline_counts_only_routed_rows_and_used_experts():
    gmm = load_module("rooflines", "expert_ffn_matmul")
    gmm._last.clear()
    e, r, d, f = 4, 6, 8, 5
    x = torch.zeros(e, r, d)
    x[0, :3] = 1.0  # expert 0: 3 routed rows; expert 2: 1; experts 1 and 3: none
    x[2, 0] = 2.0
    w_in, w_out = torch.ones(e, d, f), torch.ones(e, f, d)
    gate = gmm.capture((x, w_in), {})
    up = gmm.capture((x, w_in), {})
    h = torch.zeros(e, r, f)
    h[0, :3] = 1.0
    h[2, 0] = 1.0
    down = gmm.capture((h, w_out), {})
    nxt = gmm.capture((torch.zeros(e, r, d), w_in), {})  # the next layer's gate counts afresh
    assert down["down"] and not nxt["down"] and nxt["rows"].tolist() == [0, 0, 0, 0]
    for rec in (gate, up):
        fl, by, _ = gmm.work(rec)
        assert fl == 2 * 4 * d * f
        assert by == 4 * (2 * d * f + 4 * (d + f))  # bf16 would be 2 a value; these are f32
    fl, by, _ = gmm.work(down)
    assert fl == 2 * 4 * f * d and by == 4 * (2 * f * d + 4 * (f + d))


# ------------------------------------------------------ profiler sessions
class _Ev(SimpleNamespace):
    pass


def _kernel(name, s, e):
    return _Ev(device_type=DeviceType.CUDA, name=name, time_range=SimpleNamespace(start=s, end=e),
               device_time_total=e - s, is_user_annotation=False)


def _host(name, s, e, dev=0.0):
    return _Ev(device_type=DeviceType.CPU, name=name, time_range=SimpleNamespace(start=s, end=e),
               device_time_total=dev, is_user_annotation=False)


class _Prof:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def _session(gmm_records):
    ev = [_host("perfbench::step", 0, 1000), _host("perfbench::decode_step", 15, 900),
          _host("perfbench::expert_ffn_matmul", 95, 200), _kernel("aten::mm kernel", 20, 60),
          _Ev(device_type=DeviceType.CUDA, name="perfbench::expert_ffn_matmul", is_user_annotation=True,
              time_range=SimpleNamespace(start=100, end=125), device_time_total=25.0)]
    ev += [_kernel("gmm_kernel_tc<1>", 100 + 10 * i, 105 + 10 * i) for i in range(gmm_records)]
    return {"prof": _Prof(ev), "kind": "ranges", "launches": {"flash_attention": 0, "ssd_scan": 0, "moe_gmm": 3, "grad_pack": 0},
            "calls": [("expert_ffn_matmul", "decode", {"e": 1, "r": 1, "d": 1000, "f": 1000, "rows": [1],
                                                       "x_ptr": 0, "down": False, "dtype": "bfloat16"})],
            "walls": [1000e-6], "tokens": [0]}


def test_session_that_lost_records_is_dropped():
    entries = SimpleNamespace(module_of=lambda e: load_module("rooflines", "expert_ffn_matmul"))
    s = Sessions(entries, every=10, length=2)
    s.raw = [dict(_session(3), kind="device"), _session(3), _session(2)]
    peaks = read_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]
    out = s.summarize(peaks)
    assert out["sessions"] == 3 and out["complete"] == {"device": 1, "ranges": 1}
    assert out["dropped"][0]["records_vs_launches"] == {"moe_gmm": (2, 3)}
    assert out["busy_s"] == pytest.approx((40 + 15) / 1e6)  # from the device session alone
    assert out["window_s"] == pytest.approx(1000e-6)
    assert out["device_sessions"] == [(pytest.approx(55e-6), [0])]  # one step, no prompt prefilled
    bound = max(2 * 1000 * 1000 / peaks["bfloat16_flops"], 2 * (1000 * 1000 + 2000) / peaks["hbm_bytes_per_s"])
    assert out["entries"]["expert_ffn_matmul.decode"][:2] == pytest.approx([bound, 15e-6])  # the kernels inside the span


def test_idle_share_divides_by_the_unprofiled_walls():
    """The card-only sessions' busy seconds a step over the unprofiled
    steps' mean wall, not over the profiled steps' own (slower) walls."""
    from perfbench.readings import idle_share

    run = {"trace": {"busy_s": 0.06, "window_s": 0.5, "device_sessions": [(0.06, [0, 0])]},
           "work_walls": [(0.09, 0), (0.11, 0)]}
    assert idle_share(run) == pytest.approx(100 * (1 - 0.03 / 0.1))
    assert idle_share(dict(run, work_walls=[])) is None
    assert idle_share(dict(run, trace=dict(run["trace"], device_sessions=[]))) is None


def test_idle_share_holds_admitting_steps_against_their_own_walls():
    """Card-only sessions that caught only admitting steps (a prefill each),
    in a window of mostly plain decode steps: each session's busy seconds
    are held against the walls of its own steps' kinds (an admitting step's
    by the line of unprofiled admitting walls against prompt tokens), not
    against the mean of all steps, and the kinds are weighted by their
    unprofiled walls."""
    from perfbench.readings import idle_share

    plain, slope = 0.035, (0.20 - 0.12) / 1000  # unprofiled: 18 plain steps; admissions of 1000 and 2000 tokens
    walls = [(plain, 0)] * 18 + [(0.12, 1000), (0.20, 2000)]
    sessions = [(0.16, [1500, 0]), (0.20, [2500])]  # an admission and the plain step after it; a longer admission
    run = {"trace": {"device_sessions": sessions}, "work_walls": walls}
    expected = [0.16 + plain, 0.16 + slope * 1000]
    rho_admitting = (0.16 + 0.20) / sum(expected)
    got = idle_share(run)
    assert 0 <= got <= 100
    assert got == pytest.approx(100 * (1 - rho_admitting))  # no plain session: plain steps take the same share
    busy_a_step = (0.16 + 0.20) / 3
    assert 100 * (1 - busy_a_step / (sum(w for w, _ in walls) / len(walls))) < -100  # one ratio over all steps
    run["trace"]["device_sessions"] = sessions + [(0.063, [0, 0])]
    rho_plain = 0.063 / (2 * plain)
    held = 18 * plain * rho_plain + (0.12 + 0.20) * rho_admitting
    got = idle_share(run)
    assert 0 <= got <= 100
    assert got == pytest.approx(100 * (1 - held / (18 * plain + 0.32)))


def test_idle_gaps_are_labelled_by_the_host_range():
    read = read_session(_Prof(_session(3)["prof"].events()), {"moe_gmm": {"device_names": ["gmm_kernel"]}})
    assert read["records"] == {"moe_gmm": 3}
    assert sum(read["gaps"].values()) == pytest.approx((1000 - 55) / 1e6)
    assert set(read["gaps"]) == {"step", "decode_step", "expert_ffn_matmul"}


# ----------------------------------------------------------- by name only
def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A copy of the benchmark with one more cell (a new cell file and a new
    mix file): found by name, no existing file edited."""
    copy = tmp_path / "perfbench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    mix = dict(read_json(copy / "traffic" / "longprompt.json"), name="longprompt-bursty")
    (copy / "traffic" / "longprompt-bursty.json").write_text(json.dumps(mix))
    cell = dict(read_json(copy / "workloads" / "deepseek-moe-16b.longprompt.json"),
                name="deepseek-moe-16b.longprompt-bursty", traffic="longprompt-bursty", rate=2.0)
    (copy / "workloads" / "deepseek-moe-16b.longprompt-bursty.json").write_text(json.dumps(cell))
    got = load_cell("deepseek-moe-16b.longprompt-bursty", base=copy)
    assert got["mix"]["name"] == "longprompt-bursty" and got["cfg"]["name"] == "deepseek-moe-16b" and got["rate"] == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())


# the reference module of a dense decoder family, written into a copy of the benchmark
DENSE_LM = '''"""Plain float32 reference of the port's dense decoder: every layer
pre-norm causal self-attention (RoPE, split halves), then a pre-norm SwiGLU FFN."""
import torch

from .common import (attention, attention_layout, attention_proj_flops, head_layout, head_logits, layer, ones,
                     rms_norm, served_positions, swiglu, swiglu_flops, swiglu_layout)


def layout(cfg):
    d, lead = cfg["d_model"], (cfg["n_layers"],)
    return {**head_layout(cfg), "layers": {"ln1": ones(lead + (d,)), "attn": attention_layout(cfg, lead),
                                           "ln2": ones(lead + (d,)), "ffn": swiglu_layout(d, cfg["d_ff"], lead)}}


def per_token_flops(cfg):
    return cfg["n_layers"] * (attention_proj_flops(cfg) + swiglu_flops(cfg["d_model"], cfg["d_ff"]))


def attention_calls(cfg):
    return cfg["n_layers"]


def served_logits(params, cfg, requests, mode="f32"):
    out = []
    for ids, _, pos in served_positions(requests):
        h = params["embed"][torch.tensor(ids, device=params["embed"].device)].float()
        for i in range(cfg["n_layers"]):
            lp = layer(params["layers"], i)
            h = h + attention(lp["attn"], rms_norm(h, lp["ln1"], cfg["norm_eps"]), cfg, 0, mode)
            h = h + swiglu(lp["ffn"], rms_norm(h, lp["ln2"], cfg["norm_eps"]), mode)
        out.append(head_logits(params, cfg, h[pos], mode))
    return out
'''

DENSE_SIZES = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
               "attn_kind", "window", "rope_theta", "norm_eps", "tie_embeddings", "gated_ffn")


def _add_dense_family(copy: Path) -> str:
    """A dense decoder at the port's smoke sizes, added to the copy as new
    files only: its configuration, its reference module, a mix that reuses
    the decode mix at short lengths, and a cell.  Returns the cell's name."""
    from repro_torch.configs import get_smoke_config

    smoke = dataclasses.asdict(get_smoke_config("tinyllama-1.1b"))
    cfg = {"name": "tinyllama-smoke", "source": "https://arxiv.org/abs/2401.02385", "port_arch": "tinyllama-1.1b",
           "reference": "dense_lm", "dtype": "float32", "reduced": [], **{k: smoke[k] for k in DENSE_SIZES}}
    mix = dict(read_json(copy / "traffic" / "decode.json"), name="decode-short",
               prompt={"dist": "loguniform", "min": 4, "max": 20}, output={"dist": "loguniform", "min": 6, "max": 16})
    cell = {"name": "tinyllama-smoke.decode", "config": "tinyllama-smoke", "traffic": "decode-short", "driver": "serve",
            "chips": 1, "serve": {"slots": 8, "context": 48, "max_prefill": 24, "transport": "collective"},
            "trace": {"every": 4, "length": 2}, "check": {"sample": 8, "served_mean_gap": 1e-3},
            "why": "a dense decoder family added as new files"}
    (copy / "reference" / "dense_lm.py").write_text(DENSE_LM)
    (copy / "configs" / "tinyllama-smoke.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "decode-short.json").write_text(json.dumps(mix))
    (copy / "workloads" / "tinyllama-smoke.decode.json").write_text(json.dumps(cell))
    return cell["name"]


# run in a process of its own whose ``perfbench`` is the copy (argv: the copy, the cell, the metrics wanted)
RUN_COPY = '''
import importlib.util, json, sys, time
from pathlib import Path
from types import SimpleNamespace

import torch

copy, name, wanted = Path(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
loaded = []  # every file cells.load_module loads (it names the module perfbench.<kind>.<name>)
real = importlib.util.spec_from_file_location


def spy(mod, path, *a, **k):
    if mod.startswith("perfbench."):
        loaded.append(str(path))
    return real(mod, path, *a, **k)


importlib.util.spec_from_file_location = spy
from perfbench import flops, harness
from perfbench.cells import load_cell, load_module, read_json

cell = load_cell(name)
peaks = read_json(copy / "peaks.json")["NVIDIA H100 80GB HBM3"]
out = {"runs": []}
for control in (0, 1):
    torch.manual_seed(0)
    args = SimpleNamespace(seed=2**31 + 21, seconds=1.5, trace=0, control=control)
    res = harness.execute(harness.make_ctx(args, cell, "cpu", time.perf_counter(), peaks), cell, wanted)
    out["runs"].append({k: res[k] for k in ("correct", "attempted", "failed", "metrics", "check")})
from torch.profiler import ProfilerActivity

prof = torch.profiler.profile  # a traced run: the card-only sessions made host sessions on the CPU
torch.profiler.profile = lambda activities: prof(activities=sorted(set(activities) | {ProfilerActivity.CPU}, key=str))
args = SimpleNamespace(seed=2**31 + 22, seconds=1.0, trace=1, control=0)
run = load_module("drivers", "serve").run(harness.make_ctx(args, cell, "cpu", time.perf_counter(), peaks))
out.update(sessions=run["trace"]["sessions"], loaded=loaded, per_token=flops.per_token(cell["cfg"]),
           modules={m: getattr(mod, "__file__", None) for m, mod in sys.modules.items() if m.split(".")[0] == "perfbench"})
print(json.dumps(out))
'''


def test_a_family_added_as_new_files_runs(tmp_path):
    """A copy of the benchmark with a dense decoder family added as new files
    only, run in a process whose ``perfbench`` is the copy: whole CPU runs of
    its cell through the harness's own functions come out correct with the
    cell's end-to-end metrics, and not correct with the control; every
    module, by name or by import, comes from the copy."""
    copy = tmp_path / "perfbench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    name = _add_dense_family(copy)
    wanted = [m for m in benchmark_entries("deepseek-moe-16b.decode")["end_to_end"]
              if m["name"] in ("tokens_per_s", "itl_p95_ms", "setup_s")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", RUN_COPY, str(copy), name, json.dumps(wanted)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for control, res in enumerate(out["runs"]):
        assert res["correct"] is (not control), res["check"]
        assert set(res["metrics"]) == {"tokens_per_s", "itl_p95_ms", "setup_s"}
        assert res["attempted"] > 0 and res["failed"] == 0
    assert out["runs"][1]["check"]["served_mean_gap"]["value"] > 1e-3
    assert out["sessions"] > 0
    loaded = [Path(p) for p in out["loaded"]]
    for path in ("reference/dense_lm.py", "drivers/serve.py", "traffic/closed_loop.py", "metrics/tokens_per_s.py",
                 "rooflines/attention.py"):
        assert copy / path in loaded, path
    assert all(p.is_relative_to(copy) for p in loaded), [p for p in loaded if not p.is_relative_to(copy)]
    assert "perfbench.reference.common" in out["modules"]  # imported by dense_lm.py's relative import
    assert all(Path(f).is_relative_to(copy) for f in out["modules"].values() if f), out["modules"]
    assert all(p.read_bytes() == b for p, b in before.items())
    assert out["per_token"] == 2 * (2 * 64 * (64 + 2 * 2 * 16) + 2 * 64 * 64 + 6 * 64 * 128)


def test_benchmark_json_names_match_the_files():
    bench = read_json(ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        assert read_json(ROOT / c["file"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (w["config"], w["traffic"], w["chips"], w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        own = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in own} and len(own) >= 2
        assert any(w["name"] in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:  # each cell that reads a per-layer metric reports what it moves
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


# ----------------------------------------------------------- imports
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_the_jax_package_or_its_benchmarks():
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    for path in HERE.rglob("*.py"):
        bad = {m for m in _imports(path)} & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
        assert not bad, f"{path} imports {bad}"


def test_the_references_import_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path
