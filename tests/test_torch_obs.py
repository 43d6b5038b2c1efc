"""The port's tracer (``repro_torch.obs``) and the spans the server records.

* A smoke-size server over each transport records the engine's spans with
  their parents, the prefill's rid, and each request's queue wait and
  first-token hold.
* ``DecodeCore``'s counters are the sums of its spans.
* Without a profiler no ``record_function`` is made; under one every span
  is ``profiled`` and has a ``repro::`` host range that starts with it on
  the tracer's clock.
* The ring keeps :data:`obs.CAPACITY` records and counts the dropped ones.
* On a card (``gpu``): ``decode_step`` syncs nothing with the host, and
  every kernel it launches lies inside a ``repro::`` range on the card.

Imports no jax: on a machine without JAX run it with ``--noconftest``."""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import SMOKES
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.serve import InferenceServer, ServeConfig

NAME, START, END, PARENT, RID, PROFILED = range(6)
PROMPTS = [([1, 2, 3], 3), ([4, 5], 4), ([6, 7, 8, 9, 10], 2), ([2, 2], 1), ([9, 1, 4], 3), ([7, 7, 7, 7], 2)]


@pytest.fixture(scope="module")
def model():
    arch = SMOKES["deepseek-moe-16b"].variant(dtype="float32")
    return arch, init_params(torch.Generator().manual_seed(0), arch)


def _server(model, transport, chunk=0):
    arch, params = model
    return InferenceServer(arch, params, ServeConfig(slots=4, context=48, max_prefill=16, transport=transport,
                                                      prefill_chunk=chunk))


def _serve(server, prompts=PROMPTS):
    reqs = [server.submit(p, n) for p, n in prompts]
    server.run_until_idle()
    assert all(len(r.out_tokens) == n for r, (_, n) in zip(reqs, prompts))
    return reqs


@pytest.mark.parametrize("transport,chunk", [("inline", 0), ("collective", 0), ("collective", 2)])
def test_server_records_its_spans_with_parents_and_rids(model, transport, chunk):
    server = _server(model, transport, chunk)
    obs.clear()
    reqs = _serve(server)
    recs, dropped = obs.spans()
    assert dropped == 0
    by_start = {r[START]: r for r in recs if not r[NAME].startswith("request.")}
    names = Counter(r[NAME] for r in recs)
    engine = {"engine.step", "admit", "decode.dispatch", "decode.sync"}
    engine |= {"prefill"} if not chunk else set()
    engine |= {"handoff", "flush"} if transport != "inline" else set()
    assert set(names) == engine | {"request.queue", "request.hold"}
    parent_of = {"handoff": "engine.step", "admit": "engine.step", "decode.dispatch": "engine.step",
                 "decode.sync": "engine.step", "flush": "engine.step", "prefill": "admit"}
    for r in recs:
        assert not r[PROFILED]
        assert r[START] <= r[END]
        if r[NAME] in parent_of:
            assert by_start[r[PARENT]][NAME] == parent_of[r[NAME]], r
        else:
            assert r[PARENT] is None, r
        assert (r[RID] is not None) == (r[NAME] in ("prefill", "request.queue", "request.hold")), r
    rids = {r.rid for r in reqs}
    for kind in ("request.queue", "request.hold"):
        got = [r[RID] for r in recs if r[NAME] == kind]
        assert sorted(got) == sorted(rids), kind  # one interval a request
    if not chunk:
        assert names["prefill"] == len(reqs)
        pre = {r[RID]: r for r in recs if r[NAME] == "prefill"}
        for r in recs:
            if r[NAME] == "request.queue":  # arrival to the start of the prefill
                assert r[END] == pre[r[RID]][START]
            if r[NAME] == "request.hold":  # first token computed to its hand-over
                assert r[START] == pre[r[RID]][END]
    # the client's timestamps are on the tracer's clock: submitted by the
    # arrival, the first token in hand from its hand-over
    queue = {r[RID]: r for r in recs if r[NAME] == "request.queue"}
    hold = {r[RID]: r for r in recs if r[NAME] == "request.hold"}
    for q in reqs:
        assert q.submitted_at <= queue[q.rid][START] * 1e-9
        assert hold[q.rid][END] * 1e-9 <= q.first_token_at <= q.finished_at <= obs.now()


@pytest.mark.parametrize("transport", ["inline", "collective"])
def test_counters_are_the_sums_of_the_spans(model, transport):
    server = _server(model, transport)
    core = server.core
    for p, _ in PROMPTS:  # six requests over four slots: prefills between decode steps
        server.submit(p, 6)
    checked = 0
    for _ in range(40):
        obs.clear()
        pre, dec = core.prefill_seconds, core.decode_seconds
        server.step()
        recs, _ = obs.spans()
        span_s = lambda *names: sum(r[END] - r[START] for r in recs if r[NAME] in names) * 1e-9  # noqa: E731
        assert core.decode_seconds - dec == pytest.approx(span_s("decode.dispatch", "decode.sync"), rel=1e-9, abs=1e-15)
        assert core.prefill_seconds - pre == pytest.approx(span_s("prefill"), rel=1e-9, abs=1e-15)
        disp = [r for r in recs if r[NAME] == "decode.dispatch"]
        sync = [r for r in recs if r[NAME] == "decode.sync"]
        assert len(disp) == len(sync) <= 1
        if disp:  # one boundary, one clock read
            assert disp[0][END] == sync[0][START]
            checked += 1
        if server.idle():
            break
    assert checked > 3 and server.idle()


def test_without_a_profiler_no_range_is_made(model, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert obs.range("mixer") is obs.range("logits")  # one shared no-op
    server = _server(model, "collective")
    obs.clear()
    _serve(server)
    recs, _ = obs.spans()
    assert recs and not any(r[PROFILED] for r in recs)
    assert made == []


def test_profiled_spans_carry_ranges_on_the_tracer_clock(model):
    server = _server(model, "collective")
    for p, n in PROMPTS[:3]:
        server.submit(p, 6)
    with profile(activities=[ProfilerActivity.CPU]):  # the first record_function of a process loads its op
        server.step()
    server.step()
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            server.step()
    server.step()
    recs, _ = obs.spans()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    host = Counter()
    starts = {}
    for e in prof.events():
        if e.name.startswith("repro::"):
            host[e.name] += 1
            starts.setdefault(e.name[len("repro::"):], []).append(obs.from_profiler_ns(t0 + round(e.time_range.start * 1e3)))
    assert {"repro::mixer", "repro::channel", "repro::moe.experts", "repro::attn.attend", "repro::logits"} <= set(host)
    last = max(r[START] for r in recs if r[NAME] == "engine.step")  # the step after the session
    calls = [r for r in recs if not r[NAME].startswith("request.")]  # an interval is not a call: no range
    during = [r for r in calls if r[START] < last]
    assert {r[NAME] for r in during} >= {"engine.step", "handoff", "admit", "decode.dispatch", "decode.sync", "flush"}
    assert all(r[PROFILED] for r in during)
    assert not any(r[PROFILED] for r in calls if r[START] >= last)
    for r in during:
        gap = min(abs(t - r[START]) for t in starts[r[NAME]])
        assert gap < 100_000, (r, gap)  # within 100 µs


def test_ring_keeps_its_capacity_and_counts_the_dropped():
    obs.clear()
    for i in range(obs.CAPACITY + 10):
        obs.interval("request.queue", i, i, i + 1)
    recs, dropped = obs.spans()
    assert len(recs) == obs.CAPACITY and dropped == 10
    assert recs[0][RID] == 10 and recs[-1][RID] == obs.CAPACITY + 9  # the oldest went first
    obs.clear()
    assert obs.spans() == ([], 0)


@pytest.mark.gpu
def test_cuda_decode_step_syncs_nothing_and_its_kernels_lie_in_ranges():
    """The model call alone, on inputs already on the card, under the sync
    debug mode's ``error``; then, in a profiled call, every device record
    lies inside the card-side span of a ``repro::`` range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType

    arch = SMOKES["deepseek-moe-16b"].variant(dtype="bfloat16")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    cache = init_cache(arch, 8, 64, "cuda")
    toks = torch.arange(3, 11, device="cuda")[:, None]
    pos = [torch.arange(8, device="cuda") + 8 * i for i in range(3)]  # made before: the calls alone are judged
    with torch.inference_mode():
        decode_step(params, arch, toks, pos[0], cache)  # builds the kernels
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode_step(params, arch, toks, pos[1], cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode_step(params, arch, toks, pos[2], cache)
            torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [(e.time_range.start, e.time_range.end) for e in dev if e.is_user_annotation and e.name.startswith("repro::")]
    work = [e for e in dev if not e.is_user_annotation]
    assert ranges and work
    outside = [e.name for e in work if not any(s <= e.time_range.start and e.time_range.end <= t for s, t in ranges)]
    assert outside == []
