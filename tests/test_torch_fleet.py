"""Port parity: the serving fleet (router + workers over the comm layer).

* Rows of the port's ``decode_step`` are bit-identical at batch 1, 2, 4
  and 8 for every family (the fact the slot sharding stands on; the rows
  run in tiles of ``DECODE_TILE``).
* Token-stream equivalence: for ``tests/test_fleet.py``'s trace the port's
  1-router × 2-worker fleet over every transport (inline, collective,
  shmem), single-shot and with ``prefill_chunk=4``, emits exactly the JAX
  single-host server's streams, and the JAX fleet's.
* The reference's fleet properties, on the port: typed EAGAIN refusals
  re-queued with zero drops; routing by free-slot load; chunk stickiness;
  put selection by capabilities; one worker equals a single host;
  mid-decode and mid-prefill leaves bit-identical (tinyllama, and mamba2,
  whose SSM and conv state travels); join/leave cycles with threads and
  live segments flat; an abandoned worker swept and its rank reused; the
  leave edge cases; admission cost flat in the slot count; a starved
  prefilling slot holding its row; the launcher's fleet line."""
import gc
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import init_params as j_init_params
from repro.serve import Fleet as JFleet
from repro.serve import FleetConfig as JFleetConfig
from repro.serve import InferenceServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.core.comm.membership import GONE
from repro_torch.core.comm.resources import ResourceLimits
from repro_torch.core.comm.shmem import live_segments
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models.model import DECODE_TILE
from repro_torch.serve import DecodeCore, Fleet, FleetConfig, InferenceServer, Request, ServeConfig

torch.set_num_threads(1)

TRACE = [
    ([1, 2, 3], 4),
    ([4, 5], 5),
    ([6, 7, 8, 9, 10, 11, 12, 13, 14], 6),
    ([2, 2], 4),
    ([9, 1, 4], 5),
    ([7, 7, 7, 7, 7, 7], 6),
]
TRANSPORTS = ["inline", "collective", "shmem"]
FAMILIES = ["tinyllama-1.1b", "mamba2-130m", "zamba2-1.2b", "deepseek-moe-16b", "minicpm3-4b",
            "internvl2-76b", "llama4-scout-17b-a16e", "whisper-large-v3"]


def _pair(name):
    jcfg = J_SMOKES[name].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, SMOKES[name].variant(dtype="float32"), params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def model():
    return _pair("tinyllama-1.1b")


@pytest.fixture(scope="module")
def ssm_model():
    return _pair("mamba2-130m")


def _streams(server, trace=TRACE):
    reqs = [server.submit(p, max_new=m) for p, m in trace]
    server.run_until_idle()
    assert all(r.done_event.is_set() for r in reqs), "a request was dropped"
    return [r.out_tokens for r in reqs]


def _jax_single(pair, chunk=0):
    jcfg, jp, _, _ = pair
    return _streams(JServer(jcfg, jp, JServeConfig(slots=4, context=64, transport="inline", prefill_chunk=chunk)))


@pytest.fixture(scope="module")
def jax_ref(model):
    return {0: _jax_single(model), 4: _jax_single(model, chunk=4)}


@pytest.fixture(scope="module")
def jax_fleet_ref(model):
    jcfg, jp, _, _ = model
    fleet = JFleet(jcfg, jp, JFleetConfig(workers=2, slots=4, context=64, transport="collective"))
    try:
        return _streams(fleet)
    finally:
        fleet.close()


def _run_fleet(pair, transport, workers=2, chunk=0, slots=4, **cfg_kw):
    _, _, tcfg, tp = pair
    fleet = Fleet(tcfg, tp, FleetConfig(workers=workers, slots=slots, context=64, transport=transport,
                                        prefill_chunk=chunk, **cfg_kw))
    try:
        return _streams(fleet), fleet
    finally:
        fleet.close()


# --------------------------------------------------------- batch invariance
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_rows_independent_of_batch_size(name):
    """A row's logits (and so its greedy continuation) are bit-identical at
    batch 1, 2, 4 and 8, and at 2 × DECODE_TILE rows — whatever shares
    the call, and wherever in the batch the row sits."""
    cfg = SMOKES[name].variant(dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    start = [3, 5, 7, 9, 11, 13, 2, 4, 6, 8, 10, 12, 14, 1, 15, 16]

    def run(tokens):
        b = len(tokens)
        cache = init_cache(cfg, b, 64, "cpu")
        toks, pos, out = torch.tensor(tokens)[:, None], torch.zeros(b, dtype=torch.long), []
        for _ in range(4):
            logits, cache = decode_step(params, cfg, toks, pos, cache)
            out.append(logits[:, 0])
            toks, pos = logits[:, 0].argmax(-1)[:, None], pos + 1
        return torch.stack(out, 1)

    with torch.inference_mode():
        ref = run(start[:8])
        for b in (1, 2, 4):
            assert torch.equal(run(start[:b]), ref[:b]), b  # bit-exact, not approximate
        assert torch.equal(run(start[:2 * DECODE_TILE])[:8], ref)
        assert torch.equal(run(start[:8][::-1]).flip(0), ref)  # the row's place in the tile


# ------------------------------------------------ stream equivalence vs JAX
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_fleet_token_stream_equivalence(model, jax_ref, jax_fleet_ref, transport):
    """Same trace, same tokens: the port fleet on every transport, the JAX
    single host and the JAX fleet."""
    out, fleet = _run_fleet(model, transport)
    assert out == jax_ref[0] == jax_fleet_ref
    assert all(w.core.tokens_out > 0 for w in fleet.workers)  # both workers served


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_fleet_chunked_prefill_equivalence(model, jax_ref, transport):
    """Prompts cross the wire in 4-token pieces, consumed interleaved with
    decode: the JAX single host's chunked streams, and no worker ever runs
    a single-shot prefill."""
    out, fleet = _run_fleet(model, transport, chunk=4)
    assert out == jax_ref[4]
    assert all(w.core.prefill_calls == 0 for w in fleet.workers)
    assert all(w.core.max_prefill_burst <= w.core.slots for w in fleet.workers)


def test_port_single_host_matches_jax_on_every_transport(model, jax_ref):
    _, _, tcfg, tp = model
    for transport in TRANSPORTS:
        for chunk in (0, 4):
            server = InferenceServer(tcfg, tp, ServeConfig(slots=4, context=64, transport=transport, prefill_chunk=chunk))
            assert _streams(server) == jax_ref[chunk], (transport, chunk)


def test_fleet_backpressure_eagain_requeues_never_drops(model, jax_ref):
    """An admission storm (tiny per-worker admission queue + bounded
    channel) surfaces typed EAGAIN refusals AND completes every request
    with the reference's streams — re-queue, never drop."""
    limits = ResourceLimits(send_queue_depth=1, bounce_buffers=1, bounce_buffer_size=4_096)
    out, fleet = _run_fleet(model, "collective", admission_depth=1, limits=limits)
    assert out == jax_ref[0]
    assert fleet.eagain_events > 0
    assert fleet.requeues == fleet.eagain_events
    assert fleet.completed == len(TRACE)
    assert sum(w.eagain_refusals for w in fleet.workers) == fleet.eagain_events


def test_fleet_backpressure_on_put_backend(model, jax_ref):
    """The same storm over the put-capable shmem backend: refusals ride
    the one-sided response path, streams unchanged."""
    out, fleet = _run_fleet(model, "shmem", admission_depth=1)
    assert out == jax_ref[0]
    assert fleet.eagain_events > 0
    assert fleet.completed == len(TRACE)


def test_fleet_routes_by_free_slot_load(model):
    """Both workers empty: 4 concurrent requests land 2 and 2 (ties to the
    lowest id)."""
    _, _, tcfg, tp = model
    fleet = Fleet(tcfg, tp, FleetConfig(workers=2, slots=4, context=64, transport="inline", admission_depth=4))
    try:
        reqs = [fleet.submit(p, max_new=m) for p, m in TRACE[:4]]
        fleet.step()
        assert [len(w.rids_seen) for w in fleet.workers] == [2, 2]
        assert [w.rids_seen for w in fleet.workers] == [[0, 2], [1, 3]]
        fleet.run_until_idle()
        assert all(r.done_event.is_set() for r in reqs)
    finally:
        fleet.close()


def test_fleet_chunk_stickiness(model):
    """Every follow-up chunk goes to the worker that admitted the first
    chunk: each rid admitted once, its whole prompt consumed there."""
    _, _, tcfg, tp = model
    fleet = Fleet(tcfg, tp, FleetConfig(workers=3, slots=3, context=64, transport="inline", prefill_chunk=2))
    try:
        reqs = [fleet.submit([i + 1] * 9, max_new=3) for i in range(6)]  # 9 tokens = 5 chunks
        fleet.run_until_idle()
        assert all(r.done_event.is_set() for r in reqs)
        admitted = {rid: w.wid for w in fleet.workers for rid in w.rids_seen}
        assert len(admitted) == len(reqs)
        assert [len(w.rids_seen) for w in fleet.workers] == [2, 2, 2]
        assert [len(r.out_tokens) for r in reqs] == [3] * 6
    finally:
        fleet.close()


def test_fleet_lifecycle_no_thread_or_segment_leak(model):
    """50 create/close cycles of a 4-worker shmem fleet leave the thread
    count and the live shmem-segment census flat."""
    _, _, tcfg, tp = model
    cfg = dict(workers=4, slots=4, context=64, transport="shmem")
    fleet = Fleet(tcfg, tp, FleetConfig(**cfg))
    r = fleet.submit([1, 2, 3], max_new=2)
    fleet.run_until_idle()
    assert r.done_event.is_set()
    fleet.close()
    gc.collect()  # servers of earlier tests may still hold segments
    threads0, segs0 = threading.active_count(), live_segments()
    for i in range(50):
        fleet = Fleet(tcfg, tp, FleetConfig(**cfg))
        if i % 10 == 0:
            req = fleet.submit([1, 2, 3], max_new=2)
            fleet.run_until_idle()
            assert req.done_event.is_set()
        fleet.close()
    assert threading.active_count() == threads0
    assert live_segments() == segs0


@pytest.mark.parametrize("transport,expect_puts", [("shmem", True), ("collective", False)])
def test_fleet_put_selection_follows_capabilities(model, transport, expect_puts):
    """Responses ride post_put_signal into the router-owned landing queue
    exactly when the backend advertises one_sided_put."""
    _, _, tcfg, tp = model
    fleet = Fleet(tcfg, tp, FleetConfig(workers=2, slots=4, context=64, transport=transport))
    try:
        for ch in fleet.channels:
            assert ch._put_responses == ch.server.capabilities.one_sided_put == expect_puts
        reqs = [fleet.submit(p, max_new=m) for p, m in TRACE[:3]]
        fleet.run_until_idle()
        assert all(r.done_event.is_set() for r in reqs)
        assert (fleet.group.stats.puts > 0) == expect_puts
    finally:
        fleet.close()


def test_admission_cost_flat_in_slot_count(model):
    """Admitting one request does not pay for the other slots: the port
    copies the prefilled one-slot cache into its row in place (the JAX
    package's donated, jitted splice), so admission at 32 slots stays well
    under the ~16x a whole-cache rebuild would cost against 2 slots."""
    _, _, tcfg, tp = model

    def admit_time(slots):
        core = DecodeCore(tcfg, tp, slots=slots, context=64)
        sink = lambda *a: None  # noqa: E731
        # max_new=1 finishes at the prefill, freeing the slot, so repeated
        # admissions time the admission path alone
        core.admit(Request(rid=0, prompt=[1, 2, 3], max_new=1), sink)
        best = float("inf")
        for rep in range(5):
            t0 = time.perf_counter()
            core.admit(Request(rid=rep + 1, prompt=[1, 2, 3], max_new=1), sink)
            best = min(best, time.perf_counter() - t0)
        return best

    t_small, t_big = admit_time(2), admit_time(32)
    assert t_big < 6 * t_small, f"admission scaled with slot count: {t_big * 1e3:.2f}ms @32 vs {t_small * 1e3:.2f}ms @2"


def test_fleet_single_worker_degenerates_to_single_host(model, jax_ref):
    out, _ = _run_fleet(model, "collective", workers=1)
    assert out == jax_ref[0]


# -------------------------------------------------------- the elastic fleet
def _leave_mid_decode(pair, transport, steps=3, chunk=0):
    _, _, tcfg, tp = pair
    fleet = Fleet(tcfg, tp, FleetConfig(workers=2, slots=4, context=64, transport=transport,
                                        prefill_chunk=chunk, max_workers=3))
    try:
        reqs = [fleet.submit(p, max_new=m) for p, m in TRACE]
        for _ in range(steps):
            fleet.step()
        fleet.add_worker()  # the successor joins on the spare rank...
        assert fleet.leave_worker(0) is True  # ...and worker 0 drains out
        fleet.run_until_idle()
        assert all(r.done_event.is_set() for r in reqs), "leave dropped a request"
        fleet.adopted = sum(w.adoptions for w in fleet.workers if w is not None)
        return [r.out_tokens for r in reqs], fleet
    finally:
        fleet.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_fleet_mid_decode_leave_bit_identical(model, jax_ref, transport):
    """A worker leaves MID-DECODE; its slots travel to a successor as
    checkpoint.snapshot bytes over the existing channel, and every stream
    stays bit-identical to the JAX single host's."""
    out, fleet = _leave_mid_decode(model, transport)
    assert out == jax_ref[0]
    assert fleet.completed == len(TRACE)
    assert fleet.handoffs >= 1 and fleet.handoff_bytes > 0
    assert (fleet.joins, fleet.leaves) == (1, 1)
    assert fleet.membership.state(0) == GONE
    assert fleet.adopted == fleet.handoffs


@pytest.mark.parametrize("transport", ["inline", "collective"])
def test_fleet_mid_prefill_leave_chunked(model, jax_ref, transport):
    """A leave while chunked prefill still streams: the snapshot carries
    the open prefill queue, sticky routing re-points to the adopter, and a
    chunk that outran the splice is stashed."""
    out, fleet = _leave_mid_decode(model, transport, steps=1, chunk=4)
    assert out == jax_ref[4]
    assert fleet.completed == len(TRACE)


@pytest.mark.parametrize("transport,chunk", [("collective", 0), ("shmem", 0), ("collective", 4)])
def test_mamba2_fleet_hands_off_ssm_and_conv_state(ssm_model, transport, chunk):
    """The SSM family: a leaving worker's slots carry their SSM and conv
    state (no position-addressed cache to rewrite), and the streams stay
    the JAX single host's."""
    ref = _jax_single(ssm_model, chunk=chunk)
    out, fleet = _leave_mid_decode(ssm_model, transport, steps=3, chunk=chunk)
    assert out == ref
    assert fleet.handoffs >= 1
    core = DecodeCore(ssm_model[2], ssm_model[3], 2, 64)
    assert set(core.abstract_slot_state()) == {"ssm"}
    assert set(core.abstract_slot_state()["ssm"]) == {"ssm", "conv"}


def test_fleet_join_leave_cycles_threads_segments_flat(model):
    """25 join/leave cycles against a live shmem fleet: the spare rank's
    channel and slab are REUSED every cycle, so threads and live segments
    never move."""
    _, _, tcfg, tp = model
    fleet = Fleet(tcfg, tp, FleetConfig(workers=2, slots=4, context=64, transport="shmem", max_workers=3))
    try:
        wid = fleet.add_worker()
        fleet.leave_worker(wid)
        r = fleet.submit([1, 2, 3], max_new=2)
        fleet.run_until_idle()
        assert r.done_event.is_set()
        gc.collect()  # servers of earlier tests may still hold segments
        threads0, segs0 = threading.active_count(), live_segments()
        ranks = set()
        for i in range(25):
            ranks.add(fleet.add_worker())
            if i % 5 == 0:
                fleet.submit([2, 3, 4], max_new=2)
            fleet.leave_worker(2)
            fleet.run_until_idle()
            assert threading.active_count() == threads0
            assert live_segments() == segs0
        assert ranks == {2}
        assert fleet.joins == 26 and fleet.leaves == 26
        assert fleet.completed == 6
    finally:
        fleet.close()


def test_fleet_abandoned_worker_swept_and_rank_reused(model):
    """A worker that dies WITHOUT leave() is reaped by the membership
    finalizer sweep; its rank returns to the pool and the fleet serves."""
    _, _, tcfg, tp = model
    fleet = Fleet(tcfg, tp, FleetConfig(workers=2, slots=4, context=64, transport="inline", max_workers=3))
    try:
        w = fleet.workers[1]
        fleet.workers[1] = None
        del w
        gc.collect()
        assert fleet.membership.sweep() == [1]
        assert fleet.membership.state(1) == GONE
        assert fleet.membership.active_ranks() == (0,)
        assert fleet.add_worker() == 1
        r = fleet.submit([1, 2, 3], max_new=2)
        fleet.run_until_idle()
        assert r.done_event.is_set()
    finally:
        fleet.close()


def test_fleet_leave_edge_cases(model):
    """Double leave is idempotent; the last active worker may not leave; a
    full fleet refuses further joins."""
    _, _, tcfg, tp = model
    fleet = Fleet(tcfg, tp, FleetConfig(workers=2, slots=4, context=64, transport="inline", max_workers=2))
    try:
        assert fleet.leave_worker(1) is True
        assert fleet.leave_worker(1) is False
        with pytest.raises(ValueError, match="last active"):
            fleet.leave_worker(0)
        assert fleet.add_worker() == 1
        with pytest.raises(ValueError, match="max_workers"):
            fleet.add_worker()
    finally:
        fleet.close()


# ------------------------------------------------------- the decode core
@pytest.mark.parametrize("pair_name", ["model", "ssm_model"])
def test_starved_prefilling_slot_holds_its_row(pair_name, request):
    """A prefilling slot whose chunks lag re-feeds its last token and holds
    its position; its cache row (K/V, SSM and conv state) is put back, so
    the stream equals the one whose chunks never lagged."""
    _, _, tcfg, tp = request.getfixturevalue(pair_name)
    prompt, max_new = [6, 7, 8, 9, 10, 11, 12, 13, 14], 5

    def run(stall):
        core = DecodeCore(tcfg, tp, slots=2, context=64, prefill_chunk=4)
        out = []
        emit = lambda req, tok, done: out.append(tok)  # noqa: E731
        core.admit(Request(rid=0, prompt=prompt[:4], max_new=max_new), emit, more_chunks=True)
        core.admit(Request(rid=1, prompt=[1, 2, 3], max_new=8), lambda *a: None)  # a decoding neighbour
        for _ in range(4 + stall):  # the first chunk, then `stall` starved steps
            core.step(emit)
        assert core.prefilling(0)
        core.feed_chunk(0, prompt[4:], last=True)
        while len(out) < max_new:
            core.step(emit)
        return out

    assert run(stall=3) == run(stall=0)


def test_extract_and_adopt_slot_round_trip_through_snapshot(model):
    """extract_slot → pack_state → unpack_state(abstract=) → adopt_slot on
    another core continues the stream bit-identically."""
    from repro_torch.checkpoint.snapshot import pack_state, unpack_state

    _, _, tcfg, tp = model
    a, b = DecodeCore(tcfg, tp, slots=2, context=64), DecodeCore(tcfg, tp, slots=3, context=64)
    ref_core = DecodeCore(tcfg, tp, slots=2, context=64)
    out, ref = [], []
    a.admit(Request(rid=0, prompt=[4, 5, 6], max_new=8), lambda r, t, d: out.append(t))
    ref_core.admit(Request(rid=0, prompt=[4, 5, 6], max_new=8), lambda r, t, d: ref.append(t))
    for _ in range(3):
        a.step(lambda r, t, d: out.append(t))
    state, meta = a.extract_slot(a.active_slots()[0])
    assert not a.active()
    b.admit(Request(rid=9, prompt=[1], max_new=20), lambda *x: None)  # occupy slot 0 of the adopter
    got, meta2 = unpack_state(pack_state(state, meta), abstract=b.abstract_slot_state())
    assert meta2 == meta
    assert b.adopt_slot(got, meta2) == 1
    while len(out) < 8:
        b.step(lambda r, t, d: out.append(t) if r.rid == 0 else None)
    while ref_core.active():
        ref_core.step(lambda r, t, d: ref.append(t))
    assert out == ref


def test_launcher_runs_the_fleet_on_the_cpu(capsys):
    assert serve_main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--workers", "2", "--transport", "shmem",
                       "--requests", "4", "--clients", "2", "--max-new", "3", "--prompt-len", "5"]) == 0
    line = capsys.readouterr().out
    assert "requests=4/4" in line and "tier=fleet(workers=2) eagain=" in line and "transport=shmem" in line
