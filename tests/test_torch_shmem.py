"""Port parity: the shared-memory transport, the device stage, the sanitizer.

* The verb conformance of the port's backends (``CollectiveComm`` and
  ``ShmemComm`` in both completion modes): each completes a verb or raises
  ``UnsupportedCapabilityError`` exactly as its capabilities say.
* The slab: payload bytes staged through the shared buffer (the same
  slab bytes as the reference's for the same posts), receiver-owned slot
  accounting with typed EAGAIN_BUFFER, EAGAIN_QUEUE on a full ring,
  signal-mode scanning, oversized posts, the named-segment backing closed.
* Fleet verb usage: requests two-sided, responses converging on the
  router's landing queue (by put iff capable); fleet channels sharing it.
* The device stage: one staged batch per progress drain, the delivered
  bytes and the stage counters those of the reference's ``stage='jax'``
  on the same posts; without a card it refuses unless asked for the CPU.
* The sanitizer: a seeded race reported as the reference reports it, and
  membership and shmem traffic under it with no race."""
import gc
import threading

import numpy as np
import pytest
import torch

from repro.analysis import sanitizer as j_sanitizer
from repro.core.comm.collective import CollectiveGroup as JCollectiveGroup
from repro.core.comm.shmem import ShmemGroup as JShmemGroup
from repro.core.completion import LCRQueue as JLCRQueue
from repro_torch.analysis import sanitizer
from repro_torch.core.comm import (
    CommChannel,
    CommInterface,
    PostStatus,
    ResourceLimits,
    UnsupportedCapabilityError,
)
from repro_torch.core.comm.collective import CollectiveGroup
from repro_torch.core.completion import LCRQueue
from repro_torch.core.comm.membership import Membership
from repro_torch.core.comm.shmem import DEFAULT_SLOTS, ShmemComm, ShmemGroup, live_segments, shmem_group_for


def _mk_collective():
    grp = CollectiveGroup(2)
    return grp.endpoint(0), grp.endpoint(1), None


def _mk_shmem(completion_mode):
    grp = ShmemGroup(2, completion_mode=completion_mode)
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp = LCRQueue()
    b.put_target_comp = LCRQueue()
    return a, b, b.put_target_comp


BACKENDS = {
    "collective": _mk_collective,
    "shmem_queue": lambda: _mk_shmem("queue"),
    "shmem_signal": lambda: _mk_shmem("signal"),
}


def _drive(*ends, rounds=50):
    for _ in range(rounds):
        if not any(e.progress() for e in ends):
            return


@pytest.mark.parametrize("name", sorted(BACKENDS))
def test_backend_verb_conformance_matrix(name):
    a, b, put_landing = BACKENDS[name]()
    assert isinstance(a, CommInterface) and isinstance(b, CommInterface)
    got, sent = LCRQueue(), LCRQueue()
    b.post_recv(-1, 7, got, ctx="rx")
    assert a.post_send(1, 0, 7, b"hello", sent, ctx="tx") is PostStatus.OK
    _drive(a, b)
    rec = got.reap()
    assert rec is not None and bytes(rec.data) == b"hello" and rec.src_rank == 0
    assert sent.reap() is not None
    if a.capabilities.one_sided_put:
        comp = LCRQueue()
        assert a.post_put_signal(1, 0, b"put-bytes", comp, ctx="put") is PostStatus.OK
        _drive(a, b)
        landed = put_landing.reap()
        assert landed is not None and landed.data == b"put-bytes" and landed.src_rank == 0
        assert comp.reap() is not None
    else:
        with pytest.raises(UnsupportedCapabilityError):
            a.post_put_signal(1, 0, b"put-bytes", LCRQueue())
    assert a.progress() in (True, False) and a.poll() in (True, False)
    assert b.progress() is False and b.poll() is False


@pytest.mark.parametrize("name, one_sided", [("collective", False), ("shmem_queue", True), ("shmem_signal", True)])
def test_matrix_capabilities_are_the_advertised_ladder(name, one_sided):
    a, _b, _ = BACKENDS[name]()
    assert a.capabilities.one_sided_put is one_sided


# ----------------------------------------------------------- slab mechanics
def test_put_bytes_genuinely_stage_through_shared_slab():
    grp = ShmemGroup(2, completion_mode="queue")
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp, b.put_target_comp = LCRQueue(), LCRQueue()
    payload = bytes(range(256)) * 4
    assert a.post_put_signal(1, 0, payload, LCRQueue()) is PostStatus.OK
    seg = grp.segments[(1, 0)]
    assert seg.pending()
    kind, src, src_dev, tag, stored = seg.read(0)
    assert stored == payload and src == 0
    b.progress()
    rec = b.put_target_comp.reap()
    assert rec.data == payload and rec.op == "put_recv"
    assert seg.free_slots() == grp.nslots


@pytest.mark.parametrize("mode", ["queue", "signal"])
def test_slab_bytes_equal_the_reference(mode):
    """The same puts and sends into the port's and the reference's groups
    leave the same bytes in the receiver's slab (header layout, state
    bytes, payloads) before the receiver runs."""
    lim = dict(recv_slots=8, bounce_buffer_size=512)
    grp = ShmemGroup(2, limits=ResourceLimits(**lim), completion_mode=mode)
    from repro.core.comm.resources import ResourceLimits as JLimits

    jgrp = JShmemGroup(2, limits=JLimits(**lim), completion_mode=mode)
    rng = np.random.default_rng(3)
    for g, q in ((grp, LCRQueue), (jgrp, JLCRQueue)):
        a = g.endpoint(0)
        g.endpoint(1).put_target_comp = q()
        a.put_target_comp = q()
        for i in range(3):
            data = rng.integers(0, 256, size=17 + 50 * i, dtype=np.uint8).tobytes()
            assert a.post_put_signal(1, 0, data, q())
        a.post_send(1, 0, 99, b"two-sided" * 3, q())
        a.progress()  # exchanges the send into the slab
        rng = np.random.default_rng(3)
    assert bytes(grp.segments[(1, 0)].buf) == bytes(jgrp.segments[(1, 0)].buf)


def test_put_slot_exhaustion_surfaces_eagain_buffer():
    grp = ShmemGroup(2, limits=ResourceLimits(recv_slots=2, bounce_buffer_size=1024), completion_mode="queue")
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp, b.put_target_comp = LCRQueue(), LCRQueue()
    assert grp.nslots == 2
    assert a.post_put_signal(1, 0, b"one", LCRQueue()) is PostStatus.OK
    assert a.post_put_signal(1, 0, b"two", LCRQueue()) is PostStatus.OK
    assert a.post_put_signal(1, 0, b"three", LCRQueue()) is PostStatus.EAGAIN_BUFFER
    assert grp.stats.backpressure_events == 1
    b.progress()
    assert a.post_put_signal(1, 0, b"three", LCRQueue()) is PostStatus.OK
    _drive(a, b)
    assert [b.put_target_comp.reap().data for _ in range(3)] == [b"one", b"two", b"three"]


def test_put_ring_exhaustion_surfaces_eagain_queue():
    grp = ShmemGroup(2, limits=ResourceLimits(send_queue_depth=1, bounce_buffer_size=1024), completion_mode="queue")
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp, b.put_target_comp = LCRQueue(), LCRQueue()
    assert a.capabilities.bounded_injection
    assert a.post_put_signal(1, 0, b"x", LCRQueue()) is PostStatus.OK
    assert a.post_put_signal(1, 0, b"y", LCRQueue()) is PostStatus.EAGAIN_QUEUE
    assert a.post_send(1, 0, 5, b"z", LCRQueue()) is PostStatus.EAGAIN_QUEUE
    a.progress()
    assert a.post_put_signal(1, 0, b"y", LCRQueue()) is PostStatus.OK


def test_signal_mode_discovers_puts_by_scanning():
    grp = ShmemGroup(2, completion_mode="signal")
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp, b.put_target_comp = LCRQueue(), LCRQueue()
    a.post_put_signal(1, 0, b"sig", LCRQueue())
    seg = grp.segments[(1, 0)]
    assert seg.pop_announced() is None
    assert seg.buf[0] == 2  # the raised signal in the shared state array
    b.progress()
    assert b.put_target_comp.reap().data == b"sig"


def test_oversized_message_rejected_with_valueerror():
    grp = ShmemGroup(2, limits=ResourceLimits(bounce_buffer_size=64))
    a = grp.endpoint(0)
    a.put_target_comp = LCRQueue()
    with pytest.raises(ValueError, match="slot capacity"):
        a.post_put_signal(1, 0, b"z" * 65, LCRQueue())
    with pytest.raises(ValueError, match="slot capacity"):
        a.post_send(1, 0, 3, b"z" * 65, LCRQueue())


def test_put_without_registered_target_is_uncapable():
    a = ShmemGroup(2).endpoint(0)
    assert not a.capabilities.one_sided_put
    with pytest.raises(UnsupportedCapabilityError):
        a.post_put_signal(1, 0, b"x", LCRQueue())


def test_shm_backing_roundtrip_and_explicit_close():
    gc.collect()  # a group and its endpoints form a cycle: earlier groups may wait for the collector
    segs0 = live_segments()
    grp = ShmemGroup(2, limits=ResourceLimits(recv_slots=4, bounce_buffer_size=256), backing="shm")
    assert live_segments() == segs0 + 2
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp, b.put_target_comp = LCRQueue(), LCRQueue()
    payload = b"\xa5" * 200
    assert a.post_put_signal(1, 0, payload, LCRQueue()) is PostStatus.OK
    b.progress()
    assert b.put_target_comp.reap().data == payload
    _drive(a, b)
    grp.close()
    grp.close()  # idempotent
    assert all(seg._closed for seg in grp.segments.values())
    assert live_segments() == segs0


def test_default_slot_count_and_one_group_per_owner():
    assert ShmemGroup(2).nslots == DEFAULT_SLOTS
    assert isinstance(ShmemGroup(2).endpoint(0), ShmemComm)

    class Owner:  # what the reference keys the group on: ranks and limits
        n_ranks, limits = 2, ResourceLimits(recv_slots=4)

    owner = Owner()
    g1 = shmem_group_for(owner, completion_mode="queue")
    assert shmem_group_for(owner, completion_mode="queue") is g1 and g1.nslots == 4
    with pytest.raises(AssertionError, match="one completion mode"):
        shmem_group_for(owner, completion_mode="signal")


# ------------------------------------------------------ fleet verb usage
@pytest.mark.parametrize("kind", ["collective", "shmem_queue", "shmem_signal"])
def test_fleet_verb_usage_conformance(kind):
    workers = 2
    grp = CollectiveGroup(1 + workers) if kind == "collective" else ShmemGroup(1 + workers, completion_mode=kind.split("_")[1])
    router, ws = grp.endpoint(0), [grp.endpoint(1 + w) for w in range(workers)]
    landing = LCRQueue()
    put_capable = kind != "collective"
    if put_capable:
        router.put_target_comp = landing
        for ep in ws:
            ep.put_target_comp = LCRQueue()
    assert all(ep.capabilities.one_sided_put is put_capable for ep in ws)
    req_cqs = []
    for w, ep in enumerate(ws):
        cq = LCRQueue()
        ep.post_recv(-1, 11, cq, ctx=f"request:{w}")
        req_cqs.append(cq)
        assert router.post_send(1 + w, 0, 11, b"req%d" % w, LCRQueue(), ctx="tx") is PostStatus.OK
    _drive(router, *ws)
    for w, cq in enumerate(req_cqs):
        rec = cq.reap()
        assert bytes(rec.data) == b"req%d" % w and rec.src_rank == 0 and rec.ctx == f"request:{w}"
    for w, ep in enumerate(ws):
        if put_capable:
            assert ep.post_put_signal(0, 0, b"resp%d" % w, LCRQueue(), ctx="tx") is PostStatus.OK
        else:
            with pytest.raises(UnsupportedCapabilityError):
                ep.post_put_signal(0, 0, b"resp%d" % w, LCRQueue())
            router.post_recv(-1, 12, landing, ctx="response")
            assert ep.post_send(0, 0, 12, b"resp%d" % w, LCRQueue(), ctx="tx") is PostStatus.OK
    _drive(router, *ws)
    got = {}
    while (rec := landing.reap()) is not None:
        got[rec.src_rank] = bytes(rec.data)
    assert got == {1 + w: b"resp%d" % w for w in range(workers)}


@pytest.mark.parametrize("transport", ["shmem", "collective"])
def test_fleet_channels_share_router_landing(transport):
    from repro_torch.configs import SMOKES
    from repro_torch.models import init_params
    from repro_torch.serve import Fleet, FleetConfig

    arch = SMOKES["tinyllama-1.1b"].variant(dtype="float32")
    fleet = Fleet(arch, init_params(torch.Generator().manual_seed(0), arch),
                  FleetConfig(workers=3, slots=3, context=64, transport=transport))
    try:
        shared = fleet.channels[0].response_cq
        for ch in fleet.channels:
            assert ch.response_cq is shared
            assert ch._put_responses == ch.server.capabilities.one_sided_put == (transport == "shmem")
        if transport == "shmem":
            with pytest.raises(AssertionError, match="landing"):
                CommChannel(backend=transport, group=fleet.group, client_rank=0, server_rank=1, response_cq=LCRQueue())
    finally:
        fleet.close()


def test_shmem_channel_responds_by_put():
    ch = CommChannel(backend="shmem")
    assert ch._put_responses and ch.server.capabilities.one_sided_put
    ch.send_request(b"req")
    ch.send_response(b"resp")
    for _ in range(3):
        ch.progress()
    recs = []
    while (rec := ch.reap("response")) is not None:
        recs.append((rec.op, bytes(rec.data) if rec.data is not None else None))
    assert ("put_recv", b"resp") in recs
    assert ch.group.stats.puts == 1


# ----------------------------------------------------------- device stage
POSTS = [b"alpha", bytes(range(200)), b"", b"\x00\xff" * 333, b"omega" * 7]


def _stage_run(group, queue_cls):
    """The POSTS from rank 0 to rank 1 in two drains (the first of 3 posts,
    the second of 2); returns the delivered payloads and the counters."""
    a, b = group.endpoint(0), group.endpoint(1)
    got = queue_cls()
    for _ in POSTS:
        b.post_recv(0, 4, got)
    for i, data in enumerate(POSTS):
        assert a.post_send(1, 0, 4, data, queue_cls())
        if i == 2:
            a.progress()
    a.progress()
    b.progress()
    out = []
    while (rec := got.reap()) is not None:
        out.append(bytes(rec.data))
    return out, group.stats.staged_batches, group.stats.staged_bytes


def test_device_stage_matches_the_reference_jax_stage():
    """One staged batch a drain, every byte staged once, and the delivered
    payloads those of the reference's stage='jax' on the same posts."""
    got, batches, nbytes = _stage_run(CollectiveGroup(2, stage="device", device="cpu"), LCRQueue)
    j_got, j_batches, j_nbytes = _stage_run(JCollectiveGroup(2, stage="jax"), JLCRQueue)
    assert got == j_got == POSTS
    assert (batches, nbytes) == (j_batches, j_nbytes) == (2, sum(len(p) for p in POSTS))
    assert _stage_run(CollectiveGroup(2), LCRQueue) == (POSTS, 0, 0)  # the loopback stages nothing


def test_device_stage_channel_round_trip_and_the_card_by_default():
    ch = CommChannel(stage="device", device="cpu")
    assert ch.group.device == torch.device("cpu")
    wire = np.random.default_rng(0).integers(0, 256, size=4096, dtype=np.uint8).tobytes()
    ch.send_request(wire)
    ch.send_response(wire[::-1])
    for _ in range(3):
        ch.progress()
    arrived = {}
    for source in ("request", "response"):
        while (rec := ch.reap(source)) is not None:
            if rec.op == "recv":
                arrived[source] = bytes(rec.data)
    assert arrived == {"request": wire, "response": wire[::-1]}
    assert ch.group.stats.staged_batches == 2 and ch.group.stats.staged_bytes == 2 * len(wire)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CommChannel(stage="device")


# -------------------------------------------------------------- sanitizer
@pytest.fixture
def sanitize():
    was = sanitizer.enabled()
    sanitizer.reset()
    sanitizer.enable(True)
    yield
    sanitizer.enable(was)
    sanitizer.reset()


def _seeded_race(mod):
    """Two threads write one location, each under a lock of its own: an
    empty candidate lockset on a shared write."""
    locks = [mod.make_lock("a"), mod.make_lock("b")]
    both = threading.Barrier(2)  # both alive at once: two distinct thread ids

    def writer(i):
        both.wait()
        with locks[i]:
            mod.note_access("Seeded.table", 7)
        both.wait()

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return mod.session_report()


def test_sanitizer_reports_a_seeded_race_as_the_reference_does(sanitize):
    report = _seeded_race(sanitizer)
    j_was = j_sanitizer.enabled()
    j_sanitizer.reset()
    j_sanitizer.enable(True)
    try:
        j_report = _seeded_race(j_sanitizer)
    finally:
        j_sanitizer.enable(j_was)
        j_sanitizer.reset()
    assert report["enabled"] and len(report["races"]) == 1
    race = report["races"][0]
    assert race["struct"] == "Seeded.table" and race["instance"] == 7 and len(race["threads"]) == 2
    assert [(r["struct"], r["instance"], len(r["threads"])) for r in j_report["races"]] == [("Seeded.table", 7, 2)]
    assert report["exercised"] == j_report["exercised"] == {"Seeded.table": 2}


def test_membership_and_shmem_traffic_run_clean_under_the_sanitizer(sanitize):
    m = Membership()
    grp = ShmemGroup(2, completion_mode="queue")
    a, b = grp.endpoint(0), grp.endpoint(1)
    a.put_target_comp, b.put_target_comp = LCRQueue(), LCRQueue()

    def churn(rank):
        for _ in range(20):
            m.join(rank)
            m.activate(rank)
            m.guard_post(rank)
            m.begin_drain(rank)
            m.finish_leave(rank)

    def traffic():
        for i in range(20):
            while not a.post_put_signal(1, 0, b"%d" % i, LCRQueue()):
                a.progress()
            b.progress()

    threads = [threading.Thread(target=churn, args=(r,)) for r in range(2)] + [threading.Thread(target=traffic)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _drive(a, b)
    report = sanitizer.session_report()
    assert report["races"] == []
    assert {"Membership._members", "ShmemSegment.slots", "ShmemSegment.rxq", "ShmemComm.send_ring"} <= set(report["exercised"])
