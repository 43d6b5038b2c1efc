"""Port parity: the eager/rendezvous protocol engine, injection
backpressure and threshold-aware aggregation.

* ``tests/test_protocol_engine.py`` and ``tests/test_agg_threshold.py`` on
  ``repro_torch.core``: the eager wire format, the crossover around
  ``eager_threshold``, retry under a bounded fabric, aggregation × eager
  on every variant, the reserved-bit aggregate sub-ids, the threshold-
  aware drain.  Where a check reads counters, it also reads the
  reference's on the same run.
* The decision-trace oracle: ``tests/test_progress_engine.py``'s
  ``functional_trace`` (the shared engine's ordered record of protocol
  path, header kind, follow-ups and deliveries), run in both packages on
  every single-threaded variant, gives the same trace; in the port the
  ``collective`` trace equals ``sendrecv_queue``'s and the shared-memory
  ladder's its LCI twins'; a bounded ``collective`` world backpressures
  and delivers."""
from collections import deque

import pytest

from repro.core import harness as jharness
from repro.core import variants as jvariants
from repro.core.parcelport import World as JWorld
from repro_torch.core import harness as tharness
from repro_torch.core.comm.resources import ResourceLimits
from repro_torch.core.fabric import Fabric, RegisteredBufferPool
from repro_torch.core.harness import deliver_payloads, transport_stats
from repro_torch.core.lci_parcelport import LCIParcelport, LCIPPConfig
from repro_torch.core.parcel import (
    Chunk,
    Parcel,
    decode_header,
    eager_wire_size,
    encode_eager,
    serialize_action,
)
from repro_torch.core.parcelport import (
    AGG_PER_PARCEL_BYTES,
    AGG_PREAMBLE_BYTES,
    AGG_SUB_SHIFT,
    World,
    aggregate_parcels,
    aggregate_projected_bytes,
    split_aggregate,
)
from repro_torch.core.variants import VARIANTS, make_parcelport_factory, max_devices, variant_names

# tests/test_progress_engine.py's sizes, away from every threshold: 64 B
# (eager / piggyback), 12 KiB (rendezvous at 8 KiB thresholds, eager at
# 16 KiB), 40 KiB (rendezvous with one follow-up everywhere)
PARITY_SIZES = (64, 12_000, 40_000)
SMOKE_PAYLOAD_SIZES = (8, 600, 3_000, 12_000, 40_000)


def single_threaded(name: str) -> bool:
    if name in ("mpi", "mpi_a"):
        return True
    cfg = VARIANTS[name]
    return cfg.progress_workers == 0 and cfg.elastic_progress is None


SINGLE = [n for n in variant_names() if single_threaded(n)]


def functional_trace(variant, sizes=PARITY_SIZES, pkg="port", zero_copy_threshold=1 << 30) -> list:
    """``tests/test_progress_engine.py``'s functional_trace in ``pkg``: the
    world runs sequentially (a drain after each send) and returns the
    engine's ordered decision trace."""
    mk_world, factory, devs = ((World, make_parcelport_factory, max_devices) if pkg == "port"
                               else (JWorld, jvariants.make_parcelport_factory, jvariants.max_devices))
    world = mk_world(2, factory(variant), devices_per_rank=devs(variant))
    try:
        tr: list = []
        for loc in world.localities:
            loc.parcelport.engine.trace = tr
        got: list = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for s in sizes:
            world.localities[0].async_action(1, "sink", bytes([s % 251]) * s, zero_copy_threshold=zero_copy_threshold)
            world.drain(max_rounds=50_000)
        assert len(got) == len(sizes)
        return tr
    finally:
        world.close()


# --------------------------------------------------------- the trace oracle
@pytest.mark.parametrize("variant", SINGLE)
def test_decision_trace_equals_the_reference(variant):
    port = functional_trace(variant)
    assert port == functional_trace(variant, pkg="ref")
    assert sum(e[1] for e in port if e[0] == "deliver") == len(PARITY_SIZES)


@pytest.mark.parametrize("variant", ["lci", "mpi", "sendrecv_queue", "lci_agg_eager", "collective", "shmem_putq"])
def test_decision_trace_with_zero_copy_chunks_equals_the_reference(variant):
    """The smoke sizes with zero-copy chunks (8 KiB threshold): the port's
    6 longer nzc bytes a parcel flip no decision at these sizes."""
    port = functional_trace(variant, SMOKE_PAYLOAD_SIZES, zero_copy_threshold=8 * 1024)
    assert port == functional_trace(variant, SMOKE_PAYLOAD_SIZES, pkg="ref", zero_copy_threshold=8 * 1024)


def test_parity_trace_shape():
    tr = functional_trace("lci")
    sends = [e for e in tr if e[0] == "send"]
    assert sends[0] == ("send", "eager", 0)  # 64 B
    assert sends[1] == ("send", "rdv", 1)  # 12 KiB > 8 KiB piggyback
    assert sends[2] == ("send", "rdv", 1)  # 40 KiB
    assert tr.count(("deliver", 1)) == len(PARITY_SIZES)
    assert tr.count(("chunk",)) == 2
    tr_agg = functional_trace("lci_agg_eager")
    assert [e for e in tr_agg if e[0] == "send"][1][1] == "eager"  # 16 KiB threshold: 12 KiB rides eager
    assert all(e[1] == "rdv" for e in functional_trace("mpi") if e[0] == "send")


def test_collective_trace_equals_sendrecv_queue():
    """The collective transport replays the LCI backend's two-sided trace
    bit for bit (``benchmarks/run.py``'s parity pair, on the port), and
    the shared-memory ladder its LCI twins'."""
    assert functional_trace("collective") == functional_trace("sendrecv_queue")
    assert functional_trace("collective", SMOKE_PAYLOAD_SIZES, zero_copy_threshold=1024) == functional_trace(
        "sendrecv_queue", SMOKE_PAYLOAD_SIZES, zero_copy_threshold=1024)
    assert functional_trace("shmem") == functional_trace("sendrecv_queue")
    assert functional_trace("shmem_put") == functional_trace("lci")
    assert functional_trace("shmem_putq") == functional_trace("lci")


@pytest.mark.parametrize("variant", ["collective_prg2", "lci_prg2", "shmem_prg2", "lci_eprg0_2"])
def test_threaded_variants_deliver_and_trace_every_parcel(variant):
    """Real progress threads: the order is the scheduler's, the deliveries
    are not."""
    tr = functional_trace(variant)
    assert sum(e[1] for e in tr if e[0] == "deliver") == len(PARITY_SIZES)
    assert sorted(e for e in tr if e[0] == "send") == sorted(
        e for e in functional_trace(variant, pkg="ref") if e[0] == "send")


def test_bounded_collective_backpressures_and_delivers():
    lim = ResourceLimits(send_queue_depth=2, bounce_buffers=2, bounce_buffer_size=65_536)
    payloads = [bytes([s % 251]) * s for s in SMOKE_PAYLOAD_SIZES]
    world, got = deliver_payloads("collective", payloads, fabric_kwargs={"limits": lim}, max_rounds=50_000)
    try:
        assert sorted(bytes(a[0]) for a in got) == sorted(payloads)
        group = world.fabric._collective_group
        assert group.limits is lim and transport_stats(world) is group.stats
        assert group.stats.backpressure_events > 0
        assert all(loc.parcelport.retry_queue_depth() == 0 for loc in world.localities)
    finally:
        world.close()
    jworld, _ = jharness.deliver_payloads("collective", payloads, fabric_kwargs={"limits": lim}, max_rounds=50_000)
    try:
        assert jharness.transport_stats(jworld).backpressure_events == group.stats.backpressure_events
    finally:
        jworld.close()


# ------------------------------------------------------- eager wire format
def test_eager_encode_decode_roundtrip():
    p = serialize_action(7, 0, 1, "act", (b"meta", b"z" * 4000), zero_copy_threshold=1024)
    assert p.num_zc == 1
    wire = encode_eager(p, device_index=1)
    assert len(wire) == eager_wire_size(p)
    h = decode_header(wire)
    assert h.is_eager and h.num_followups == 0
    assert h.parcel_id == 7 and h.device_index == 1
    assert h.piggybacked_nzc == p.nzc_chunk.data
    assert h.inline_zc == [p.zc_chunks[0].data]


def _both_stats(variant, payloads, **kw):
    out = []
    for harness in (jharness, tharness):
        world, got = harness.deliver_payloads(variant, payloads, **kw)
        try:
            st = world.fabric.stats
            out.append((sorted(bytes(a[0]) for a in got), st.messages, st.eager_msgs, st.rendezvous_msgs,
                        st.backpressure_events, [loc.parcelport.retry_queue_depth() for loc in world.localities]))
        finally:
            world.close()
    return out


@pytest.mark.parametrize("size", [100, 2_000, 14_000, 15_500, 17_000, 60_000])
def test_eager_rendezvous_crossover(size):
    ref, port = _both_stats("lci_eager", [bytes([size % 251]) * size])
    assert port == ref
    _, messages, eager, rdv, _, _ = port
    if size <= 15_500:
        assert eager >= 1 and rdv == 0
    elif size >= 17_000:
        assert eager == 0 and rdv >= 2


def test_eager_fewer_fabric_messages_than_noeager():
    payloads = [bytes([i]) * 4_000 for i in range(8)]  # zc chunks at a 1 KiB threshold
    e_ref, e = _both_stats("lci_eager", payloads)
    p_ref, p = _both_stats("lci_noeager", payloads)
    assert (e, p) == (e_ref, p_ref)
    assert e[1] < p[1]
    assert e[1] == len(payloads)  # one message each
    assert p[1] == 2 * len(payloads)  # header + zc


def test_eager_threshold_zero_forces_rendezvous():
    ref, port = _both_stats("lci_noeager", [b"x" * 50])
    assert port == ref and port[2] == 0 and port[3] >= 1


def test_eager_respects_bounce_buffer_capacity():
    ref, port = _both_stats("lci_eager_64k", [b"q" * 30_000],
                            fabric_kwargs=dict(bounce_buffers=4, bounce_buffer_size=8_192))
    assert port == ref
    assert port[0] == [b"q" * 30_000] and port[2] == 0  # didn't fit a bounce buffer


# --------------------------------------------------------- backpressure
def test_backpressure_retry_tiny_send_queue():
    ref, port = _both_stats("lci", [bytes([i % 256]) * 64 for i in range(150)],
                            fabric_kwargs=dict(send_queue_depth=2, bounce_buffers=2, bounce_buffer_size=16_384))
    assert port == ref
    assert len(port[0]) == 150 and port[4] > 0 and port[5] == [0, 0]


def test_backpressure_rendezvous_followups():
    ref, port = _both_stats("lci_noeager", [b"B" * 40_000 for _ in range(20)], fabric_kwargs=dict(send_queue_depth=1))
    assert port == ref
    assert len(port[0]) == 20 and port[4] > 0


def test_eager_sendrecv_wire_overhead_vs_bounce_capacity():
    """Every size in the band where the 8-byte tag decides whether an
    eager frame fits the bounce buffer delivers, as in the reference."""
    for size in range(3_980, 4_080, 8):
        ref, port = _both_stats("sendrecv_queue", [b"q" * size],
                                fabric_kwargs=dict(bounce_buffers=4, bounce_buffer_size=4_096))
        assert port == ref
        assert port[0] == [b"q" * size] and port[5] == [0, 0]


@pytest.mark.parametrize("variant", ["mpi", "mpi_a"])
def test_mpi_bounded_fabric_delivers_all(variant):
    ref, port = _both_stats(variant, [bytes([i]) * 64 for i in range(10)], fabric_kwargs=dict(send_queue_depth=1))
    assert port == ref
    assert len(port[0]) == 10 and port[4] > 0


def test_drain_raises_on_undeliverable_parked_post():
    world = World(2, make_parcelport_factory("lci"), devices_per_rank=2)
    try:
        world.localities[0].parcelport._retry_q.append(lambda: False)
        with pytest.raises(RuntimeError, match="parked"):
            world.drain()
    finally:
        world.localities[0].parcelport._retry_q.clear()
        world.close()


def test_bounce_pool_recycles():
    pool = RegisteredBufferPool(2, 1024)
    a = pool.acquire(100)
    b = pool.acquire(1024)
    assert a is not None and b is not None
    assert pool.acquire(1) is None  # exhausted
    assert pool.acquire(2048) is None  # never fits
    pool.release(a)
    assert pool.free_count() == 1 and pool.acquire(512) is not None


def test_fabric_stats_protocol_split():
    fab = Fabric(2, devices_per_rank=1, recv_slots=4)
    nd = fab.device(0)
    assert nd.post_send(1, 0, b"e" * 10, eager=True)
    assert nd.post_send(1, 0, b"r" * 10)
    assert fab.stats.eager_msgs == 1 and fab.stats.rendezvous_msgs == 1


def test_send_queue_slot_freed_on_cq_reap():
    fab = Fabric(2, devices_per_rank=1, recv_slots=8, send_queue_depth=1)
    nd = fab.device(0)
    assert nd.post_send(1, 0, b"one")
    assert not nd.post_send(1, 0, b"two")  # ring full until CQ reaped
    assert fab.stats.backpressure_events == 1
    nd.poll_cq()
    assert nd.inflight_sends() == 0
    assert nd.post_send(1, 0, b"two")


# --------------------------------------------- aggregation x eager matrix
def _agg_run(world_cls, parcelport_cls, cfg):
    world = world_cls(2, lambda loc, fab: parcelport_cls(loc, fab, cfg), devices_per_rank=cfg.ndevices)
    try:
        got = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for pl in [b"s" * 32, b"m" * 3_000, b"L" * 20_000, b"s2" * 16, b"X" * 70_000]:
            world.localities[0].async_action(1, "sink", pl, zero_copy_threshold=1024)
        world.drain(max_rounds=100_000)
        st = world.fabric.stats
        return sorted(bytes(a[0]) for a in got), st.messages, st.eager_msgs, st.rendezvous_msgs
    finally:
        world.close()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_aggregation_eager_interaction(variant):
    """Every variant delivers a burst of same-destination parcels (which
    aggregation may merge) mixed across the eager/rendezvous boundary, with
    the reference's counts."""
    from repro.core.lci_parcelport import LCIParcelport as JLCIParcelport

    cfg = VARIANTS[variant].variant(aggregation=True)
    port = _agg_run(World, LCIParcelport, cfg)
    assert port[0] == sorted([b"s" * 32, b"m" * 3_000, b"L" * 20_000, b"s2" * 16, b"X" * 70_000])
    if single_threaded(variant):
        assert port == _agg_run(JWorld, JLCIParcelport, jvariants.VARIANTS[variant].variant(aggregation=True))


# ------------------------------------------------- split_aggregate sub-ids
def test_split_aggregate_subids_unique_when_dense_and_large():
    def mk(pid):
        return Parcel(parcel_id=pid, source=0, dest=1, nzc_chunk=Chunk(b"p"))

    agg_a = aggregate_parcels([mk(500) for _ in range(1100)])
    agg_b = aggregate_parcels([mk(501) for _ in range(1100)])
    ids_a = [p.parcel_id for p in split_aggregate(agg_a)]
    ids_b = [p.parcel_id for p in split_aggregate(agg_b)]
    all_ids = ids_a + ids_b
    assert len(set(all_ids)) == len(all_ids)
    for i, sid in enumerate(ids_a):
        assert sid >> AGG_SUB_SHIFT == i + 1
        assert sid & ((1 << AGG_SUB_SHIFT) - 1) == 500


def test_split_aggregate_roundtrip_content():
    parcels = [
        serialize_action(100 + i, 0, 1, "act", (bytes([i]) * (10 + i),), zero_copy_threshold=64)
        for i in range(5)
    ]
    out = split_aggregate(aggregate_parcels(parcels))
    assert len(out) == 5
    for orig, split in zip(parcels, out):
        assert split.nzc_chunk.data == orig.nzc_chunk.data
        assert [c.data for c in split.zc_chunks] == [c.data for c in orig.zc_chunks]


# ------------------------------------------ tests/test_agg_threshold.py
def _nzc_parcel(pid: int, size: int) -> Parcel:
    return Parcel(parcel_id=pid, source=0, dest=1, nzc_chunk=Chunk(b"x" * size))


def _agg_world(cfg: LCIPPConfig):
    world = World(2, lambda loc, fab: LCIParcelport(loc, fab, cfg), devices_per_rank=cfg.ndevices)
    got: list = []
    world.localities[1].register_action("sink", lambda *a: got.append(a))
    return world, got


def _drain_burst(world, parcels):
    """Pre-load the per-destination queue (as racing senders would), then
    one send drains the whole burst through the batching logic."""
    pp = world.localities[0].parcelport
    q = pp._agg_queues.setdefault(1, deque())
    for p in parcels[:-1]:
        q.append((p, None))
    pp.send(1, parcels[-1])
    world.drain(max_rounds=100_000)
    return pp


def _sink_parcels(n: int, payload: int):
    return [
        serialize_action(1000 + i, 0, 1, "sink", (bytes([i]) * payload,), zero_copy_threshold=1 << 30)
        for i in range(n)
    ]


def test_projected_bytes_matches_real_aggregate():
    parcels = [_nzc_parcel(i, 100 + i) for i in range(4)]
    assert aggregate_projected_bytes(parcels) == aggregate_parcels(parcels).total_bytes


def test_agg_batches_exact_and_one_over():
    parcels = [(_nzc_parcel(i, 100), None) for i in range(2)]
    exact = AGG_PREAMBLE_BYTES + 2 * (AGG_PER_PARCEL_BYTES + 100)
    world, _ = _agg_world(LCIPPConfig(name="t", aggregation=True, agg_eager=True, eager_threshold=exact))
    try:
        pp = world.localities[0].parcelport
        assert len(pp._agg_batches(list(parcels))) == 1
        pp.agg_limit_bytes = exact - 1
        assert len(pp._agg_batches(list(parcels))) == 2
    finally:
        world.close()


@pytest.mark.parametrize("over", [0, 1])
def test_aggregate_at_and_one_byte_over_threshold(over):
    """Exactly at the threshold: ONE eager message; one byte over: two
    batches, both still eager — never a rendezvous spill."""
    parcels = _sink_parcels(4, 900)
    need = aggregate_projected_bytes(parcels)
    world, got = _agg_world(LCIPPConfig(name="t", aggregation=True, agg_eager=True, eager_threshold=need - over))
    try:
        _drain_burst(world, parcels)
        assert len(got) == 4
        st = world.fabric.stats
        assert st.eager_msgs == 1 + over and st.rendezvous_msgs == 0
    finally:
        world.close()


def test_oversize_parcel_gets_own_batch_and_rendezvous():
    small = _sink_parcels(3, 900)
    big = serialize_action(2000, 0, 1, "sink", (b"B" * 40_000,), zero_copy_threshold=1024)
    world, got = _agg_world(VARIANTS["lci_agg_eager"])
    try:
        _drain_burst(world, small[:2] + [big] + small[2:])
        assert sorted(len(a[0]) for a in got) == [900, 900, 900, 40_000]
        st = world.fabric.stats
        assert st.rendezvous_msgs >= 2 and st.eager_msgs >= 1
    finally:
        world.close()


def test_unbounded_merge_spills_same_burst_into_rendezvous():
    world, got = _agg_world(VARIANTS["lci_agg_eager"].variant(name="t_unbounded", agg_eager=False))
    try:
        _drain_burst(world, _sink_parcels(32, 3_000))
        assert len(got) == 32 and world.fabric.stats.rendezvous_msgs > 0
    finally:
        world.close()
    world2, got2 = _agg_world(VARIANTS["lci_agg_eager"])
    try:
        _drain_burst(world2, _sink_parcels(32, 3_000))
        assert len(got2) == 32 and world2.fabric.stats.rendezvous_msgs == 0
    finally:
        world2.close()


@pytest.mark.parametrize("other", ["lci", "lci_agg_eager"])
def test_agg_eager_delivers_identical_payloads(other):
    payloads = [bytes([i % 251]) * (150 * (i + 1)) for i in range(12)]
    ref, port = _both_stats(other, payloads)
    assert port == ref and port[0] == sorted(payloads)


def test_agg_eager_under_bounded_fabric():
    ref, port = _both_stats("lci_agg_eager", [bytes([i]) * 2_000 for i in range(40)],
                            fabric_kwargs=dict(send_queue_depth=2, bounce_buffers=2, bounce_buffer_size=32_768))
    assert port == ref
    assert len(port[0]) == 40 and port[4] > 0 and port[5] == [0, 0]


# ------------------------------------------- the device-staged collective
def _staged_world(device):
    from repro_torch.core.comm.collective import CollectiveParcelport, collective_group_for

    cfg = VARIANTS["collective"]

    def factory(loc, fab):
        collective_group_for(fab, cfg.ndevices, stage="device", device=device)  # the world's one group
        return CollectiveParcelport(loc, fab, cfg)

    return World(2, factory, devices_per_rank=max_devices("collective"))


def test_device_staged_collective_parcelport_matches_the_loopback_one():
    """A collective world whose group stages every drain through a device
    buffer (here the CPU, as the caller asks) delivers what the loopback
    world delivers, with the same counters, the same decision trace, and
    every message's payload staged: bytes − 8 × sends."""
    payloads = [bytes([s % 251]) * s for s in SMOKE_PAYLOAD_SIZES]
    world = _staged_world("cpu")
    try:
        tr: list = []
        for loc in world.localities:
            loc.parcelport.engine.trace = tr
        got: list = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for p in payloads:
            world.localities[0].async_action(1, "sink", p)
            world.drain(max_rounds=50_000)
        st = transport_stats(world)
        assert world.fabric._collective_group.device.type == "cpu"
    finally:
        world.close()
    assert [bytes(a[0]) for a in got] == payloads
    assert tr == functional_trace("collective", SMOKE_PAYLOAD_SIZES, zero_copy_threshold=8 * 1024)
    assert st.staged_batches >= 1 and st.staged_bytes == st.bytes - 8 * st.sends
    loop, _ = deliver_payloads("collective", payloads, zero_copy_threshold=8 * 1024)
    try:
        ls = transport_stats(loop)
        assert (ls.messages, ls.bytes, ls.sends, ls.eager_msgs, ls.rendezvous_msgs) == (
            st.messages, st.bytes, st.sends, st.eager_msgs, st.rendezvous_msgs)
        assert ls.staged_batches == ls.staged_bytes == 0
    finally:
        loop.close()


def test_device_staged_collective_refuses_without_a_card(monkeypatch):
    """The stage runs on ``cuda`` unless the caller asks for the CPU; with
    no card it raises instead of carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _staged_world(None)


def test_stage_payload_moves_one_payload_through_the_stage():
    """``_stage_payload`` is one drain of one message: the same bytes back,
    one staged batch of its length; the loopback stage hands it over."""
    from repro_torch.core.comm.collective import CollectiveGroup

    payload = bytes(range(256)) * 9
    staged = CollectiveGroup(2, stage="device", device="cpu")
    assert bytes(staged._stage_payload(payload)) == payload
    assert (staged.stats.staged_batches, staged.stats.staged_bytes) == (1, len(payload))
    loop = CollectiveGroup(2)
    assert loop._stage_payload(payload) is payload and loop.stats.staged_batches == 0
