"""Port parity: end-to-end parcel delivery on every parcelport variant.

* ``tests/test_parcelports.py`` on the port (Figs 6-9's variants, many
  localities, send callbacks, zero-copy order, the delivery property),
  each delivery held against the reference's on the same payloads.
* The variant registry: for every name in ``variant_names()`` both
  packages list the same names and resolve equal configs
  (``dataclasses.asdict``), ``variant_limits`` and ``max_devices``; the
  serving fleet's registry too.  The registry part of
  ``tests/test_comm_interface.py``: every pre-existing name resolves to
  its old config, the families on demand, bounded families bind.
* ``deliver_payloads`` on ``benchmarks/run.py``'s smoke sizes, every
  variant, both packages: the same payloads delivered, every
  ``FabricStats`` count equal, ``bytes`` equal once the port's 6-byte
  placeholder delta is counted (one a parcel that carries a zero-copy
  chunk: the pickle names ``repro_torch.core.parcel``).  Variants with
  real progress threads (``*_prg{n}``, ``lci_eprg{lo}_{hi}``) compare the
  delivered multiset and close to a flat thread census; the others the
  delivery order too.
* ``tests/test_membership.py``'s end-to-end ``lci_eprg0_2``: the elastic
  pool stays within its bounds, is 0 after ``world.close()``, and the
  thread count is flat.

Every world is closed in a ``finally``; every drain is bounded."""
import dataclasses
import threading

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import harness as jharness
from repro.core import variants as jvariants
from repro_torch.core import harness as tharness
from repro_torch.core.comm.membership import live_worker_count
from repro_torch.core.comm.resources import ResourceLimits
from repro_torch.core.harness import deliver_payloads, transport_stats
from repro_torch.core.lci_parcelport import LCIPPConfig
from repro_torch.core.device import LockMode
from repro_torch.core.parcelport import World
from repro_torch.core.variants import (
    SERVE_REGISTRY,
    VARIANTS,
    make_fleet_config,
    make_parcelport_factory,
    max_devices,
    variant_limits,
    variant_names,
)

#: ``benchmarks/run.py``'s SMOKE_PAYLOAD_SIZES
SMOKE_PAYLOAD_SIZES = (8, 600, 3_000, 12_000, 40_000)
#: the port's nzc chunk is this much longer where a zero-copy placeholder is pickled
PLACEHOLDER_DELTA = 6
ZC_THRESHOLD = 1024  # deliver_payloads' default

SMALL_VARIANTS = [
    "mpi", "mpi_a", "lci", "sendrecv_queue", "sendrecv_sync", "sync", "queue_lock", "queue_ms",
    "block", "try", "try_progress", "block_d2", "lci_d4", "lci_try_d4",
]


def threaded(name: str) -> bool:
    """Variants that start real progress threads: their decision order is
    the scheduler's."""
    if name in ("mpi", "mpi_a"):
        return False
    cfg = VARIANTS[name]
    return cfg.progress_workers > 0 or cfg.elastic_progress is not None


def deliver(variant, payloads, n_loc=2, devices=None, pkg_world=World, factory=make_parcelport_factory,
            devs=max_devices):
    world = pkg_world(n_loc, factory(variant), devices_per_rank=devices or devs(variant))
    try:
        got = []
        for loc in world.localities:
            loc.register_action("sink", lambda *args, _got=got: _got.append(args))
        for i, pl in enumerate(payloads):
            world.localities[i % n_loc].async_action((i + 1) % n_loc, "sink", pl)
        world.drain(max_rounds=100_000)
        return got
    finally:
        world.close()


def deliver_both(variant, payloads, n_loc=2):
    from repro.core.parcelport import World as JWorld

    ref = deliver(variant, payloads, n_loc, pkg_world=JWorld, factory=jvariants.make_parcelport_factory,
                  devs=jvariants.max_devices)
    port = deliver(variant, payloads, n_loc)
    return ref, port


def _payloads(got):
    return [tuple(bytes(x) if isinstance(x, (bytes, memoryview)) else x for x in a) for a in got]


# --------------------------------------------------- tests/test_parcelports.py
@pytest.mark.parametrize("variant", SMALL_VARIANTS)
def test_variant_delivers_small_and_large(variant):
    payloads = [b"s" * 10, b"L" * 50_000, b"m" * 2_000, b"X" * 200_000]
    ref, got = deliver_both(variant, payloads)
    assert sorted(len(a[0]) for a in got) == sorted(len(p) for p in payloads)
    assert all(set(a[0]) == {a[0][0]} for a in got if a[0])  # content intact
    assert _payloads(got) == _payloads(ref)  # single-threaded: the same order too


@pytest.mark.parametrize("variant", ["mpi", "mpi_a", "lci"])
def test_many_parcels_multi_locality(variant):
    payloads = [bytes([i % 256]) * (10 + 97 * i % 5000) for i in range(60)]
    ref, got = deliver_both(variant, payloads, n_loc=4)
    assert len(got) == len(payloads)
    assert sorted(_payloads(got)) == sorted(_payloads(ref)) == sorted((p,) for p in payloads)


def test_send_callback_fires():
    world = World(2, make_parcelport_factory("lci"), devices_per_rank=2)
    try:
        world.localities[1].register_action("nop", lambda *a: None)
        fired = []
        world.localities[0].async_action(1, "nop", b"x" * 99_999, cb=lambda p: fired.append(p.dest))
        world.drain(max_rounds=100_000)
        assert fired == [1]
    finally:
        world.close()


def test_zero_copy_chunks_arrive_in_order():
    world = World(2, make_parcelport_factory("lci"), devices_per_rank=2)
    try:
        out = []
        world.localities[1].register_action("multi", lambda *a: out.append(a))
        big1, big2 = b"A" * 100_000, b"B" * 80_000
        world.localities[0].async_action(1, "multi", b"meta", big1, big2)
        world.drain(max_rounds=100_000)
        assert _payloads(out) == [(b"meta", big1, big2)]
    finally:
        world.close()


@settings(max_examples=15, deadline=None)
@given(
    st.lists(st.integers(min_value=0, max_value=100_000), min_size=1, max_size=10),
    st.sampled_from(["mpi", "mpi_a", "lci", "sendrecv_sync", "block"]),
)
def test_delivery_property(sizes, variant):
    """Any mix of sizes is delivered exactly once on any variant, and as
    the reference delivers it."""
    payloads = [bytes([i % 251]) * s for i, s in enumerate(sizes)]
    ref, got = deliver_both(variant, payloads)
    assert sorted(len(a[0]) for a in got) == sorted(sizes)
    assert _payloads(got) == _payloads(ref)


def test_variant_names_cover_paper_figs():
    names = variant_names()
    for required in ("mpi", "mpi_a", "lci", "sendrecv_sync", "sync", "queue_ms",
                     "block", "try", "try_progress", "block_d2", "lci_d32", "lci_try_d8"):
        assert required in names


# ------------------------------------------------------------------ registry
def test_variant_names_equal_the_reference():
    assert variant_names() == jvariants.variant_names()
    assert len(variant_names()) == len(set(variant_names()))


@pytest.mark.parametrize("name", variant_names())
def test_registry_resolves_as_the_reference(name):
    assert max_devices(name) == jvariants.max_devices(name)
    assert dataclasses.asdict(variant_limits(name)) == dataclasses.asdict(jvariants.variant_limits(name))
    if name not in ("mpi", "mpi_a"):
        assert dataclasses.asdict(VARIANTS[name]) == dataclasses.asdict(jvariants.VARIANTS[name])


@pytest.mark.parametrize("name", ["lci_b8", "lci_d7", "lci_try_d3", "lci_eager_32k", "lci_prg5",
                                  "collective_prg3", "shmem_prg3", "lci_eprg1_3"])
def test_family_members_resolve_as_the_reference(name):
    """Members outside the canonical set resolve on demand, equal to the
    reference's, and are cached (one name, one object)."""
    assert name in VARIANTS and name not in variant_names()
    assert dataclasses.asdict(VARIANTS[name]) == dataclasses.asdict(jvariants.VARIANTS[name])
    assert VARIANTS[name] is VARIANTS[name]


def test_serve_registry_equals_the_reference():
    assert SERVE_REGISTRY.names() == jvariants.SERVE_REGISTRY.names()
    for name in SERVE_REGISTRY.names() + ["fleet_w3", "fleet_shmem_w5", "fleet_elastic_w4"]:
        assert dataclasses.asdict(make_fleet_config(name)) == dataclasses.asdict(jvariants.make_fleet_config(name))
        assert make_fleet_config(name) is not make_fleet_config(name)  # a fresh config each call
    assert not set(SERVE_REGISTRY.names()) & set(variant_names())


def _expected_legacy_variants():
    """The pre-redesign VARIANTS dict, reconstructed literally (the
    reference test's).  Every name must resolve to an equal config."""
    expected = {
        "lci": LCIPPConfig(name="lci"),
        "base": LCIPPConfig(name="base"),
        "sendrecv_queue": LCIPPConfig(name="sendrecv_queue", header_mode="sendrecv", header_comp="queue"),
        "sendrecv_sync": LCIPPConfig(name="sendrecv_sync", header_mode="sendrecv", header_comp="sync"),
        "sync": LCIPPConfig(name="sync", followup_comp="sync"),
        "queue_lock": LCIPPConfig(name="queue_lock", cq_kind="lock"),
        "queue_ms": LCIPPConfig(name="queue_ms", cq_kind="ms"),
    }
    ladder = dict(header_mode="sendrecv", header_comp="sync", followup_comp="sync", ndevices=1)
    expected["block"] = LCIPPConfig(name="block", lock_mode=LockMode.BLOCK, progress_mode="implicit", **ladder)
    expected["try"] = LCIPPConfig(name="try", lock_mode=LockMode.TRY, progress_mode="implicit", **ladder)
    expected["try_progress"] = LCIPPConfig(name="try_progress", lock_mode=LockMode.TRY, progress_mode="explicit",
                                           **ladder)
    expected["progress"] = LCIPPConfig(name="progress", lock_mode=LockMode.BLOCK, progress_mode="explicit", **ladder)
    expected["block_d2"] = LCIPPConfig(
        name="block_d2", header_mode="sendrecv", header_comp="sync", followup_comp="sync",
        ndevices=2, lock_mode=LockMode.BLOCK, progress_mode="implicit",
    )
    for n in (1, 2, 4, 8, 16, 32):
        expected[f"lci_d{n}"] = LCIPPConfig(name=f"lci_d{n}", ndevices=n)
        expected[f"lci_try_d{n}"] = LCIPPConfig(name=f"lci_try_d{n}", ndevices=n, lock_mode=LockMode.TRY)
    expected["lci_noeager"] = LCIPPConfig(name="lci_noeager", eager_threshold=0)
    for kib in (16, 64):
        expected[f"lci_eager_{kib}k"] = LCIPPConfig(name=f"lci_eager_{kib}k", eager_threshold=kib * 1024)
    expected["lci_eager"] = expected["lci_eager_16k"].variant(name="lci_eager")
    expected["lci_agg_eager"] = LCIPPConfig(
        name="lci_agg_eager", aggregation=True, agg_eager=True, eager_threshold=16 * 1024
    )
    return expected


def test_legacy_variant_names_resolve_to_equal_configs():
    expected = _expected_legacy_variants()
    for name, cfg in expected.items():
        assert VARIANTS[name] == cfg, f"{name} drifted from its pre-redesign config"
    names = set(variant_names())
    assert set(expected) <= names
    assert {"mpi", "mpi_a"} <= names


def test_family_members_resolve_without_preregistration():
    cfg = VARIANTS["lci_b8"]
    assert cfg.limits == ResourceLimits(send_queue_depth=8, bounce_buffers=8, bounce_buffer_size=64 * 1024)
    assert VARIANTS["lci_d7"].ndevices == 7
    assert VARIANTS["lci_try_d3"].lock_mode == LockMode.TRY
    assert VARIANTS["lci_eager_32k"].eager_threshold == 32 * 1024
    assert "lci_b8" in VARIANTS and "lci_bx" not in VARIANTS
    with pytest.raises(KeyError):
        VARIANTS["definitely_not_a_variant"]
    assert VARIANTS["lci_b8"] is cfg
    assert VARIANTS["collective_prg3"].progress_workers == 3
    assert VARIANTS["collective"].header_mode == "sendrecv"
    assert {"collective", "collective_prg2"} <= set(variant_names())


def test_family_factory_builds_bounded_world():
    assert make_parcelport_factory("lci_b8") is not None
    world, got = deliver_payloads("lci_b2", [bytes([i]) * 600 for i in range(30)])
    try:
        assert len(got) == 30
        assert world.fabric.limits.send_queue_depth == 2
        assert world.fabric.stats.backpressure_events > 0  # the bound bit
    finally:
        world.close()


# ------------------------------------------ deliver_payloads, every variant
def _run(harness, name, payloads):
    world, got = harness.deliver_payloads(name, payloads, max_rounds=50_000)
    try:
        st = dataclasses.asdict(harness.transport_stats(world))
        pps = [loc.parcelport for loc in world.localities]
        counts = (sum(pp.stats_sent for pp in pps), sum(pp.stats_received for pp in pps))
    finally:
        world.close()
    return _payloads(got), st, counts


@pytest.mark.parametrize("name", variant_names())
def test_deliver_payloads_matches_the_reference(name):
    payloads = [bytes([s % 251]) * s for s in SMOKE_PAYLOAD_SIZES]
    threads, census = threading.active_count(), live_worker_count()
    jgot, jst, jcounts = _run(jharness, name, payloads)
    got, st, counts = _run(tharness, name, payloads)
    assert sorted(got) == sorted(jgot) == sorted((p,) for p in payloads)
    if not threaded(name):
        assert got == jgot  # the same delivery order
    placeholders = sum(1 for p in payloads if len(p) >= ZC_THRESHOLD)
    assert st["bytes"] - jst["bytes"] == PLACEHOLDER_DELTA * placeholders
    assert {k: v for k, v in st.items() if k != "bytes"} == {k: v for k, v in jst.items() if k != "bytes"}
    assert counts == jcounts and counts[0] == counts[1] > 0  # sent == received
    assert live_worker_count() == census  # every progress thread the port started was joined
    assert threading.active_count() <= threads + 1


def test_bounded_lci_backpressures_and_delivers_as_the_reference():
    payloads = [bytes([s % 251]) * s for s in SMOKE_PAYLOAD_SIZES]
    fk = dict(send_queue_depth=2, bounce_buffers=2, bounce_buffer_size=65_536)
    out = []
    for harness in (jharness, tharness):
        world, got = harness.deliver_payloads("lci", payloads, fabric_kwargs=dict(fk), max_rounds=50_000)
        try:
            st = harness.transport_stats(world)
            assert st.backpressure_events > 0
            assert all(loc.parcelport.retry_queue_depth() == 0 for loc in world.localities)
            out.append((sorted(_payloads(got)), st.backpressure_events, st.messages))
        finally:
            world.close()
    assert out[0] == out[1]


def test_eager_uses_fewer_messages_than_noeager():
    payloads = [bytes([s % 251]) * s for s in SMOKE_PAYLOAD_SIZES]
    msgs = {}
    for name in ("lci_eager", "lci_noeager"):
        world, got = deliver_payloads(name, payloads)
        try:
            assert len(got) == len(payloads)
            msgs[name] = transport_stats(world).messages
        finally:
            world.close()
    assert msgs["lci_eager"] < msgs["lci_noeager"]


# ----------------------------------- tests/test_membership.py, end to end
def test_elastic_parcelport_delivers_within_bounds_and_closes_clean():
    """The lci_eprg{lo}_{hi} family: a real elastic pool on a real world —
    full delivery, the pool never escapes its bounds, close() joins every
    thread (census flat)."""
    cfg = VARIANTS["lci_eprg0_2"]
    assert cfg.elastic_progress == (0, 2) and cfg.progress_workers == 0
    base, census = threading.active_count(), live_worker_count()
    world = World(2, make_parcelport_factory("lci_eprg0_2"), devices_per_rank=max_devices("lci_eprg0_2"))
    try:
        got = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for i in range(40):
            world.localities[0].async_action(1, "sink", b"x" * (64 + i))
        world.drain(max_rounds=100_000)
        assert sorted(_payloads(got)) == sorted((b"x" * (64 + i),) for i in range(40))
        for loc in world.localities:
            pp = loc.parcelport
            assert pp._elastic is not None
            assert 0 <= pp._pw_pool.size() <= 2
    finally:
        world.close()
    assert threading.active_count() <= base + 1
    assert live_worker_count() == census
    for loc in world.localities:
        assert loc.parcelport._pw_pool.size() == 0
