"""Port parity: the discrete-event simulator (``repro_torch.amtsim``).

The DES is pure Python over the port's own progress engine, resources and
variant registry, so on the same arguments it must give the reference's
results exactly: every field of ``dataclasses.asdict`` of a
``MicroResult`` or ``AppResult`` is ``==`` the reference's (simulated
times are floats from the same arithmetic; no tolerance).  Then
``tests/test_amtsim.py`` test for test on the port: the DES kernel, the
paper's orderings and the bounded-injection model."""
import dataclasses

import pytest

from repro.amtsim import costs as jcosts
from repro.amtsim import parcelport_sim as jsim
from repro.amtsim import workloads as jwork
from repro.core.comm import resources as jresources
from repro_torch.amtsim import costs as tcosts
from repro_torch.amtsim import parcelport_sim as tsim
from repro_torch.amtsim import workloads as twork
from repro_torch.amtsim.costs import DELTA, EXPANSE
from repro_torch.amtsim.des import Acquire, Env, Lock, Store, Timeout
from repro_torch.amtsim.workloads import chains, flood, octotiger
from repro_torch.core.comm import resources as tresources

PKGS = {"ref": (jwork, jsim, jcosts, jresources), "port": (twork, tsim, tcosts, tresources)}
FLOOD_VARIANTS = ("lci", "mpi", "mpi_a", "block", "try_progress", "lci_d1", "lci_d4", "lci_prg2", "lci_b8",
                  "lci_eprg0_2", "shmem_putq", "collective")


def _both(fn):
    """``fn(work, sim, costs, resources)`` in each package, as dicts."""
    return [dataclasses.asdict(fn(*PKGS[p])) for p in ("ref", "port")]


def _assert_equal(fn):
    ref, port = _both(fn)
    assert port == ref


# ------------------------------------------------------ the DES is equal
@pytest.mark.parametrize("platform", ["EXPANSE", "DELTA"])
@pytest.mark.parametrize("msg_size,nmsgs", [(8, 600), (16_384, 300)])
@pytest.mark.parametrize("variant", FLOOD_VARIANTS)
def test_flood_equals_the_reference(variant, msg_size, nmsgs, platform):
    _assert_equal(lambda w, s, c, r: w.flood(variant, msg_size, 8, nmsgs, platform=getattr(c, platform)))


@pytest.mark.parametrize("variant", ["lci", "mpi", "lci_prg2", "lci_b8"])
def test_flood_equals_the_reference_at_the_trial_size(variant):
    _assert_equal(lambda w, s, c, r: w.flood(variant, 8, 8, 2000))


@pytest.mark.parametrize("variant", ["lci", "mpi", "mpi_a", "shmem_putq"])
def test_chains_equal_the_reference(variant):
    _assert_equal(lambda w, s, c, r: w.chains(variant, msg_size=8, nchains=8, nsteps=20, nthreads=8))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", ["lci", "mpi"])
def test_octotiger_equals_the_reference(variant, seed):
    ref, port = _both(lambda w, s, c, r: w.octotiger(variant, n_nodes=4, workers=8, total_subgrids=64,
                                                     timesteps=2, seed=seed))
    assert port == ref and port["tasks"] > 0 and port["messages"] > 0


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_lcg_equals_the_reference(seed):
    """The workloads' deterministic RNG draws the reference's sequence.
    (``octotiger`` builds one from ``seed`` but its task graph draws
    nothing from it, in both packages, so its results do not depend on
    the seed.)"""
    j, t = jwork._LCG(seed), twork._LCG(seed)
    assert [t.next(n) for n in range(1, 200)] == [j.next(n) for n in range(1, 200)]


def _bounded(sim, resources, storm: bool):
    return dataclasses.replace(
        sim.sim_config_for_variant("lci"), name="lci_bounded", rnr_storm=storm,
        limits=resources.ResourceLimits(send_queue_depth=2, bounce_buffers=2, bounce_buffer_size=16_384,
                                        recv_slots=1),
    )


@pytest.mark.parametrize("storm", [False, True])
def test_bounded_injection_equals_the_reference(storm):
    ref, port = _both(lambda w, s, c, r: w.flood(_bounded(s, r, storm), msg_size=64, nthreads=8, nmsgs=300,
                                                 max_seconds=4.0))
    assert port == ref
    assert port["backpressure_events"] > 0 and port["rnr_events"] > 0
    assert (port["rnr_retries"] > 0) == storm


def test_device_cq_scope_equals_the_reference():
    _assert_equal(lambda w, s, c, r: w.flood(
        dataclasses.replace(s.sim_config_for_variant("lci"), name="lci_devcq", cq_scope="device"),
        msg_size=8, nthreads=8, nmsgs=300))


def _injection_stats(sim, resources, storm: bool):
    """A bounded world of 2 ranks × 8 workers: 200 parcels of 64 B from
    rank 0, then ``SimWorld.injection_stats()`` and the simulated clock."""
    world = sim.SimWorld(2, 8, _bounded(sim, resources, storm))
    state = {"delivered": 0}

    def delivered():
        state["delivered"] += 1
        if state["delivered"] == 200:
            world.stop()

    for _ in range(200):
        op = world.make_parcel(0, 1, 64, on_delivered=delivered)
        world.spawn(0, sim.Task(action=lambda w, _op=op: world.send_parcel(w, _op)))
    world.run(until=4.0)
    return world.injection_stats(), world.env.now, state["delivered"]


@pytest.mark.parametrize("storm", [False, True])
def test_injection_stats_equal_the_reference(storm):
    ref = _injection_stats(jsim, jresources, storm)
    port = _injection_stats(tsim, tresources, storm)
    assert port == ref and port[2] == 200
    assert port[0]["send_queue_hw"] == 2 and port[0]["backpressure_events"] > 0


def test_mechanisms_and_platforms_equal_the_reference():
    """The cost model is the reference's, constant for constant (the
    paper's Expanse and Delta, never a measurement of this port's card)."""
    for name in ("EXPANSE", "DELTA", "DEFAULT_MECHANISMS"):
        assert dataclasses.asdict(getattr(tcosts, name)) == dataclasses.asdict(getattr(jcosts, name)), name


# ------------------------------------------------------------------- kernel
def test_des_timeout_ordering():
    env = Env()
    log = []

    def proc(name, dt):
        yield Timeout(dt)
        log.append((env.now, name))

    env.process(proc("b", 2e-6))
    env.process(proc("a", 1e-6))
    env.run()
    assert [n for _, n in log] == ["a", "b"]


def test_des_lock_fifo():
    env = Env()
    order = []

    def proc(name):
        yield Acquire(lock)
        yield Timeout(1e-6)
        order.append(name)
        lock.release()

    lock = Lock(env)
    for n in ("p0", "p1", "p2"):
        env.process(proc(n))
    env.run()
    assert order == ["p0", "p1", "p2"]
    assert lock.contentions == 2


def test_des_store():
    env = Env()
    got = []

    def consumer():
        from repro_torch.amtsim.des import Get

        item = yield Get(store)
        got.append(item)

    store = Store(env)
    env.process(consumer())
    store.put("x")
    env.run()
    assert got == ["x"]


# ---------------------------------------------------------------- workloads
def test_flood_deterministic():
    r1 = flood("lci", msg_size=8, nthreads=8, nmsgs=500)
    r2 = flood("lci", msg_size=8, nthreads=8, nmsgs=500)
    assert r1.elapsed == r2.elapsed and r1.messages == r2.messages


def test_flood_orderings_small_msgs():
    """Paper Fig 3a qualitative: lci > mpi_a > mpi at 8 B."""
    rates = {v: flood(v, msg_size=8, nthreads=32, nmsgs=2000).rate for v in ("lci", "mpi", "mpi_a")}
    assert rates["lci"] > rates["mpi_a"] > rates["mpi"]


def test_flood_orderings_large_msgs():
    """Paper §4.2: zero-copy chunks cannot be combined, so aggregation's
    large-message gain collapses relative to its small-message gain."""
    small = {v: flood(v, msg_size=8, nthreads=32, nmsgs=2000).rate for v in ("mpi", "mpi_a")}
    large = {v: flood(v, msg_size=16384, nthreads=32, nmsgs=1000).rate for v in ("lci", "mpi", "mpi_a")}
    assert large["lci"] > large["mpi_a"] and large["lci"] > large["mpi"]
    gain_small = small["mpi_a"] / small["mpi"]
    gain_large = large["mpi_a"] / large["mpi"]
    assert gain_large < 0.5 * gain_small  # aggregation helps large messages far less


def test_latency_ordering():
    lat = {v: chains(v, msg_size=8, nchains=8, nsteps=20, nthreads=8).elapsed for v in ("lci", "mpi")}
    assert lat["lci"] < lat["mpi"]


def test_factor_study_multithreading_ladder():
    """Fig 8: block ≲ try ≲ try_progress ≲ lci on the flood microbenchmark."""
    rates = {
        v: flood(v, msg_size=8, nthreads=32, nmsgs=1500).rate
        for v in ("block", "try_progress", "lci")
    }
    assert rates["lci"] >= rates["try_progress"] >= rates["block"]


def test_device_scaling_monotone():
    """Fig 9: more devices → higher message rate (lockless family)."""
    r1 = flood("lci_d1", msg_size=8, nthreads=32, nmsgs=2000).rate
    r4 = flood("lci_d4", msg_size=8, nthreads=32, nmsgs=2000).rate
    assert r4 > r1 * 1.5


def test_octotiger_lci_beats_mpi():
    e = {}
    for v in ("lci", "mpi"):
        e[v] = octotiger(v, n_nodes=4, workers=8, total_subgrids=256, timesteps=3).elapsed
    assert e["lci"] < e["mpi"]


def test_slingshot_lock_penalty():
    """Fig 5: Delta's libfabric CQ lock lowers peak message rate vs Expanse."""
    r_exp = flood("lci", msg_size=8, nthreads=32, nmsgs=1500, platform=EXPANSE).rate
    r_delta = flood("lci", msg_size=8, nthreads=32, nmsgs=1500, platform=DELTA).rate
    assert r_delta < r_exp


# ------------------------------------------------------- bounded injection
def _bounded_cfg(depth=2, bufs=2, buf_size=16_384, recv_slots=0):
    from repro_torch.amtsim.parcelport_sim import sim_config_for_variant
    from repro_torch.core.comm.resources import ResourceLimits

    return dataclasses.replace(
        sim_config_for_variant("lci"),
        name="lci_bounded",
        limits=ResourceLimits(
            send_queue_depth=depth,
            bounce_buffers=bufs,
            bounce_buffer_size=buf_size,
            recv_slots=recv_slots,
        ),
    )


def test_des_bounded_injection_backpressure_and_delivery():
    """A small-queue DES config reports nonzero backpressure_events and
    still delivers everything; the unbounded model reports exactly zero."""
    r_unbounded = flood("lci", msg_size=64, nthreads=8, nmsgs=400)
    r_bounded = flood(_bounded_cfg(), msg_size=64, nthreads=8, nmsgs=400)
    assert r_unbounded.backpressure_events == 0
    assert r_unbounded.messages == 400
    assert r_bounded.backpressure_events > 0
    assert r_bounded.messages == 400  # throttled, never lost
    # the ring depth is a hard bound, and parked posts actually queued up
    assert 0 < r_bounded.send_queue_hw <= 2
    assert r_bounded.retry_queue_hw > 0


def test_des_bounded_injection_deterministic():
    r1 = flood(_bounded_cfg(), msg_size=64, nthreads=8, nmsgs=300)
    r2 = flood(_bounded_cfg(), msg_size=64, nthreads=8, nmsgs=300)
    assert (r1.elapsed, r1.messages, r1.backpressure_events) == (
        r2.elapsed,
        r2.messages,
        r2.backpressure_events,
    )


def test_des_bounded_injection_throttles_rate():
    """Backpressure is a cost, not a free pass: the bounded config cannot
    outrun the unbounded one."""
    r_u = flood("lci", msg_size=64, nthreads=16, nmsgs=1000)
    r_b = flood(_bounded_cfg(depth=1, bufs=1), msg_size=64, nthreads=16, nmsgs=1000)
    assert r_b.messages == 1000
    assert r_b.rate < r_u.rate


def test_des_bounded_mpi_path_delivers():
    from repro_torch.amtsim.parcelport_sim import sim_config_for_variant
    from repro_torch.core.comm.resources import ResourceLimits

    cfg = dataclasses.replace(
        sim_config_for_variant("mpi"), name="mpi_bounded", limits=ResourceLimits(send_queue_depth=1)
    )
    r = flood(cfg, msg_size=64, nthreads=4, nmsgs=150)
    assert r.messages == 150
    assert r.backpressure_events > 0


def test_des_bounded_chains_complete():
    r = chains(_bounded_cfg(depth=1, bufs=1), msg_size=64, nchains=8, nsteps=10, nthreads=8)
    assert r.messages == 80


def test_des_rnr_receiver_not_ready_counted_and_recovered():
    """With ``limits.recv_slots`` set the DES models RNR the way
    ``core.fabric`` does: an arrival beyond the posted-receive depth is
    counted, parked, and redelivered on reap (never lost)."""
    r = flood(_bounded_cfg(depth=0, bufs=0, recv_slots=1), msg_size=64, nthreads=8, nmsgs=300)
    assert r.rnr_events > 0
    assert r.messages == 300  # retransmitted, not dropped


def test_des_rnr_scoped_to_bounded_mode():
    """The unbounded model never reports RNR (recv_slots=0 takes no new
    code path), and the RNR path is deterministic."""
    assert flood("lci", msg_size=64, nthreads=8, nmsgs=300).rnr_events == 0
    cfg = _bounded_cfg(depth=0, bufs=0, recv_slots=1)
    r1 = flood(cfg, msg_size=64, nthreads=8, nmsgs=300)
    r2 = flood(cfg, msg_size=64, nthreads=8, nmsgs=300)
    assert (r1.elapsed, r1.rnr_events) == (r2.elapsed, r2.rnr_events)


def test_des_eager_aggregate_charges_bounce_copy_mechanism():
    """An eager aggregate bigger than the piggyback limit pays the
    calibrated bounce-buffer copy, on top of the serialize/merge cost;
    a sub-piggyback workload is untouched by the constant."""
    from repro_torch.amtsim.costs import DEFAULT_MECHANISMS

    inflated = DEFAULT_MECHANISMS.variant(t_bounce_copy_per_byte=100 * DEFAULT_MECHANISMS.t_bounce_copy_per_byte)
    base = flood("lci_agg_eager", msg_size=6_000, nthreads=8, nmsgs=200)
    slow = flood("lci_agg_eager", msg_size=6_000, nthreads=8, nmsgs=200, mech=inflated)
    assert slow.messages == base.messages == 200
    assert slow.elapsed > base.elapsed
    base_small = flood("lci", msg_size=512, nthreads=8, nmsgs=200)
    same_small = flood("lci", msg_size=512, nthreads=8, nmsgs=200, mech=inflated)
    assert same_small.elapsed == base_small.elapsed


def test_des_eager_capped_by_bounce_buffer_size():
    """A payload under the eager threshold but over the bounce-buffer size
    takes rendezvous instead of parking forever."""
    cfg = dataclasses.replace(_bounded_cfg(depth=0, bufs=2, buf_size=4_096), eager_threshold=65_536)
    r = flood(cfg, msg_size=12_000, nthreads=4, nmsgs=100, max_seconds=2.0)
    assert r.messages == 100


def test_des_agg_batches_greedy_packing():
    """Threshold-aware DES aggregation packs FIFO up to eager_threshold;
    an op alone over budget gets its own batch."""
    from repro_torch.amtsim.parcelport_sim import ParcelOp, SimWorld, sim_config_for_variant

    world = SimWorld(2, 1, sim_config_for_variant("lci_agg_eager"))  # 16 KiB budget
    ops = [ParcelOp(src=0, dst=1, size=s) for s in (6_000, 6_000, 6_000, 20_000, 100)]
    batches = world._agg_batches(ops)
    assert [[op.size for op in b] for b in batches] == [[6_000, 6_000], [6_000], [20_000], [100]]


def test_des_agg_eager_flood_delivers():
    r = flood("lci_agg_eager", msg_size=600, nthreads=8, nmsgs=400)
    assert r.messages == 400
    assert r.backpressure_events == 0


def test_des_store_tracks_high_water():
    env = Env()
    store = Store(env)
    for i in range(5):
        store.put(i)
    store.get_nowait()
    store.put(99)
    assert store.max_depth == 5


def test_dedicated_progress_cores_not_justified():
    """Paper §3.3.4: dedicated progress cores give no microbenchmark gain
    with a lock-free runtime and cost the application compute cores."""
    from repro_torch.amtsim.parcelport_sim import sim_config_for_variant

    base = sim_config_for_variant("lci")
    with_pw = dataclasses.replace(base, name="lci_pw4", progress_workers=4)
    r0 = flood(base, msg_size=8, nthreads=32, nmsgs=2000)
    r4 = flood(with_pw, msg_size=8, nthreads=32, nmsgs=2000)
    assert r4.rate < r0.rate * 1.1  # no meaningful gain
    a0 = octotiger(base, n_nodes=4, workers=8, total_subgrids=256, timesteps=3)
    a4 = octotiger(with_pw, n_nodes=4, workers=8, total_subgrids=256, timesteps=3)
    assert a4.elapsed > a0.elapsed  # reserved cores hurt the application
