"""Port parity: the member lifecycle, the progress pool and its controller.

The reference's tests (``tests/test_membership.py``) on the port's
:mod:`repro_torch.core.comm.membership`: state-machine edges
(double-leave idempotent, join-during-drain, typed EAGAIN_DRAINING on
posts racing a leave, epoch-stale completion discard), the
finalizer-based abandoned-worker sweep, the resizable ProgressWorkerPool
(threads joined on every shrink), the ElasticProgressController's
hysteresis + cooldown guards, and the property over random
join/leave/post schedules.  Then: the same random schedule through both
packages' ``Membership`` gives the same ``drain_events``, states, epochs
and stale discards.  (The reference's ``lci_eprg`` end-to-end test needs
the parcelport layer, which the port does not have.)
"""
import gc
import threading
import weakref

import numpy as np
import pytest

from repro.core.comm.membership import Membership as JMembership
from repro_torch.core.comm.interface import PostStatus
from repro_torch.core.comm.membership import (
    ACTIVE,
    DRAINING,
    GONE,
    JOINING,
    ElasticProgressController,
    Membership,
    ProgressWorkerPool,
    live_worker_count,
    spawn_worker,
)
from tests._hypothesis_compat import given, settings, st


# ------------------------------------------------------- state machine
def test_lifecycle_happy_path_and_events():
    m = Membership()
    m.join(0)
    assert m.state(0) == JOINING
    assert m.guard_post(0) == PostStatus.OK  # joining ranks accept posts
    m.activate(0)
    assert m.state(0) == ACTIVE and m.active_ranks() == (0,)
    assert m.begin_drain(0) is True
    assert m.state(0) == DRAINING and m.active_ranks() == ()
    assert m.finish_leave(0) is True
    assert m.state(0) == GONE
    kinds = [e[0] for e in m.drain_events()]
    assert kinds == ["join", "active", "drain", "gone"]
    # epochs strictly increase across transitions
    m2 = Membership()
    m2.join(1)
    m2.activate(1)
    epochs = [e[2] for e in m2.drain_events()]
    assert epochs == sorted(epochs) and len(set(epochs)) == len(epochs)


def test_double_leave_is_idempotent():
    """A second leave() — from a racing controller or a retried teardown —
    is a no-op at every stage, and the on_gone hook runs exactly once."""
    hook_runs = []
    m = Membership()
    m.join(0, on_gone=lambda member: hook_runs.append(member.rank))
    m.activate(0)
    assert m.begin_drain(0) is True
    assert m.begin_drain(0) is False  # already draining
    assert m.finish_leave(0) is True
    assert m.finish_leave(0) is False  # already gone
    assert m.begin_drain(0) is False  # gone ranks can't re-drain
    assert hook_runs == [0]


def test_join_while_another_rank_drains():
    """A join during a drain is independent: the newcomer becomes routable
    while the leaver quiesces, and the epoch totally orders the two."""
    m = Membership()
    m.join(0)
    m.activate(0)
    m.begin_drain(0)
    member = m.join(1)  # joins mid-drain
    m.activate(1)
    assert m.state(0) == DRAINING and m.state(1) == ACTIVE
    assert m.active_ranks() == (1,)
    assert m.guard_post(0) == PostStatus.EAGAIN_DRAINING
    assert m.guard_post(1) == PostStatus.OK
    m.finish_leave(0)
    assert m.epoch > member.epoch  # the leave happened-after the join


def test_rejoin_only_after_gone():
    m = Membership()
    m.join(0)
    with pytest.raises(ValueError, match="already a member"):
        m.join(0)
    m.activate(0)
    with pytest.raises(ValueError, match="activate from"):
        m.activate(0)
    m.begin_drain(0)
    m.finish_leave(0)
    again = m.join(0)  # GONE rank re-joins at a fresh epoch
    assert again.state == JOINING and again.epoch == m.epoch


def test_post_racing_a_leave_requeues_never_drops():
    """The post-side arbiter: a post that raced a leave gets the *typed*
    EAGAIN_DRAINING (falsy, like every resource EAGAIN) and the caller
    re-queues to a surviving rank — zero loss by construction."""
    m = Membership()
    for r in (0, 1):
        m.join(r)
        m.activate(r)
    inbox = {0: [], 1: []}
    pending = [(0, i) for i in range(8)]  # all aimed at rank 0
    m.begin_drain(0)  # the leave races the posts
    delivered = []
    while pending:
        rank, msg = pending.pop(0)
        status = m.guard_post(rank)
        if status:
            inbox[rank].append(msg)
            delivered.append(msg)
        else:
            assert status == PostStatus.EAGAIN_DRAINING and not status
            successor = m.active_ranks()[0]
            pending.append((successor, msg))  # re-queue, never drop
    assert inbox[0] == [] and sorted(inbox[1]) == list(range(8))
    assert sorted(delivered) == list(range(8))


def test_stale_completion_discarded_exactly_once():
    """The completion-side arbiter: a completion dispatched under a view
    whose epoch predates the member's departure is discarded (counted),
    and a live member's completions always land."""
    m = Membership()
    m.join(0)
    m.activate(0)
    view = m.view()  # routing decision taken here
    assert m.admit_completion(0, view.epoch) is True  # live: admitted
    m.begin_drain(0)
    m.finish_leave(0)
    assert m.admit_completion(0, view.epoch) is False  # stale: discarded
    assert m.stale_discards == 1
    m.join(0)  # rank reused at a fresh epoch
    m.activate(0)
    assert m.admit_completion(0, m.view().epoch) is True  # fresh view lands
    assert m.stale_discards == 1  # the discard happened exactly once


def test_view_is_immutable_snapshot():
    m = Membership()
    m.join(0)
    m.activate(0)
    view = m.view()
    assert 0 in view and view.active == (0,)
    m.begin_drain(0)
    assert 0 in view  # the snapshot does not move...
    assert 0 not in m.view()  # ...the live table does
    assert m.view().epoch > view.epoch


# --------------------------------------- abandoned-worker liveness sweep
def test_abandoned_owner_swept_and_rank_reused():
    """Satellite regression: a worker that dies WITHOUT leave() is reaped
    by the finalizer backstop — sweep() forces it to GONE, its on_gone
    hook returns the slots, and the rank is reusable."""
    freed = []
    m = Membership()

    class Owner:  # stands for the worker object whose lifetime we track
        pass

    owner = Owner()
    m.join(0, owner=owner, on_gone=lambda member: freed.append(member.rank))
    m.activate(0)
    assert m.sweep() == []  # owner alive: nothing to reap
    del owner
    gc.collect()
    assert m.sweep() == [0]
    assert m.state(0) == GONE and freed == [0]
    assert m.sweep() == []  # idempotent
    m.join(0)  # the slot is back in the pool
    assert m.state(0) == JOINING


def test_clean_leave_detaches_finalizer():
    """After an orderly leave the finalizer must NOT fire when the owner
    is later collected — no double-free of the rank's slots."""
    m = Membership()

    class Owner:
        pass

    owner = Owner()
    m.join(0, owner=owner)
    m.activate(0)
    m.begin_drain(0)
    m.finish_leave(0)
    del owner
    gc.collect()
    assert m.sweep() == []  # nothing abandoned: the leave already ran


# ----------------------------------------------- hypothesis: exactly-once
@settings(max_examples=60, deadline=None)
@given(
    st.lists(
        st.one_of(
            st.tuples(st.just("join"), st.integers(0, 3)),
            st.tuples(st.just("leave"), st.integers(0, 3)),
            st.tuples(st.just("post"), st.integers(0, 3)),
        ),
        max_size=40,
    )
)
def test_random_schedule_delivers_exactly_once(schedule):
    """Property: under ANY interleaving of join/leave/post, every posted
    message is delivered exactly once after quiesce — an EAGAIN_DRAINING
    re-queues to a survivor, a leave never loses, and nothing duplicates."""
    m = Membership()
    inbox = {r: [] for r in range(5)}
    pending = []  # (rank, msg-id) awaiting (re-)post
    next_msg = 0

    def deliver(rank, msg):
        status = m.guard_post(rank)
        if status:
            inbox[rank].append(msg)
            return True
        pending.append(msg)  # typed refusal: re-queue, never drop
        return False

    for op, rank in schedule:
        if op == "join":
            if m.state(rank) in (None, GONE):
                m.join(rank)
                m.activate(rank)
        elif op == "leave":
            if m.begin_drain(rank):
                m.finish_leave(rank)
        else:  # post
            deliver(rank, next_msg)
            next_msg += 1
            # retry the backlog against whoever is active right now
            active = m.active_ranks()
            if active:
                backlog, pending[:] = list(pending), []
                for msg in backlog:
                    deliver(active[0], msg)
    # quiesce: guarantee a live member, then flush the backlog
    if not m.active_ranks():
        m.join(4)
        m.activate(4)
    for msg in list(pending):
        assert deliver(m.active_ranks()[0], msg)
    got = sorted(x for box in inbox.values() for x in box)
    assert got == list(range(next_msg))  # exactly once: no loss, no dupes


# ------------------------------------------------- the worker thread pool
class _Endpoint:
    """Minimal progress endpoint for pool tests."""

    def progress_work(self):
        return False


def test_pool_resize_spawns_and_joins_real_threads():
    ep = _Endpoint()
    base = threading.active_count()
    pool = ProgressWorkerPool(weakref.ref(ep), "t-prg")
    pool.resize(3)
    assert pool.size() == 3 and pool.spawned_total == 3
    assert threading.active_count() == base + 3
    pool.resize(1)  # shrink joins the surplus — not just stops them
    assert pool.size() == 1 and pool.joined_total == 2
    assert threading.active_count() == base + 1
    pool.resize(2)  # regrow gets fresh serials, survivors undisturbed
    assert pool.size() == 2 and pool.spawned_total == 4
    pool.close()
    pool.close()  # idempotent
    assert pool.size() == 0 and threading.active_count() == base


def test_spawn_worker_census():
    done = threading.Event()
    before = live_worker_count()
    t = spawn_worker(done.wait, name="census-probe")
    assert live_worker_count() == before + 1
    done.set()
    t.join(timeout=5.0)
    assert live_worker_count() == before


# ------------------------------------------- the elastic controller
class _FakeEngine:
    def __init__(self, occ=0.0):
        self.occ = occ

    def reap_latency_stats(self):
        return {"occupancy_ewma": self.occ}


def _controller(occ, lo=0, hi=2, **kw):
    ep = _Endpoint()
    pool = ProgressWorkerPool(weakref.ref(ep), "ec-prg")
    pool.resize(lo)
    eng = _FakeEngine(occ)
    ctl = ElasticProgressController(eng, pool, lo, hi, **kw)
    return ctl, eng, pool, ep


def test_controller_grows_under_backlog_and_respects_hi():
    ctl, eng, pool, _ep = _controller(occ=8.0, lo=0, hi=2, cooldown=0.0)
    assert ctl.maybe_resize() and pool.size() == 1
    assert ctl.maybe_resize() and pool.size() == 2
    assert not ctl.maybe_resize() and pool.size() == 2  # pinned at hi
    assert ctl.grows == 2 and ctl.shrinks == 0
    pool.close()


def test_controller_shrinks_when_idle_and_respects_lo():
    ctl, eng, pool, _ep = _controller(occ=8.0, lo=1, hi=3, cooldown=0.0)
    ctl.maybe_resize()
    ctl.maybe_resize()
    assert pool.size() == 3
    eng.occ = 0.1  # reapers idle: dedicated cores are wasted
    assert ctl.maybe_resize() and pool.size() == 2
    assert ctl.maybe_resize() and pool.size() == 1
    assert not ctl.maybe_resize() and pool.size() == 1  # pinned at lo
    pool.close()


def test_controller_hysteresis_band_holds_steady():
    """Occupancy between the thresholds is the stable band: neither grow
    nor shrink fires, however often the controller is polled."""
    ctl, eng, pool, _ep = _controller(occ=8.0, lo=0, hi=2, cooldown=0.0)
    ctl.maybe_resize()
    eng.occ = 2.0  # inside (shrink_at=1.0, grow_at=4.0)
    for _ in range(10):
        assert not ctl.maybe_resize()
    assert pool.size() == 1 and ctl.resizes == 1
    pool.close()


def test_naive_controller_oscillates_where_hysteresis_holds():
    """hysteresis=False degenerates to one threshold + no cooldown — at
    occupancy exactly on the threshold it grows then immediately shrinks,
    forever; the hysteresis band holds after one resize.  (The DES
    elasticity_study measures the same contrast with charged costs.)"""
    naive, eng_n, pool_n, _e1 = _controller(occ=4.0, lo=0, hi=1, hysteresis=False)
    hyst, eng_h, pool_h, _e2 = _controller(occ=4.0, lo=0, hi=1, cooldown=0.0)
    for _ in range(6):
        naive.maybe_resize()
        hyst.maybe_resize()
    assert naive.resizes >= 2 * max(hyst.resizes, 1)
    assert hyst.resizes == 1  # grew once, then held
    pool_n.close()
    pool_h.close()


def test_controller_cooldown_bounds_resize_rate():
    ctl, eng, pool, _ep = _controller(occ=8.0, lo=0, hi=2, cooldown=30.0)
    assert ctl.maybe_resize()
    assert not ctl.maybe_resize()  # inside the cooldown window
    assert pool.size() == 1
    pool.close()


def test_controller_rejects_bad_bounds():
    ep = _Endpoint()
    pool = ProgressWorkerPool(weakref.ref(ep), "bad")
    with pytest.raises(ValueError, match="bounds"):
        ElasticProgressController(_FakeEngine(), pool, 3, 1)


# ------------------------------------------------- parity with the reference
def _apply(m, schedule):
    """Drive one Membership through a schedule; returns what it observed."""
    seen = []

    class Owner:
        pass

    owners = {}
    for op, rank in schedule:
        if op == "join":
            if m.state(rank) in (None, GONE):
                owners[rank] = Owner()
                m.join(rank, owner=owners[rank])
                seen.append(("view", m.view().epoch, m.view().active))
        elif op == "activate":
            if m.state(rank) == JOINING:
                m.activate(rank)
        elif op == "drain":
            seen.append(("drain", rank, m.begin_drain(rank)))
        elif op == "leave":
            seen.append(("leave", rank, m.finish_leave(rank)))
        elif op == "abandon":  # the owner has no cycles: dropping it finalizes it
            owners.pop(rank, None)
            seen.append(("sweep", tuple(m.sweep())))
        elif op == "post":
            seen.append(("post", rank, m.guard_post(rank).value))
        else:  # a completion under a view two epochs old
            seen.append(("complete", rank, m.admit_completion(rank, max(0, m.epoch - 2))))
    seen.append(("states", tuple(m.state(r) for r in range(4)), m.epoch, m.stale_discards, m.active_ranks()))
    return m.drain_events(), seen


@pytest.mark.parametrize("seed", range(12))
def test_same_schedule_same_events_as_the_reference(seed):
    """A seeded random schedule of joins, activations, drains, leaves,
    abandoned owners, posts and completions through the reference's
    Membership and the port's: the same event log, post statuses, stale
    discards, states and epochs."""
    rng = np.random.default_rng(seed)
    ops = ["join", "activate", "drain", "leave", "abandon", "post", "complete"]
    schedule = [(ops[int(rng.integers(len(ops)))], int(rng.integers(4))) for _ in range(60)]
    events, seen = _apply(Membership(), schedule)
    j_events, j_seen = _apply(JMembership(), schedule)
    assert events == j_events
    assert seen == j_seen
    assert events  # the schedule moved the table
