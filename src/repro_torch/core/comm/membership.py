"""Worker lifecycle as one subsystem: members, progress pools, the census.

Port of ``repro/core/comm/membership.py``.  The communication layer
exposes progress and completion signals so the runtime above it can
adapt its resources at run time; this module owns that lifecycle, above
the transports (``ShmemGroup``, ``CollectiveGroup``) and below their
consumers (the serving fleet):

* :class:`Membership` — typed member lifecycle
  ``JOINING → ACTIVE → DRAINING → GONE`` with **epoch-stamped views**:
  a racing post to a departing rank resolves to the typed
  :data:`~repro_torch.core.comm.interface.PostStatus.EAGAIN_DRAINING`
  (the caller re-queues — never loss), and a completion dispatched under
  a stale epoch is discarded exactly once, counted.  A member that dies
  without ``leave()`` is reaped by a **finalizer-based liveness sweep**
  (:meth:`Membership.sweep`), so its slots return to the pool.
* :func:`spawn_worker` / :func:`join_workers` — the one place of the
  port that starts or joins worker threads: a census of live spawned
  workers backs the leak regressions.
* :class:`ProgressWorkerPool` — dedicated progress threads as a
  resizable pool: ``resize()`` spawns or stops-and-JOINS real threads.
* :class:`ElasticProgressController` — grows/shrinks a pool between
  bounds from an engine's ``reap_latency_stats()`` (completion backlog
  per sweep), with hysteresis + cooldown so a noisy signal cannot thrash
  the pool.  Both work against any endpoint with ``progress_work()``.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ...analysis.sanitizer import make_lock, note_access
from .interface import PostStatus

__all__ = [
    "JOINING",
    "ACTIVE",
    "DRAINING",
    "GONE",
    "Member",
    "MembershipView",
    "Membership",
    "ProgressWorkerPool",
    "ElasticProgressController",
    "spawn_worker",
    "join_workers",
    "live_worker_count",
]

# -- member states (the typed lifecycle; transitions only move rightward
#    until GONE, after which the rank may re-join at a fresh epoch) ----------
JOINING = "joining"  # registered; endpoints wiring up, not yet routable
ACTIVE = "active"  # routable: posts and routing shares flow to it
DRAINING = "draining"  # stopped admitting; quiescing in-flight work
GONE = "gone"  # deregistered; the rank's slots are back in the pool

_NEXT = {JOINING: (ACTIVE, DRAINING, GONE), ACTIVE: (DRAINING, GONE), DRAINING: (GONE,), GONE: ()}


# ---------------------------------------------------------------- thread own
# Every worker thread of the port is created and joined here, so the census
# below is exact and leak regressions have one place to look.
_spawned: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()


def spawn_worker(
    target: Callable[..., None],
    *,
    name: str,
    args: Tuple[Any, ...] = (),
    daemon: bool = True,
) -> threading.Thread:
    """Start one worker thread: the one spawn point for the port's
    progress, fleet and executor worker threads."""
    t = threading.Thread(target=target, args=args, name=name, daemon=daemon)
    _spawned.add(t)
    t.start()
    return t


def join_workers(threads: List[threading.Thread], timeout: float = 5.0) -> None:
    """Join each thread with a bounded per-thread timeout (a wedged worker
    must not hang teardown — the daemon flag is the backstop)."""
    for t in threads:
        t.join(timeout=timeout)


def live_worker_count() -> int:
    """Census of live worker threads spawned through :func:`spawn_worker`
    (the lifecycle-leak regression counter)."""
    return sum(1 for t in _spawned if t.is_alive())


# ------------------------------------------------------------------ members
@dataclass
class Member:
    """One tracked worker: rank, typed state, and the epoch of its last
    transition (completions stamped with an older epoch are stale)."""

    rank: int
    state: str = JOINING
    epoch: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)
    #: run once when the member reaches GONE (leave *or* abandon-sweep) —
    #: the hook that returns its slots/segments to the owning pools
    on_gone: Optional[Callable[["Member"], None]] = None
    _finalizer: Any = None


class MembershipView:
    """An immutable epoch-stamped snapshot of the membership.

    Routing decisions take a view, post guards re-check against the live
    table: a post raced against a leave resolves to EAGAIN_DRAINING, and a
    completion dispatched under this view's epoch is discarded if the
    member has since transitioned (exactly once, counted)."""

    __slots__ = ("epoch", "_states")

    def __init__(self, epoch: int, states: Dict[int, str]):
        self.epoch = epoch
        self._states = dict(states)

    def state(self, rank: int) -> Optional[str]:
        return self._states.get(rank)

    @property
    def active(self) -> Tuple[int, ...]:
        return tuple(sorted(r for r, s in self._states.items() if s == ACTIVE))

    def __contains__(self, rank: int) -> bool:
        return self._states.get(rank) == ACTIVE


class Membership:
    """The lifecycle table: typed states, epochs, events, liveness sweep.

    Consumers (the fleet router, the progress pools) own the *mechanics*
    of joining and draining; this table owns the *truth* about who is
    routable, which posts must be refused, and which completions are
    stale.  All transitions are serialized under one lock — lifecycle is
    rare relative to data movement, so a plain mutex is the right tool."""

    def __init__(self) -> None:
        self._lock = make_lock("Membership._lock")
        self._members: Dict[int, Member] = {}
        self._epoch = 0
        #: ranks reaped by the finalizer backstop, awaiting sweep()
        self._abandoned: List[int] = []
        #: lifecycle event log for consumers: (kind, rank, epoch)
        self.events: Deque[Tuple[str, int, int]] = deque()
        #: completions discarded for arriving under a stale epoch
        self.stale_discards = 0

    # -- transitions ---------------------------------------------------------
    def _bump(self, member: Member, state: str, kind: str) -> None:
        # all transitions come through here, under self._lock
        note_access("Membership._members", id(self))
        self._epoch += 1
        member.state = state
        member.epoch = self._epoch
        self.events.append((kind, member.rank, self._epoch))

    def join(
        self,
        rank: int,
        owner: Any = None,
        on_gone: Optional[Callable[[Member], None]] = None,
        **meta: Any,
    ) -> Member:
        """Register a member (state JOINING).  A GONE rank may re-join at a
        fresh epoch — that is how a departed worker's slot is reused.

        ``owner``: the object whose lifetime stands for the worker's; if it
        is garbage-collected without ``leave()``, the finalizer backstop
        marks the rank abandoned and the next :meth:`sweep` reaps it."""
        with self._lock:
            prev = self._members.get(rank)
            if prev is not None and prev.state != GONE:
                raise ValueError(f"rank {rank} already a member (state {prev.state})")
            member = Member(rank=rank, meta=dict(meta), on_gone=on_gone)
            self._bump(member, JOINING, "join")
            self._members[rank] = member
            if owner is not None:
                member._finalizer = weakref.finalize(owner, self._note_abandoned, rank, self._epoch)
            return member

    def activate(self, rank: int) -> None:
        """JOINING → ACTIVE: endpoints wired, landing queues bound — the
        rank becomes routable."""
        with self._lock:
            member = self._members[rank]
            if member.state != JOINING:
                raise ValueError(f"rank {rank}: activate from {member.state}")
            self._bump(member, ACTIVE, "active")

    def begin_drain(self, rank: int) -> bool:
        """Start leaving: stop admitting, quiesce in-flight work.  Returns
        False (a no-op) if the member is already DRAINING or GONE — a
        double leave() is idempotent by construction."""
        with self._lock:
            member = self._members.get(rank)
            if member is None or member.state in (DRAINING, GONE):
                return False
            self._bump(member, DRAINING, "drain")
            return True

    def finish_leave(self, rank: int) -> bool:
        """DRAINING (or JOINING/ACTIVE on a forced reap) → GONE: run the
        member's ``on_gone`` hook and detach the finalizer.  Idempotent."""
        with self._lock:
            member = self._members.get(rank)
            if member is None or member.state == GONE:
                return False
            self._bump(member, GONE, "gone")
            fin, hook = member._finalizer, member.on_gone
            member._finalizer = None
        if fin is not None:
            fin.detach()
        if hook is not None:
            hook(member)
        return True

    # -- liveness sweep (satellite: death without leave) ---------------------
    def _note_abandoned(self, rank: int, joined_epoch: int) -> None:
        # finalizer context: no lock-ordering hazards — just record the rank
        self._abandoned.append(rank)

    def sweep(self) -> List[int]:
        """Reap members whose owners died without ``leave()``: each is
        forced to GONE (its ``on_gone`` hook returns its slots to the
        pool).  Called from the fleet's teardown, and safe
        to call any time."""
        with self._lock:
            pending, self._abandoned = self._abandoned, []
        reaped = []
        for rank in pending:
            if self.finish_leave(rank):
                reaped.append(rank)
        return reaped

    # -- queries -------------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    def state(self, rank: int) -> Optional[str]:
        with self._lock:
            note_access("Membership._members", id(self))
            member = self._members.get(rank)
            return member.state if member is not None else None

    def view(self) -> MembershipView:
        """An epoch-stamped immutable snapshot for routing decisions."""
        with self._lock:
            note_access("Membership._members", id(self))
            return MembershipView(self._epoch, {r: m.state for r, m in self._members.items()})

    def active_ranks(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(r for r, m in self._members.items() if m.state == ACTIVE))

    def guard_post(self, rank: int) -> PostStatus:
        """The post-side race arbiter: a post targeting a DRAINING or GONE
        (or unknown) rank is refused with the *typed*
        ``EAGAIN_DRAINING`` — the caller re-queues, exactly like a
        resource EAGAIN, and nothing is ever lost to a leave."""
        with self._lock:
            note_access("Membership._members", id(self))
            member = self._members.get(rank)
            if member is None or member.state in (DRAINING, GONE):
                return PostStatus.EAGAIN_DRAINING
            return PostStatus.OK

    def admit_completion(self, rank: int, view_epoch: int) -> bool:
        """Completion-side race arbiter: a completion dispatched under a
        view older than the member's last transition is stale — discarded
        exactly once (counted), never double-processed."""
        with self._lock:
            note_access("Membership._members", id(self))
            member = self._members.get(rank)
            if member is None or (member.state == GONE and view_epoch < member.epoch):
                self.stale_discards += 1
                return False
            return True

    def drain_events(self) -> List[Tuple[str, int, int]]:
        """Pop and return every pending lifecycle event (consumer side)."""
        out = []
        while self.events:
            out.append(self.events.popleft())
        return out


# -------------------------------------------------------- progress workers
def _progress_worker_loop(pp_ref: "weakref.ref", stop: threading.Event) -> None:
    """Body of one dedicated progress thread (§3.3.4).

    Holds only a weak reference: when the owning endpoint is dropped the
    thread exits on its own, so an endpoint nobody ``close()``d never
    leaks spinning threads."""
    idle = 0
    while not stop.is_set():
        pp = pp_ref()
        if pp is None:
            return
        moved = pp.progress_work()
        del pp  # drop the strong ref before sleeping so GC can collect
        if moved:
            idle = 0
        else:
            idle += 1
            time.sleep(min(20e-6 * (1 + idle // 4), 2e-3))


class ProgressWorkerPool:
    """Dedicated progress threads as a RESIZABLE pool.

    Each thread runs :func:`_progress_worker_loop` against a weakly-held
    endpoint (anything with ``progress_work()``).  ``resize`` spawns new
    threads through :func:`spawn_worker` and stops-and-JOINS surplus ones
    (each thread has its own stop event, so a shrink never disturbs the
    survivors): every resize joins what it stops, not only close.  Not
    thread-safe by design: exactly one controller (or the owning
    endpoint) resizes it."""

    def __init__(self, endpoint_ref: "weakref.ref", name_prefix: str):
        self._ref = endpoint_ref
        self._prefix = name_prefix
        self._workers: List[Tuple[threading.Thread, threading.Event]] = []
        self._serial = 0
        self.spawned_total = 0
        self.joined_total = 0

    def size(self) -> int:
        return len(self._workers)

    def resize(self, n: int) -> None:
        n = max(0, n)
        while len(self._workers) < n:
            stop = threading.Event()
            t = spawn_worker(
                _progress_worker_loop,
                args=(self._ref, stop),
                name=f"{self._prefix}.{self._serial}",
            )
            self._serial += 1
            self.spawned_total += 1
            self._workers.append((t, stop))
        if len(self._workers) > n:
            surplus = self._workers[n:]
            del self._workers[n:]
            for _, stop in surplus:
                stop.set()
            join_workers([t for t, _ in surplus])
            self.joined_total += len(surplus)

    def close(self) -> None:
        """Stop AND JOIN every thread.  Idempotent."""
        self.resize(0)


class ElasticProgressController:
    """Grow/shrink a :class:`ProgressWorkerPool` between bounds from the
    engine's reap statistics.

    The signal is per-sweep completion-queue occupancy
    (``reap_latency_stats()['occupancy_ewma']``): sustained full batches
    mean the reapers are behind (grow); a near-empty EWMA means dedicated
    cores are stealing cycles for nothing (shrink).  Two guards keep a
    noisy signal from thrashing the pool — **hysteresis** (the shrink
    threshold sits well below the grow threshold) and a **cooldown**
    between resizes; ``hysteresis=False`` degenerates both to a single
    threshold with no cooldown (the naive controller, which oscillates)."""

    def __init__(
        self,
        engine: Any,
        pool: ProgressWorkerPool,
        lo: int,
        hi: int,
        *,
        grow_at: float = 4.0,
        shrink_at: float = 1.0,
        cooldown: float = 0.002,
        hysteresis: bool = True,
    ):
        if not 0 <= lo <= hi:
            raise ValueError(f"elastic bounds must satisfy 0 <= lo <= hi, got ({lo}, {hi})")
        self.engine = engine
        self.pool = pool
        self.lo, self.hi = lo, hi
        self.grow_at = grow_at
        self.shrink_at = shrink_at if hysteresis else grow_at
        self.cooldown = cooldown if hysteresis else 0.0
        self.hysteresis = hysteresis
        self._last_resize = 0.0
        # one controller decision at a time: background_work may be pumped
        # from many task workers, but the pool is single-resizer
        self._decide = threading.Lock()
        self.grows = 0
        self.shrinks = 0

    @property
    def resizes(self) -> int:
        return self.grows + self.shrinks

    def maybe_resize(self) -> bool:
        """One control decision; returns True if the pool was resized.
        Contended calls bail out (a second concurrent decision would act
        on the same sample anyway)."""
        if not self._decide.acquire(blocking=False):
            return False
        try:
            now = time.monotonic()
            if self.cooldown and now - self._last_resize < self.cooldown:
                return False
            occ = self.engine.reap_latency_stats()["occupancy_ewma"]
            n = self.pool.size()
            if occ >= self.grow_at and n < self.hi:
                self.pool.resize(n + 1)
                self.grows += 1
            elif occ <= self.shrink_at and n > self.lo:
                self.pool.resize(n - 1)
                self.shrinks += 1
            else:
                return False
            self._last_resize = now
            return True
        finally:
            self._decide.release()
