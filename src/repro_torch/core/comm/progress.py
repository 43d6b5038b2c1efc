"""ONE progress engine for every executor (paper §3.4, §5.3).

The paper names **explicit progressing** and **resource-contention
mitigation** as communication needs MPI covers poorly, and the companion
proposals (arXiv 2503.15400; *LCI: a Lightweight Communication Interface*)
argue the progress/completion engine should be a first-class,
policy-parameterized component — not an ad-hoc loop re-written inside every
backend.  Before this module, that loop existed three times in this repo
(the LCI parcelport, the MPI parcelport, and ~270 duplicated lines in the
DES).  Now it exists once.

The engine is a **decision sequence**, not an executor: :meth:`ProgressEngine.
step` is a generator that yields small *ops* — ``drain_retries``,
``progress``, ``reap``, ``dispatch``, lock ops — and receives each op's
result back via ``send()``.  The caller supplies the op semantics:

* the **functional parcelports** drive it with :func:`run_step`, executing
  each op against real devices and completion objects;
* the **DES** drives it from a simulation process, charging calibrated
  :class:`~repro.amtsim.costs.Mechanisms` costs (and simulating lock
  contention) per op, then feeding the result back.

Because both layers replay the *same* op sequence for the same
configuration, the protocol-path and completion-dispatch decisions cannot
drift — the engine-parity suite (tests/test_progress_engine.py) asserts
ordered decision traces are identical across layers.

One step is the canonical loop::

    drain retries  →  progress device(s)  →  reap completions  →
    dispatch by kind  →  (implicit mode: poll on an empty reap)

parameterized by

* a :class:`ProgressPolicy` — who invokes the progress engine and under
  which lock discipline (§5.3): worker-polling implicit, explicit
  try-lock, the blocking-lock "catastrophic" combination, the MPI
  request-pool discipline, and **dedicated progress workers** (§3.3.4's
  omitted experiment, the ``lci_prg{n}`` family);
* a :class:`CompletionRouter` — the ordered :class:`~repro.core.comm.
  interface.CompletionTarget` sources a worker reaps each step, shared
  vs per-device completion queues (§3.3.3, the ``lci_shared_cq`` axis).

Op vocabulary (a tuple ``(kind, *args)``; results flow back via ``send``):

======================  =======================================================
op                      meaning / expected result
======================  =======================================================
``step_trylock``        whole-step try-lock (MPI request-pool discipline);
                        ``False`` aborts the step
``step_unlock``         release the step lock
``big_lock``            blocking library big lock (MPI) around the step
``big_unlock``          release it
``drain_retries``       retry backpressured posts under the budget → moved?
``implicit_tax``        implicit progress rides on a completion test: the
                        cost of that test (DES charges it; functional no-op)
``progress`` *d*        explicitly drive device *d*'s progress engine → moved?
``poll`` *d*            completion-test-driven progress on device *d* → moved?
``dev_lock`` *d*        blocking coarse lock on device *d* (§5.3)
``dev_trylock`` *d*     try-lock; ``False`` skips the device's reaps
``dev_unlock`` *d*      release the coarse lock
``reap_begin`` *s d*    entering source *s* on device *d* (platform CQ-lock
                        / poll-sweep costs live here)
``reap`` *s d*          one completed item from source *s* (None = empty)
``dispatch`` *s d i*    dispatch item *i* by kind → did it advance anything?
``reap_end`` *s d*      leaving the source
``flush``               deliver work deferred outside the library locks
======================  =======================================================
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "LOCK_NONE",
    "LOCK_TRY",
    "LOCK_BLOCK",
    "PROGRESS_EXPLICIT",
    "PROGRESS_IMPLICIT",
    "ROLE_TASK",
    "ROLE_PROGRESS",
    "ProgressPolicy",
    "CompletionSource",
    "CompletionRouter",
    "ProgressEngine",
    "run_step",
]

PROGRESS_EXPLICIT = "explicit"
PROGRESS_IMPLICIT = "implicit"

# Coarse-lock disciplines (§5.3).  String values match
# :class:`repro.core.device.LockMode` — comm/ sits *below* device.py in the
# layer diagram, so the constants live here rather than being imported up.
LOCK_NONE = "none"
LOCK_TRY = "try"
LOCK_BLOCK = "block"

#: an ordinary worker thread: runs tasks, pumps background work when idle
ROLE_TASK = "task"
#: a core reserved to drive the progress engine only (§3.3.4, ``lci_prg{n}``)
ROLE_PROGRESS = "progress"


@dataclass(frozen=True)
class ProgressPolicy:
    """Who drives the progress engine, and under which lock discipline.

    The four policies the paper's §5.3 ladder studies, plus the MPI
    request-pool structure, all parameterize the same step loop:

    * :meth:`worker_polling` — *implicit* progress: every worker polls
      completion objects; the engine runs only on an empty poll (the MPI
      behaviour, ``progress_mode='implicit'``).
    * :meth:`explicit_trylock` — explicit progress under a coarse try
      lock: a contended call gives up (the scheduler has other work).
    * :meth:`blocking` — the **catastrophic** §5.3 combination: explicit
      eager progress under a coarse *blocking* lock (every idle worker
      piles onto the same futex).
    * :meth:`dedicated` — ``n`` workers are reserved to drive the engine
      (``ROLE_PROGRESS``); task workers fall back to implicit polling.
    * :meth:`mpi_request_pool` — the whole step behind a pool try-lock
      and the library big lock, progress fused into completion tests.
    """

    progress_mode: str = PROGRESS_EXPLICIT  # 'explicit' | 'implicit'
    lock_mode: str = LOCK_NONE  # coarse per-device lock: none|try|block
    step_lock: bool = False  # whole step behind a try-lock (MPI pools)
    big_lock: bool = False  # whole step under the blocking big lock (MPI)
    dedicated_workers: int = 0  # cores reserved for ROLE_PROGRESS

    # -- named policies (§5.3 ladder) ---------------------------------------
    @classmethod
    def worker_polling(cls) -> "ProgressPolicy":
        return cls(progress_mode=PROGRESS_IMPLICIT)

    @classmethod
    def explicit_trylock(cls) -> "ProgressPolicy":
        return cls(progress_mode=PROGRESS_EXPLICIT, lock_mode=LOCK_TRY)

    @classmethod
    def blocking(cls) -> "ProgressPolicy":
        """Blocking lock + eager explicit progress — §5.3's catastrophe."""
        return cls(progress_mode=PROGRESS_EXPLICIT, lock_mode=LOCK_BLOCK)

    @classmethod
    def dedicated(cls, n: int) -> "ProgressPolicy":
        return cls(progress_mode=PROGRESS_IMPLICIT, dedicated_workers=n)

    @classmethod
    def mpi_request_pool(cls) -> "ProgressPolicy":
        return cls(progress_mode=PROGRESS_EXPLICIT, step_lock=True, big_lock=True)

    @classmethod
    def for_config(cls, cfg: Any) -> "ProgressPolicy":
        """Derive the policy from a parcelport config (``LCIPPConfig`` or
        the DES ``SimConfig`` — the same fields, by design)."""
        if getattr(cfg, "mpi", False):
            return cls.mpi_request_pool()
        return cls(
            progress_mode=cfg.progress_mode,
            lock_mode=cfg.lock_mode,
            dedicated_workers=getattr(cfg, "progress_workers", 0),
        )

    def variant(self, **kw) -> "ProgressPolicy":
        return replace(self, **kw)


@dataclass(frozen=True)
class CompletionSource:
    """One place completed operations surface (§3.3.2 / §5.2).

    The engine never interprets ``name`` — the adapter executing the ops
    does.  What the engine *does* own: the reap batch, whether the source
    is replicated per device, which devices a worker sweeps, whether reaps
    happen under the policy's coarse device lock, and whether the source
    belongs to the progress engine itself (``progress_side`` — what a
    dedicated ``ROLE_PROGRESS`` worker reaps; client-side completion
    objects stay with task workers)."""

    name: str
    batch: int = 8
    per_device: bool = False  # one instance of this source per device
    sweep: str = "own"  # 'own' = the worker's mapped device; 'all' = rotate
    locked: bool = False  # reap under the policy's coarse device lock
    progress_side: bool = False  # reaped by dedicated progress workers too


class CompletionRouter:
    """The ordered completion sources one step reaps (§3.3.3).

    ``shared`` scope routes every completion through one MPMC queue (LCI's
    default: load balance across devices); ``device`` scope gives each
    device its own queue (less queue contention, per-device imbalance) —
    workers still sweep all device queues, own-device first, so a
    single-threaded pump keeps liveness."""

    def __init__(self, sources: Sequence[CompletionSource], ndevices: int = 1):
        self.ndevices = max(1, ndevices)
        self._sources: Tuple[CompletionSource, ...] = tuple(sources)
        self._progress_side = tuple(s for s in self._sources if s.progress_side)

    def sources(self, role: str = ROLE_TASK) -> Tuple[CompletionSource, ...]:
        return self._progress_side if role == ROLE_PROGRESS else self._sources

    def devices_for(self, source: CompletionSource, wid: int, role: str) -> Tuple[int, ...]:
        """Which device instances of a per-device source this worker reaps
        (static worker→device mapping, §3.3.3; ``sweep='all'`` rotates so
        the worker's own device comes first)."""
        if not source.per_device:
            return (-1,)
        nd = self.ndevices
        start = wid % nd
        if role == ROLE_PROGRESS or source.sweep == "all":
            return tuple((start + k) % nd for k in range(nd))
        return (start,)


class ProgressEngine:
    """The single step loop (see module docstring).

    One engine per parcelport (functional) or per simulated world (DES);
    the engine is pure decision logic, so it carries no device or queue
    references — those live behind the adapter executing its ops.

    ``trace`` (when set to a list) records normalized protocol decisions
    (``('send', path, nfollowups)``, ``('header', path)``, ``('chunk',)``,
    ``('deliver', n)``) pushed by the adapters via :meth:`record` — the
    engine-parity suite compares these across layers."""

    #: EWMA smoothing for the reap statistics (one knob, shared with the DES)
    REAP_EWMA_ALPHA = 0.2

    def __init__(self, policy: ProgressPolicy, router: CompletionRouter, ndevices: int = 1):
        self.policy = policy
        self.router = router
        self.ndevices = max(1, ndevices)
        self.trace: Optional[List[tuple]] = None
        # cheap reap-side instrumentation (no per-item stamps, no trace
        # entries — decision-trace parity is unaffected): gap between
        # non-empty reap sweeps and items reaped per sweep, as EWMA +
        # high-water.  The ElasticProgressController consumes these.
        self._reap_last: Optional[float] = None
        self._reap_gap_ewma = 0.0
        self._reap_gap_high = 0.0
        self._reap_occ_ewma = 0.0
        self._reap_occ_high = 0
        self._reap_sweeps = 0
        self._reap_items = 0

    # -- decision trace ------------------------------------------------------
    def record(self, *event: Any) -> None:
        if self.trace is not None:
            self.trace.append(event)

    # -- reap-latency instrumentation (§3.3.4 adaptivity signal) -------------
    def _note_reap_sweep(self, n: int) -> None:
        """Account one non-empty reap sweep: ``n`` items came off a
        completion source in one batch."""
        alpha = self.REAP_EWMA_ALPHA
        now = time.monotonic()
        if self._reap_last is not None:
            gap = now - self._reap_last
            self._reap_gap_ewma += alpha * (gap - self._reap_gap_ewma)
            if gap > self._reap_gap_high:
                self._reap_gap_high = gap
        self._reap_last = now
        self._reap_occ_ewma += alpha * (n - self._reap_occ_ewma)
        if n > self._reap_occ_high:
            self._reap_occ_high = n
        self._reap_sweeps += 1
        self._reap_items += n

    def reap_latency_stats(self) -> Dict[str, float]:
        """Cheap counters for the elastic-progress decision (and results
        reporting): EWMA + high-water of the gap between non-empty reap
        sweeps (wall seconds — meaningful on the functional layer; the DES
        keeps its own sim-time latency) and of the per-sweep occupancy
        (items per batch — backlog pressure, meaningful on both layers)."""
        return {
            "reap_gap_ewma": self._reap_gap_ewma,
            "reap_gap_high": self._reap_gap_high,
            "occupancy_ewma": self._reap_occ_ewma,
            "occupancy_high": float(self._reap_occ_high),
            "sweeps": float(self._reap_sweeps),
            "items": float(self._reap_items),
        }

    # -- the one step loop ---------------------------------------------------
    def step(self, wid: int, role: str = ROLE_TASK):
        """One background-work invocation: yields ops, returns ``moved``.

        ``role=ROLE_PROGRESS`` is the dedicated-worker variant of the same
        loop: progress runs on *every* device regardless of progress_mode,
        and only progress-side sources are reaped."""
        pol = self.policy
        progressed = False
        if pol.step_lock:
            # MPI request-pool discipline: one thread in the step at a time
            if not (yield ("step_trylock",)):
                return False
        if pol.big_lock:
            yield ("big_lock",)
        # 1. drain retries: backpressured posts first (§3.3.4 throttle)
        progressed = bool((yield ("drain_retries",))) or progressed
        # 2. progress device(s), per the policy
        if pol.progress_mode == PROGRESS_EXPLICIT or role == ROLE_PROGRESS:
            progressed = (yield from self._progress_pass(wid, role, "progress")) or progressed
        else:
            # implicit progress rides on a (possibly failed) completion
            # test — charge the test, progress happens at reduced rate
            yield ("implicit_tax",)
        # 3+4. reap completions and dispatch by kind
        polled = False
        for src in self.router.sources(role):
            for d in self.router.devices_for(src, wid, role):
                if src.locked and pol.lock_mode == LOCK_BLOCK:
                    yield ("dev_lock", d)
                elif src.locked and pol.lock_mode == LOCK_TRY:
                    if not (yield ("dev_trylock", d)):
                        continue
                yield ("reap_begin", src, d)
                sweep_items = 0
                for _ in range(src.batch):
                    item = yield ("reap", src, d)
                    if item is None:
                        break
                    polled = True
                    sweep_items += 1
                    progressed = bool((yield ("dispatch", src, d, item))) or progressed
                yield ("reap_end", src, d)
                if sweep_items:
                    self._note_reap_sweep(sweep_items)
                if src.locked and pol.lock_mode != LOCK_NONE:
                    yield ("dev_unlock", d)
        # 5. implicit mode: progress only as a side effect of an *empty*
        # completion test (the MPI behaviour), then retry parked posts —
        # the poll may have reaped send completions and freed resources
        if pol.progress_mode == PROGRESS_IMPLICIT and role == ROLE_TASK and not polled:
            progressed = (yield from self._progress_pass(wid, role, "poll")) or progressed
            progressed = bool((yield ("drain_retries",))) or progressed
        if pol.big_lock:
            yield ("big_unlock",)
        if pol.step_lock:
            yield ("step_unlock",)
        # deliveries deferred outside the library locks (MPI structure)
        progressed = bool((yield ("flush",))) or progressed
        return progressed

    def _progress_pass(self, wid: int, role: str, verb: str):
        """Drive the progress verb on this worker's device — or on every
        device for a dedicated progress worker."""
        moved = False
        nd = self.ndevices
        devs = range(nd) if role == ROLE_PROGRESS else (wid % nd,)
        for d in devs:
            moved = bool((yield (verb, d))) or moved
        return moved


def run_step(engine: ProgressEngine, ops: Any, wid: int, role: str = ROLE_TASK) -> bool:
    """Drive one engine step synchronously (the functional executors).

    ``ops.execute(op) -> result`` supplies the op semantics; the DES has
    its own driver (a simulation process) that charges costs per op.

    If an op raises after a ``step_trylock`` succeeded, the step lock is
    released before the exception propagates — an adapter that implements
    the lock for real (the serving engine does) must not stay wedged
    behind an abandoned generator."""
    gen = engine.step(wid, role)
    result: Any = None
    execute = ops.execute
    step_locked = False
    try:
        while True:
            try:
                op = gen.send(result)
            except StopIteration as stop:
                return bool(stop.value)
            result = execute(op)
            if op[0] == "step_trylock":
                step_locked = bool(result)
            elif op[0] == "step_unlock":
                step_locked = False
    except BaseException:
        if step_locked:
            try:
                execute(("step_unlock",))
            except Exception:
                pass
        raise
