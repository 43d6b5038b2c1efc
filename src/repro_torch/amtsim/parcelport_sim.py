"""Discrete-event model of the HPX parcelport stack (quantitative repro).

The functional layer (:mod:`repro_torch.core`) proves the *interfaces*; this layer
carries the *performance* claims, which a 1-core GIL-bound container cannot
measure in wall time.  Every mechanism the paper varies is modeled with a
calibrated cost (:mod:`repro_torch.amtsim.costs`) on a discrete-event kernel
(:mod:`repro_torch.amtsim.des`):

* worker threads are DES processes — they genuinely overlap in simulated
  time except where locks serialize them, reproducing the paper's central
  contention dynamics (§5.3);
* coarse locks additionally charge a **contention penalty per waiter**
  (cache-line bouncing / futex cost — the paper's "most crucial factor");
* devices are injection channels: a message occupies its device for
  ``max(inj_overhead, bytes/bandwidth)`` and lands in the destination
  device's completion queue after ``wire_latency``;
* completion queues (LCRQ/MS/lock, shared or per-device via ``cq_scope``),
  synchronizer pools, tag matching, MPI_Test-only implicit progress, parcel
  aggregation, and the Slingshot-11 libfabric CQ lock (§4.2.3) are explicit
  costs or DES locks.

**The progress engine is not re-implemented here.**  ``background_work``
drives the SAME :class:`~repro_torch.core.comm.progress.ProgressEngine` the
functional parcelports run — one canonical step loop (drain retries →
progress device(s) → reap completions → dispatch by kind), parameterized
by a :class:`~repro_torch.core.comm.progress.ProgressPolicy` — through a
clock/cost adapter: each engine op charges its calibrated
:class:`~repro_torch.amtsim.costs.Mechanisms` cost, and lock ops acquire real DES
locks so contention is *simulated*, never re-coded.  Because both layers
replay one decision sequence, their protocol-path and completion-dispatch
choices cannot drift (tests/test_torch_progress_engine.py compares ordered
decision traces).  ``SimConfig.progress_workers`` reserves cores that only
drive the engine (§3.3.4's omitted experiment, the ``lci_prg{n}`` family).

Follow-up (zero-copy) chunks use a rendezvous: the receiver processes the
header, allocates buffers, posts the receive, and only then does the wire
carry the payload — the same extra round both real parcelports pay for
unexpected large transfers, applied to both families equally.

**Bounded injection** (paper §3.3.4) consumes the *same*
:class:`repro_torch.core.comm.resources.ResourceLimits` object as the functional
fabric — ``SimConfig.limits`` — so the DES and the functional experiments
can never drift field by field: each device may have a finite send ring
(``limits.send_queue_depth``) and a finite pool of registered bounce
buffers for eager messages (``bounce_buffers`` × ``bounce_buffer_size``).
A post that finds the ring full or the pool empty is refused EAGAIN-style
(cost ``t_post_eagain``), counted in ``SimWorld.backpressure_events``, and
parked in a per-device retry queue that background work drains under a
``retry_budget`` — the sender-side throttle the paper credits for LCI's
small-message robustness.  A ring slot stays occupied from post until the
*send completion is reaped* by the progress engine, so a rank that stops
polling its own CQ throttles its own injection, exactly like real hardware.
With ``limits.recv_slots`` set, the *receive* side is bounded the same way
:mod:`repro_torch.core.fabric` bounds it: an arrival that finds every posted
receive descriptor still un-reaped is an **RNR** (receiver-not-ready)
event — counted in ``SimWorld.rnr_events``, parked on the destination
device, and redelivered once the receiver's progress engine reaps backlog
(hardware retransmission, not message loss).  ``SimConfig.rnr_storm``
upgrades that free redelivery to the paper's §3.1 storm model: each RNR'd
arrival is retransmitted after an exponential backoff charged on
``Mechanisms.t_rnr_retry`` (doubling per failed attempt, capped), every
retransmission counted in ``SimWorld.rnr_retries`` — retry storms now cost
wire time, which is how they collapse throughput on real hardware.
Occupancy high-water marks (send ring, bounce pool, retry queue) and the
RNR counters are reported by :meth:`SimWorld.injection_stats`.  All limits
default to 0 (unbounded): the classic model is bit-identical unless a
config opts in, and send completions are only materialized as CQ traffic
in bounded mode.

**Modeled:** thread overlap/contention, per-mechanism software costs, wire
serialization, protocol round trips, aggregation (optionally packed up to
the eager threshold via ``agg_eager`` so an aggregate never spills from
eager into rendezvous), and injection-resource exhaustion.  **Abstracted
away:** real payload bytes (sizes are integers; serialization is a per-byte
cost), wire-level framing overhead, NIC descriptor formats, and memory
registration (a bounce buffer is a counter, not memory).

Variant names match :mod:`repro_torch.core.variants`, so benchmarks sweep the same
configuration space as the paper's Figs 3-9.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Generator, List, Optional, Tuple

from ..core.comm.progress import (
    ROLE_PROGRESS,
    ROLE_TASK,
    CompletionRouter,
    CompletionSource,
    ProgressEngine,
    ProgressPolicy,
)
from ..core.comm.resources import ResourceLimits
from ..core.device import LockMode
from ..core.lci_parcelport import LCIPPConfig
from ..core.variants import VARIANTS
from .costs import DEFAULT_MECHANISMS, EXPANSE, Mechanisms, Platform
from .des import Acquire, Env, Lock, Store, Timeout

__all__ = ["SimWorld", "SimConfig", "Task", "sim_config_for_variant", "HEADER_BYTES", "PIGGYBACK_LIMIT"]

HEADER_BYTES = 64
PIGGYBACK_LIMIT = 8192  # nzc chunks up to this ride on the header (paper §4.2.2)


@dataclass
class SimConfig:
    """Variant knobs (mirrors LCIPPConfig) + which library family it is."""

    name: str = "lci"
    mpi: bool = False
    aggregation: bool = False
    header_mode: str = "put"  # 'put' | 'sendrecv'
    header_comp: str = "queue"  # 'queue' | 'sync'
    followup_comp: str = "queue"  # 'queue' | 'sync'
    cq_kind: str = "lcrq"
    # Completion-queue topology (§3.3.3, mirrors LCIPPConfig.cq_scope):
    # 'shared' = one queue per rank (contention pools across devices);
    # 'device' = one per device (contention scoped to each device).
    cq_scope: str = "shared"
    ndevices: int = 2
    lock_mode: str = LockMode.NONE
    progress_mode: str = "explicit"  # 'explicit' | 'implicit'
    # paper §3.3.4's omitted experiment: reserve n cores that ONLY drive
    # the progress engine (never execute tasks) — the lci_prg{n} family
    progress_workers: int = 0
    # Elastic progress bounds (the lci_eprg{lo}_{hi} family): the
    # dedicated pool starts at lo and an elastic controller grows/shrinks
    # it between (lo, hi) from sampled reap occupancy, charging
    # Mechanisms.t_worker_join / t_worker_drain per resize.
    elastic_progress: Optional[Tuple[int, int]] = None
    # DES-only: disable hysteresis + cooldown on the elastic controller —
    # the naive oscillating baseline elasticity_study compares against.
    elastic_hysteresis: bool = True
    # Protocol engine: payloads up to this size ship as ONE eager message
    # (bounce-buffer copy cost, no rendezvous round trip); 0 disables the
    # eager path beyond plain header piggybacking.
    eager_threshold: int = PIGGYBACK_LIMIT
    # Threshold-aware aggregation (mirrors LCIPPConfig.agg_eager): the
    # aggregation drain packs parcels into batches of at most
    # eager_threshold bytes, so each aggregate still ships eager.
    agg_eager: bool = False
    # RNR retry storms (§3.1): RNR'd arrivals are
    # retransmitted under exponential backoff charged on t_rnr_retry
    # instead of redelivered free on reap.  Only meaningful with
    # limits.recv_slots > 0; the default keeps the model bit-identical.
    rnr_storm: bool = False
    # Bounded injection/receive (§3.3.4): the SAME ResourceLimits object
    # the functional fabric consumes — never per-field mirrors (gated by
    # the analyzer's gate-resource-mirror).  A refused post costs t_post_eagain and parks in
    # a per-device retry queue drained by background work; with recv_slots
    # set, over-backlogged arrivals are RNR events redelivered on reap.
    limits: ResourceLimits = field(default_factory=ResourceLimits)

    # read-only delegates into the shared resource model ---------------------
    @property
    def send_queue_depth(self) -> int:
        return self.limits.send_queue_depth

    @property
    def bounce_buffers(self) -> int:
        return self.limits.bounce_buffers

    @property
    def bounce_buffer_size(self) -> int:
        return self.limits.bounce_buffer_size

    @property
    def retry_budget(self) -> int:
        return self.limits.retry_budget

    @property
    def recv_slots(self) -> int:
        return self.limits.recv_slots

    @property
    def bounded_injection(self) -> bool:
        return self.limits.bounded


#: LCIPPConfig fields copied verbatim into SimConfig — the shared variant
#: axes.  Exhaustive by construction: tests/test_torch_progress_engine.py fails
#: if LCIPPConfig grows a shared knob that is not mapped here.
SHARED_CONFIG_FIELDS = (
    "aggregation",
    "header_mode",
    "header_comp",
    "followup_comp",
    "cq_kind",
    "cq_scope",
    "ndevices",
    "lock_mode",
    "progress_mode",
    "progress_workers",
    "elastic_progress",
    "eager_threshold",
    "agg_eager",
    "limits",
)


def sim_config_for_variant(name: str) -> SimConfig:
    """Translate ANY :mod:`repro_torch.core.variants` name into a SimConfig.

    Resolution goes through the registry view, so parameterized family
    members (``lci_b8``, ``lci_prg2``, ``lci_eager_32k``) resolve on demand
    exactly like fixed names; the field mapping covers every shared axis,
    and ``limits`` is the SAME object the functional variant resolves to —
    the two layers cannot drift (gated by the analyzer's gate-resource-shared)."""
    if name == "mpi":
        return SimConfig(name="mpi", mpi=True, ndevices=1, lock_mode=LockMode.BLOCK)
    if name == "mpi_a":
        return SimConfig(name="mpi_a", mpi=True, aggregation=True, ndevices=1, lock_mode=LockMode.BLOCK)
    cfg: LCIPPConfig = VARIANTS[name]
    return SimConfig(name=name, **{f: getattr(cfg, f) for f in SHARED_CONFIG_FIELDS})


@dataclass
class Task:
    """An AMT task: optional compute burn, then an action callback.

    ``action(worker)`` may return a generator, in which case the worker
    executes it inline (it can yield DES commands, e.g. to send parcels).
    """

    compute: float = 0.0
    action: Optional[Callable[["SimWorker"], Any]] = None


@dataclass
class _Message:
    kind: str  # 'header' | 'followup'
    size: int
    parcel: "ParcelOp"
    # eager messages travel through a registered bounce buffer: under
    # bounded injection they hold one pool buffer from post until the send
    # completion is reaped.
    eager: bool = False


@dataclass
class _MPIReq:
    """One MPI_Request in the parcelport's shared pool (§3.3.2): completion
    is only *noticed* when this request's turn comes up in the round-robin
    single-request MPI_Test."""

    kind: str  # 'send' | 'recv'
    op: "ParcelOp"
    done: bool = False


@dataclass
class ParcelOp:
    """One in-flight parcel (or aggregate of parcels)."""

    src: int
    dst: int
    size: int  # piggyback-eligible payload bytes
    on_delivered: Optional[Callable[[], None]] = None
    send_time: float = 0.0
    nparcels: int = 1
    # zero-copy chunks transfer *sequentially* (paper §3.2: the receiver
    # starts receiving a new chunk only after the prior one completed)
    followup_chunks: List[int] = None  # type: ignore[assignment]
    chunk_idx: int = 0
    src_dev_idx: int = 0
    total_app_bytes: int = 0
    mpi_recv_req: Any = None  # the in-flight follow-up _MPIReq (MPI path)

    def __post_init__(self) -> None:
        if self.followup_chunks is None:
            self.followup_chunks = []


class _SimDevice:
    """One set of communication resources: injection channel + hardware CQ.

    Under bounded injection the device mirrors the functional fabric's
    :class:`~repro_torch.core.fabric.NetDevice`: a finite send ring (``inflight``
    slots, freed when the send completion is reaped from this device's CQ)
    and a finite bounce-buffer pool for eager messages.  Refused posts park
    in ``parked`` until background work retries them.  With
    ``limits.recv_slots`` set the receive side is bounded too: an arrival
    beyond the posted-receive depth is RNR'd into ``rnr_parked`` and
    redelivered once progress reaps backlog — or, under ``rnr_storm``,
    retransmitted with exponential backoff and counted per retry."""

    __slots__ = (
        "env",
        "rank",
        "index",
        "inj_lock",
        "coarse",
        "cq",
        "cq_times",
        "cq_accessors",
        "stats_injected",
        "inflight",
        "inflight_hw",
        "bounce_free",
        "bounce_in_use_hw",
        "parked",
        "parked_hw",
        "stats_backpressure",
        "recv_backlog",
        "rnr_parked",
        "stats_rnr",
        "stats_rnr_retries",
    )

    def __init__(self, env: Env, rank: "SimRank", index: int):
        self.env = env
        self.rank = rank
        self.index = index
        self.inj_lock = Lock(env)  # fine-grained send-queue lock (always present)
        self.coarse = Lock(env)  # coarse library lock (block/try variants)
        self.cq: List[Tuple[str, _Message]] = []
        self.cq_times: List[float] = []  # enqueue stamps, parallel to cq
        self.cq_accessors = 0  # per-device CQ users (cq_scope='device')
        self.stats_injected = 0
        # bounded-injection state (§3.3.4)
        self.inflight = 0  # occupied send-ring slots
        self.inflight_hw = 0  # send-queue occupancy high-water mark
        self.bounce_free = rank.world.cfg.bounce_buffers  # free pool buffers
        self.bounce_in_use_hw = 0  # bounce-pool occupancy high-water mark
        self.parked: Deque[_Message] = deque()  # EAGAIN'd posts awaiting retry
        self.parked_hw = 0  # retry-queue depth high-water mark
        self.stats_backpressure = 0
        # bounded-receive (RNR) state: arrivals occupying posted receives
        # until reaped, and arrivals refused for want of one
        self.recv_backlog = 0
        self.rnr_parked: Deque[Tuple[str, _Message]] = deque()
        self.stats_rnr = 0
        self.stats_rnr_retries = 0


class SimRank:
    """One locality: devices, run queue, completion structures."""

    def __init__(self, world: "SimWorld", rank: int):
        self.world = world
        self.env = world.env
        self.rank = rank
        cfg = world.cfg
        self.devices = [_SimDevice(self.env, self, i) for i in range(cfg.ndevices)]
        self.runq: Store = Store(self.env)  # scheduler run queue
        self.wire_busy_until = 0.0  # shared NIC wire: bandwidth is per rank
        self.cq_accessors = 0  # concurrent LCI-CQ users (contention penalty)
        self.pool_lock = Lock(self.env)  # MPI request pool / synchronizer pool
        # two-sided receive path: "only one thread can proceed along the
        # code path from tag matching to completion signaling" (§3.3.1)
        self.match_lock = Lock(self.env)
        self.lf_lock = Lock(self.env)  # Slingshot-11 libfabric CQ lock (§4.2.3)
        self.agg_queues: Dict[int, List[ParcelOp]] = {}
        self.agg_draining: Dict[int, bool] = {}
        self.agg_lock = Lock(self.env)
        self.handled = 0
        self.sent = 0
        # --- MPI request-pool state (§3.3.2) ---
        # one pre-posted any-source header recv at a time (§3.3.1)
        self.mpi_header_req: Optional[_Message] = None  # completed header, if any
        self.mpi_header_backlog: List[_Message] = []  # unexpected headers
        self.mpi_pool: List["_MPIReq"] = []  # shared request pool, round-robin

    def device_for_worker(self, wid: int) -> _SimDevice:
        return self.devices[wid % len(self.devices)]


class SimWorker:
    """One HPX worker thread (a DES process)."""

    __slots__ = ("rank", "wid", "env", "executed", "role")

    def __init__(self, rank: SimRank, wid: int, role: str = ROLE_TASK):
        self.rank = rank
        self.wid = wid
        self.env = rank.env
        self.executed = 0
        self.role = role

    def run(self) -> Generator:
        world = self.rank.world
        base_sleep = 0.3e-6
        idle_streak = 0
        tasks_since_bg = 0
        while not world.stopped:
            task = self.rank.runq.get_nowait()
            if task is not None:
                idle_streak = 0
                if task.compute > 0:
                    yield Timeout(task.compute)
                if task.action is not None:
                    r = task.action(self)
                    if r is not None:
                        yield from r
                self.executed += 1
                tasks_since_bg += 1
                if tasks_since_bg >= world.bg_interval_tasks:
                    # HPX schedules parcelport background work periodically
                    # even under load, not only on idle cores
                    tasks_since_bg = 0
                    yield from world.background_work(self)
                continue
            tasks_since_bg = 0
            progressed = yield from world.background_work(self)
            if progressed:
                idle_streak = 0
            else:
                # exponential backoff caps DES event volume; progress
                # frequency stays high while traffic flows
                idle_streak += 1
                yield Timeout(min(base_sleep * (1 + idle_streak // 8), 3e-6))


def _build_engine(cfg: SimConfig) -> ProgressEngine:
    """The DES half of the shared-engine contract: the SAME policy builder
    the functional parcelports use, with this layer's completion sources.

    The DES fuses hardware CQ and client completion delivery into one
    queue, so its router has two sources: the cost-only client-side poll
    (``client_poll``) and the per-device hardware CQ (``dev_cq``) — the
    latter reaped under the policy's coarse lock and owned by the progress
    side, which is what dedicated ``ROLE_PROGRESS`` workers sweep (on
    every device).  The MPI family reaps its request pools instead, one
    round-robin MPI_Test each per step (§3.3.2)."""
    policy = ProgressPolicy.for_config(cfg)
    if cfg.mpi:
        router = CompletionRouter(
            [
                CompletionSource("mpi_header", batch=1),
                CompletionSource("mpi_pool", batch=1),
            ],
            ndevices=1,
        )
        return ProgressEngine(policy, router, ndevices=1)
    router = CompletionRouter(
        [
            CompletionSource("client_poll", batch=1),
            CompletionSource(
                "dev_cq", batch=16, per_device=True, sweep="own", locked=True, progress_side=True
            ),
        ],
        ndevices=cfg.ndevices,
    )
    return ProgressEngine(policy, router, ndevices=cfg.ndevices)


class SimWorld:
    """The simulated cluster running one parcelport variant."""

    def __init__(
        self,
        n_ranks: int,
        workers_per_rank: int,
        cfg: SimConfig,
        platform: Platform = EXPANSE,
        mech: Mechanisms = DEFAULT_MECHANISMS,
        bg_interval_tasks: int = 8,
    ):
        self.env = Env()
        self.cfg = cfg
        self.platform = platform
        self.mech = mech
        self.bg_interval_tasks = bg_interval_tasks
        self.ranks = [SimRank(self, r) for r in range(n_ranks)]
        self.workers: List[SimWorker] = []
        self.stopped = False
        self.msg_count = 0
        self.byte_count = 0
        self.backpressure_events = 0  # EAGAIN-style post refusals (§3.3.4)
        self.rnr_events = 0  # receiver-not-ready arrival refusals
        self.rnr_retries = 0  # storm-mode retransmission attempts (§3.1)
        # hardware-CQ residency: time each completion sat
        # un-reaped — the elastic controller's feedback signal
        self.reap_samples: List[float] = []
        self.reap_lat_ewma = 0.0
        self.reap_lat_high = 0.0
        # elastic-pool telemetry
        self.elastic_size = 0  # current dedicated workers per rank (elastic)
        self.grows = 0
        self.shrinks = 0
        if cfg.progress_workers >= workers_per_rank:
            # every core reserved for the engine leaves nobody to pop the
            # run queue: tasks would sit forever and the workload would
            # silently spin to its time cap — fail fast instead
            raise ValueError(
                f"progress_workers={cfg.progress_workers} must be < "
                f"workers_per_rank={workers_per_rank} (no task workers left)"
            )
        # ONE progress engine for the whole world: pure decision logic —
        # per-rank state stays on the ranks; this driver charges the costs.
        self._engine = _build_engine(cfg)
        for r in self.ranks:
            for w in range(workers_per_rank):
                if w < cfg.progress_workers:
                    wk = SimWorker(r, w, role=ROLE_PROGRESS)
                    self.workers.append(wk)
                    self.env.process(self._progress_worker(wk))
                else:
                    wk = SimWorker(r, w)
                    self.workers.append(wk)
                    self.env.process(wk.run())
        # Elastic dedicated-worker pool (lci_eprg{lo}_{hi}): an
        # ADDITIVE per-rank pool of progress-role workers the controller
        # grows/shrinks between (lo, hi), charging Mechanisms costs per
        # resize.  The static progress_workers/progress_mode policy above
        # is untouched — elasticity rides on top of any base variant.
        self._elastic_stops: List[Dict[str, bool]] = []
        if cfg.elastic_progress is not None:
            lo, hi = cfg.elastic_progress
            if not 0 <= lo <= hi:
                raise ValueError(f"elastic_progress bounds must satisfy 0 <= lo <= hi, got {(lo, hi)}")
            for _ in range(lo):
                self._grow_elastic()
            self.env.process(self._elastic_controller(lo, hi))

    @property
    def engine(self) -> ProgressEngine:
        """The shared progress engine (decision-trace hub for parity tests)."""
        return self._engine

    def _progress_worker(self, wk: SimWorker) -> Generator:
        """A core dedicated to the progress engine (§3.3.4, ``lci_prg{n}``):
        the same engine step in its progress role — hardware-CQ sweep on
        EVERY device plus the retry drain of its own mapped device, no
        client-side completion objects.  (Other devices' parked posts are
        drained by the task workers mapped to them, each step.)"""
        while not self.stopped:
            progressed = yield from self.background_work(wk, role=ROLE_PROGRESS)
            if not progressed:
                yield Timeout(0.3e-6)

    # -- elastic dedicated-worker pool ------------------------------------
    def _grow_elastic(self) -> None:
        """Add ONE progress-role worker to every rank, with a shared stop
        flag so a later shrink retires exactly this cohort."""
        stop = {"stopped": False}
        self._elastic_stops.append(stop)
        self.elastic_size += 1
        for r in self.ranks:
            wk = SimWorker(r, len(r.devices) + self.elastic_size, role=ROLE_PROGRESS)
            self.env.process(self._elastic_worker(wk, stop))

    def _elastic_worker(self, wk: SimWorker, stop: Dict[str, bool]) -> Generator:
        while not self.stopped and not stop["stopped"]:
            progressed = yield from self.background_work(wk, role=ROLE_PROGRESS)
            if not progressed:
                yield Timeout(0.3e-6)

    def _elastic_controller(self, lo: int, hi: int) -> Generator:
        """Sample hardware-CQ occupancy and resize the elastic pool between
        (lo, hi).  With hysteresis the grow/shrink thresholds are split and
        a cooldown separates consecutive resizes; the naive controller
        (``elastic_hysteresis=False``) uses one threshold and no cooldown —
        the oscillating baseline the study quantifies.  Each resize charges
        the control-plane cost (t_worker_join / t_worker_drain)."""
        interval = 10e-6
        grow_at, shrink_at = 4.0, 1.0
        cooldown = 50e-6
        if not self.cfg.elastic_hysteresis:
            shrink_at = grow_at
            cooldown = 0.0
        occ_ewma = 0.0
        last_resize = -cooldown
        while not self.stopped:
            yield Timeout(interval)
            occ = sum(len(d.cq) for r in self.ranks for d in r.devices) / max(len(self.ranks), 1)
            occ_ewma += 0.3 * (occ - occ_ewma)
            if self.env.now - last_resize < cooldown:
                continue
            if occ_ewma >= grow_at and self.elastic_size < hi:
                yield Timeout(self.mech.t_worker_join)
                self._grow_elastic()
                self.grows += 1
                last_resize = self.env.now
            elif occ_ewma <= shrink_at and self.elastic_size > lo:
                yield Timeout(self.mech.t_worker_drain)
                self._elastic_stops.pop()["stopped"] = True
                self.elastic_size -= 1
                self.shrinks += 1
                last_resize = self.env.now

    @property
    def resizes(self) -> int:
        return self.grows + self.shrinks

    def reap_p99(self) -> float:
        """p99 of hardware-CQ residency over the whole run (seconds)."""
        if not self.reap_samples:
            return 0.0
        s = sorted(self.reap_samples)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    # --------------------------------------------------------------- helpers
    def injection_stats(self) -> Dict[str, int]:
        """Aggregate bounded-injection/receive counters across every
        device: EAGAIN refusal, RNR and RNR-retransmission counts plus
        occupancy high-water marks for the send ring, the bounce pool, and
        the parked-post retry queue."""
        stats = {
            "backpressure_events": self.backpressure_events,
            "rnr_events": self.rnr_events,
            "rnr_retries": self.rnr_retries,
            "send_queue_hw": 0,
            "bounce_in_use_hw": 0,
            "retry_queue_hw": 0,
        }
        for rank in self.ranks:
            for dev in rank.devices:
                stats["send_queue_hw"] = max(stats["send_queue_hw"], dev.inflight_hw)
                stats["bounce_in_use_hw"] = max(stats["bounce_in_use_hw"], dev.bounce_in_use_hw)
                stats["retry_queue_hw"] = max(stats["retry_queue_hw"], dev.parked_hw)
        return stats

    def _lock_with_contention(self, lock: Lock) -> Generator:
        """Blocking acquire + per-waiter contention penalty (cache-line
        bouncing / futex wake cost grows with the number of contenders)."""
        waiters = len(lock._waiters) + (1 if lock.held else 0)
        yield Acquire(lock)
        penalty = self.mech.t_lock_contention * min(waiters, 32)
        yield Timeout(self.mech.t_lock_uncontended + penalty)

    # ------------------------------------------------------------------ send
    def send_parcel(self, worker: SimWorker, op: ParcelOp) -> Generator:
        """Worker-side send path (generator: burns worker time)."""
        mech, cfg = self.mech, self.cfg
        rank = self.ranks[op.src]
        op.send_time = self.env.now
        op.total_app_bytes = op.size
        if not cfg.aggregation:
            yield from self._send_one(worker, op)
            return
        # HPX parcel aggregation (paper §2.2.2): enqueue, then drain unless
        # another worker's drain is already in flight for this destination.
        # The per-destination parcel queue is itself a point of thread
        # contention (§4.2: "additional thread contention on the parcel
        # queues") — the enqueue cost is paid inside the critical section.
        yield Acquire(rank.agg_lock)
        yield Timeout(mech.t_aggregate)
        q = rank.agg_queues.setdefault(op.dst, [])
        q.append(op)
        if rank.agg_draining.get(op.dst):
            rank.agg_lock.release()
            return  # an in-progress drain cycle will pick this parcel up
        rank.agg_draining[op.dst] = True
        while q:
            drained = list(q)
            q.clear()
            rank.agg_lock.release()
            for batch in self._agg_batches(drained):
                yield from self._send_aggregate(worker, batch)
            yield Acquire(rank.agg_lock)
        rank.agg_draining[op.dst] = False
        rank.agg_lock.release()

    def _agg_batches(self, drained: List[ParcelOp]) -> List[List[ParcelOp]]:
        """Threshold-aware drain (mirrors ``Parcelport._agg_batches``):
        with ``agg_eager`` the drained queue packs greedily into batches of
        at most ``eager_threshold`` payload bytes, so each aggregate still
        ships as one eager message instead of spilling into rendezvous.
        An op alone over the budget gets its own batch (rendezvous
        regardless).  Classic mode: one batch, unbounded merge."""
        cfg = self.cfg
        if not (cfg.agg_eager and cfg.eager_threshold > 0):
            return [drained]
        budget = cfg.eager_threshold
        batches: List[List[ParcelOp]] = []
        cur: List[ParcelOp] = []
        cur_bytes = 0
        for op in drained:
            if cur and cur_bytes + op.size > budget:
                batches.append(cur)
                cur, cur_bytes = [], 0
            cur.append(op)
            cur_bytes += op.size
        if cur:
            batches.append(cur)
        return batches

    def _send_aggregate(self, worker: SimWorker, ops: List[ParcelOp]) -> Generator:
        """Small (piggyback-eligible) parts merge into one nzc chunk;
        zero-copy chunks cannot merge (paper §4.2.2) and stay follow-ups.
        Under ``agg_eager`` the merge eligibility extends to the eager
        threshold: anything the protocol engine would ship eager on its own
        may coalesce into the one bounce-buffered eager message."""
        cfg = self.cfg
        merge_limit = (
            cfg.eager_threshold if (cfg.agg_eager and cfg.eager_threshold > 0) else PIGGYBACK_LIMIT
        )
        first = ops[0]
        small = sum(op.size for op in ops if op.size <= merge_limit)
        big = [op.size for op in ops if op.size > merge_limit]
        agg = ParcelOp(src=first.src, dst=first.dst, size=small, nparcels=len(ops))
        agg.send_time = min(op.send_time for op in ops)
        agg.followup_chunks = big  # zc chunks cannot merge — stay separate
        agg.total_app_bytes = small + sum(big)
        cbs = [op.on_delivered for op in ops if op.on_delivered]

        def deliver_all() -> None:
            for cb in cbs:
                cb()

        agg.on_delivered = deliver_all
        # serialization/merge cost is proportional to merged bytes
        yield Timeout(self.mech.t_serialize_per_byte * small)
        yield from self._send_one(worker, agg)

    def _send_one(self, worker: SimWorker, op: ParcelOp) -> Generator:
        mech, cfg = self.mech, self.cfg
        dev = self.ranks[op.src].device_for_worker(worker.wid)
        op.src_dev_idx = dev.index
        # Protocol selection: one-message limit is the piggyback limit, or
        # the eager threshold when the eager path extends past it.  Eager
        # shipment beyond the plain piggyback limit pays the bounce-buffer
        # copy (memcpy-bound) instead of the rendezvous round trip.  With a
        # finite bounce pool the eager message must also FIT a bounce
        # buffer, or the post could never succeed (mirrors
        # ``LCIParcelport._use_eager``'s capacity check).
        one_msg_limit = max(PIGGYBACK_LIMIT, cfg.eager_threshold) if cfg.eager_threshold > 0 else PIGGYBACK_LIMIT
        if cfg.bounce_buffers > 0:
            one_msg_limit = min(one_msg_limit, cfg.bounce_buffer_size - HEADER_BYTES)
        if op.size > one_msg_limit:
            op.followup_chunks = [op.size] + op.followup_chunks
            piggy = 0
        else:
            piggy = op.size
            if op.size > PIGGYBACK_LIMIT:
                # eager beyond the plain piggyback limit: the payload (a
                # single parcel's, or a whole eager aggregate's) is copied
                # into a pre-registered bounce buffer — charged on the
                # dedicated calibrated mechanism.  This charge has always
                # modeled the COPY, never send-side serialization (plain
                # parcels charge no serializer on the send path in this
                # model — deserialization is charged at delivery; aggregates
                # pay t_serialize_per_byte at merge time, in
                # _send_aggregate) — it just used to borrow the
                # serializer's constant.
                yield Timeout(mech.t_bounce_copy_per_byte * op.size)
        # an eager message (whole parcel in one shot, no follow-ups) draws a
        # registered bounce buffer while in flight
        eager = cfg.eager_threshold > 0 and piggy == op.size and not op.followup_chunks
        # normalized protocol-path decision (the engine-parity trace): the
        # MPI family has no eager path, whatever its threshold default says
        self._engine.record(
            "send", "eager" if (eager and not cfg.mpi) else "rdv", len(op.followup_chunks)
        )
        # Lock discipline.  Sends take the coarse lock *blocking* even in the
        # 'try' variants — paper footnote 1: only progress can use try locks.
        locked = cfg.mpi or cfg.lock_mode in (LockMode.BLOCK, LockMode.TRY)
        if locked:
            yield from self._lock_with_contention(dev.coarse)
            if cfg.mpi:
                yield Timeout(mech.t_mpi_big_lock)
        yield Timeout(mech.t_post_send)
        yield from self._inject(dev, _Message("header", HEADER_BYTES + piggy, op, eager=eager))
        if locked:
            dev.coarse.release()
        if cfg.mpi:
            # the send request joins the shared pool; a background_work must
            # round-robin to it before its buffers are released (§3.3.2)
            self.ranks[op.src].mpi_pool.append(_MPIReq("send", op, done=True))
        self.ranks[op.src].sent += op.nparcels

    # -- bounded injection (§3.3.4) ----------------------------------------
    def _claim_slot(self, dev: _SimDevice, msg: _Message) -> bool:
        """Reserve a send-ring slot (+ bounce buffer for eager messages).
        A refusal is an EAGAIN-style backpressure event, counted on the
        device and the world."""
        cfg = self.cfg
        if cfg.send_queue_depth and dev.inflight >= cfg.send_queue_depth:
            dev.stats_backpressure += 1
            self.backpressure_events += 1
            return False
        if msg.eager and cfg.bounce_buffers > 0:
            if dev.bounce_free <= 0:
                dev.stats_backpressure += 1
                self.backpressure_events += 1
                return False
            dev.bounce_free -= 1
            dev.bounce_in_use_hw = max(dev.bounce_in_use_hw, cfg.bounce_buffers - dev.bounce_free)
        dev.inflight += 1
        dev.inflight_hw = max(dev.inflight_hw, dev.inflight)
        return True

    def _release_slot(self, dev: _SimDevice, msg: _Message) -> None:
        """Reap one send completion: free the ring slot and recycle the
        bounce buffer (the moment new injection capacity appears)."""
        dev.inflight -= 1
        if msg.eager and self.cfg.bounce_buffers > 0:
            dev.bounce_free += 1

    def _park(self, dev: _SimDevice, msg: _Message) -> None:
        dev.parked.append(msg)
        dev.parked_hw = max(dev.parked_hw, len(dev.parked))

    def _drain_parked(self, dev: _SimDevice) -> Generator:
        """Retry up to ``retry_budget`` parked posts, oldest first; stop at
        the first refusal (the fabric freed nothing — throttle instead of
        hammering, mirroring ``ParcelportBase._drain_retries``)."""
        moved = False
        for _ in range(self.cfg.retry_budget):
            if not dev.parked:
                break
            msg = dev.parked[0]
            if not self._claim_slot(dev, msg):
                yield Timeout(self.mech.t_post_eagain)
                break
            dev.parked.popleft()
            yield from self._inject_claimed(dev, msg)
            moved = True
        return moved

    def _inject(self, dev: _SimDevice, msg: _Message) -> Generator:
        """Post one message.  Unbounded devices always accept (the classic
        model).  Bounded devices may refuse EAGAIN-style: the post costs
        the failed attempt (``t_post_eagain``) and parks in the device's
        retry queue for background work to drain once completions free
        ring slots or bounce buffers."""
        if self.cfg.bounded_injection and not self._claim_slot(dev, msg):
            yield Timeout(self.mech.t_post_eagain)
            self._park(dev, msg)
            return
        yield from self._inject_claimed(dev, msg)

    def _inject_claimed(self, dev: _SimDevice, msg: _Message) -> Generator:
        """Occupy the injection channel (per-device descriptor/doorbell
        cost), queue the payload on the rank's shared wire (bandwidth is a
        per-NIC resource even with many devices), schedule the arrival."""
        plat = self.platform
        rank = dev.rank
        yield Acquire(dev.inj_lock)
        yield Timeout(plat.inj_overhead)
        dev.inj_lock.release()
        dev.stats_injected += 1
        self.msg_count += 1
        self.byte_count += msg.size
        # shared-wire DMA: the worker does not wait, the wire serializes
        now = self.env.now
        start = max(now, rank.wire_busy_until)
        done = start + msg.size / plat.bandwidth
        rank.wire_busy_until = done
        dst_rank = self.ranks[msg.parcel.dst]
        dst_dev = dst_rank.devices[msg.parcel.src_dev_idx % len(dst_rank.devices)]
        self.env.process(self._arrive_later(dst_dev, msg, done - now + plat.wire_latency))
        if self.cfg.bounded_injection:
            # the send completion lands in OUR hardware CQ once the DMA
            # drains off the ring; the slot stays occupied until progress
            # reaps it — not polling your own CQ throttles your injection,
            # exactly like the functional fabric (the engine's progress op).
            self.env.process(self._send_done_later(dev, msg, done - now))

    def _arrive_later(self, dst_dev: _SimDevice, msg: _Message, delay: float) -> Generator:
        yield Timeout(delay)
        self._admit_arrival(dst_dev, msg.kind, msg)

    # -- bounded receive: RNR (§3.1, mirrors core.fabric) -------------------
    def _admit_arrival(self, dst_dev: _SimDevice, kind: str, msg: _Message) -> None:
        """Land an arrival in the destination device's hardware CQ.  With
        ``limits.recv_slots`` set, each un-reaped arrival occupies one
        posted receive descriptor; an arrival that finds none free is a
        **receiver-not-ready** event.  Default model: parked for free
        redelivery once the receiver's progress engine reaps backlog (the
        fabric's ``_pending_sends`` + ``hw_progress`` retransmission, as
        one queue on the receiver).  ``rnr_storm`` model: retransmitted
        after an exponential backoff charged on ``t_rnr_retry`` — retry
        storms burn wire time (§3.1)."""
        rs = self.cfg.recv_slots
        if rs > 0 and dst_dev.recv_backlog >= rs:
            dst_dev.stats_rnr += 1
            self.rnr_events += 1
            if self.cfg.rnr_storm:
                self.env.process(self._rnr_retransmit(dst_dev, kind, msg, attempt=1))
            else:
                dst_dev.rnr_parked.append((kind, msg))
            return
        if rs > 0:
            dst_dev.recv_backlog += 1
        self._cq_push(dst_dev, kind, msg)

    def _rnr_retransmit(self, dst_dev: _SimDevice, kind: str, msg: _Message, attempt: int) -> Generator:
        """Storm-mode RNR retransmission: back off ``t_rnr_retry * 2^(n-1)``
        (capped at 64x), then retry admission; every attempt is counted in
        ``rnr_retries`` and every further refusal in ``rnr_events``."""
        yield Timeout(self.mech.t_rnr_retry * min(2 ** (attempt - 1), 64))
        self.rnr_retries += 1
        dst_dev.stats_rnr_retries += 1
        rs = self.cfg.recv_slots
        if dst_dev.recv_backlog >= rs:
            dst_dev.stats_rnr += 1
            self.rnr_events += 1
            self.env.process(self._rnr_retransmit(dst_dev, kind, msg, attempt + 1))
            return
        dst_dev.recv_backlog += 1
        self._cq_push(dst_dev, kind, msg)

    def _reap_arrival(self, dev: _SimDevice, kind: str) -> None:
        """Bookkeeping when a CQ entry is reaped: a consumed arrival frees
        its receive descriptor (send_done entries never held one), letting
        RNR-parked arrivals redeliver in order (default model; storm mode
        redelivers through timed retransmission instead)."""
        rs = self.cfg.recv_slots
        if rs <= 0:
            return
        if kind != "send_done":
            dev.recv_backlog -= 1
        while dev.rnr_parked and dev.recv_backlog < rs:
            pkind, pmsg = dev.rnr_parked.popleft()
            dev.recv_backlog += 1
            self._cq_push(dev, pkind, pmsg)

    def _send_done_later(self, dev: _SimDevice, msg: _Message, delay: float) -> Generator:
        yield Timeout(delay)
        self._cq_push(dev, "send_done", msg)

    # -- hardware-CQ residency: the reap-latency signal -------------------
    def _cq_push(self, dev: _SimDevice, kind: str, msg: _Message) -> None:
        """Every CQ entry is enqueue-stamped so the pop side can measure
        how long completions sat un-reaped — the latency the elastic
        controller reacts to and ``elasticity_study`` claims against."""
        dev.cq.append((kind, msg))
        dev.cq_times.append(self.env.now)

    def _cq_pop(self, dev: _SimDevice) -> Tuple[str, _Message]:
        entry = dev.cq.pop(0)
        lat = self.env.now - dev.cq_times.pop(0)
        self.reap_samples.append(lat)
        self.reap_lat_ewma += 0.2 * (lat - self.reap_lat_ewma)
        if lat > self.reap_lat_high:
            self.reap_lat_high = lat
        return entry

    # -------------------------------------------------------------- progress
    def background_work(self, worker: SimWorker, role: str = ROLE_TASK) -> Generator:
        """Drive ONE step of the shared :class:`ProgressEngine` through the
        clock/cost adapter: the engine decides the op sequence (the same
        sequence the functional parcelports execute); this driver charges
        each op's calibrated cost and simulates its lock contention.  It is
        the only place completions are reaped or dispatched — gated by
        the analyzer's gate-progress-engine against re-grown private loops."""
        mech, cfg, plat = self.mech, self.cfg, self.platform
        rank = worker.rank
        gen = self._engine.step(worker.wid, role)
        to_deliver: List[ParcelOp] = []
        result: Any = None
        while True:
            try:
                op = gen.send(result)
            except StopIteration as stop:
                return bool(stop.value)
            kind = op[0]
            result = None
            if kind == "reap":
                name = op[1].name
                if name == "dev_cq":
                    dev = rank.devices[op[2]]
                    if dev.cq:
                        ckind, msg = self._cq_pop(dev)
                        self._reap_arrival(dev, ckind)
                        yield Timeout(mech.t_per_completion)
                        result = (ckind, msg)
                elif name == "client_poll":
                    # client-side completion poll: queue pop is cheap; the
                    # synchronizer pool is MPI-ish (cost only — delivery is
                    # fused into the dev_cq reaps in this layer)
                    yield from self._poll_completion_objects(worker)
                elif name == "mpi_header":
                    # test the pre-posted any-source header request
                    yield Timeout(mech.t_mpi_test)
                    msg = rank.mpi_header_req
                    if msg is not None:
                        rank.mpi_header_req = (
                            rank.mpi_header_backlog.pop(0) if rank.mpi_header_backlog else None
                        )
                        result = msg
                else:  # mpi_pool: ONE request, round-robin (§3.3.2)
                    yield Timeout(mech.t_mpi_test)
                    if rank.mpi_pool:
                        req = rank.mpi_pool.pop(0)
                        if req.done:
                            result = req
                        else:
                            rank.mpi_pool.append(req)
            elif kind == "dispatch":
                name, item = op[1].name, op[3]
                if name == "dev_cq":
                    ckind, msg = item
                    yield from self._handle_completion(worker, rank.devices[op[2]], ckind, msg)
                    result = True
                elif name == "mpi_header":
                    yield Timeout(mech.t_tag_match + mech.t_post_recv)  # match + re-post
                    self._engine.record("header", "rdv")
                    pop = item.parcel
                    if pop.followup_chunks:
                        req = _MPIReq("recv", pop)
                        pop.mpi_recv_req = req
                        rank.mpi_pool.append(req)
                        yield Timeout(mech.t_post_recv)
                        self._spawn_followup(pop)
                    else:
                        to_deliver.append(pop)
                    result = True
                else:  # mpi_pool
                    req = item
                    if req.kind == "followup_gate":
                        self.env.process(self._mpi_rts(req.op))
                    elif req.kind == "cts_gate":
                        self.env.process(self._mpi_cts(req.op))
                    elif req.kind == "recv":
                        self._engine.record("chunk")
                        pop = req.op
                        pop.chunk_idx += 1
                        if pop.chunk_idx < len(pop.followup_chunks):
                            nreq = _MPIReq("recv", pop)
                            pop.mpi_recv_req = nreq
                            rank.mpi_pool.append(nreq)
                            yield Timeout(mech.t_post_recv)
                            self._spawn_followup(pop)
                        else:
                            to_deliver.append(pop)
                    result = True
            elif kind == "reap_begin":
                if op[1].name == "dev_cq":
                    if plat.libfabric_cq_lock:
                        # Slingshot-11: libfabric serializes CQ polling on a
                        # spin lock — 85% of Octo-Tiger time on Delta/32
                        # nodes (paper §4.2.3).
                        yield from self._lock_with_contention(rank.lf_lock)
                        yield Timeout(plat.progress_lock_cost)
                    yield Timeout(mech.t_progress_poll)
            elif kind == "reap_end":
                if op[1].name == "dev_cq" and plat.libfabric_cq_lock:
                    rank.lf_lock.release()
            elif kind == "drain_retries":
                dev = rank.device_for_worker(worker.wid)
                if dev.parked:
                    result = yield from self._drain_parked(dev)
            elif kind == "progress":
                # LCI: the hardware CQ *is* the completion source, so the
                # explicit-progress op is fused into the dev_cq reaps; the
                # MPI library drains hardware arrivals into MPI-internal
                # state here (noticed later, one MPI_Test at a time).
                if cfg.mpi:
                    result = yield from self._mpi_drain_hw(rank.devices[op[1]])
            elif kind == "implicit_tax":
                # implicit progress rides on a (possibly failed) completion
                # test: charge one test per step (progress at reduced rate)
                yield Timeout(mech.t_sync_test)
            elif kind == "dev_lock":
                yield from self._lock_with_contention(rank.devices[op[1]].coarse)
            elif kind == "dev_trylock":
                if rank.devices[op[1]].coarse.try_acquire():
                    result = True
                else:
                    yield Timeout(mech.t_try_fail)
            elif kind == "dev_unlock":
                rank.devices[op[1]].coarse.release()
            elif kind == "step_trylock":
                # MPI request-pool discipline: concurrent testing of a
                # shared request is disallowed (MPI 4.1 §12.6.2)
                if rank.pool_lock.try_acquire():
                    result = True
                else:
                    yield Timeout(mech.t_try_fail)
            elif kind == "step_unlock":
                rank.pool_lock.release()
            elif kind == "big_lock":
                yield from self._lock_with_contention(rank.devices[0].coarse)
            elif kind == "big_unlock":
                rank.devices[0].coarse.release()
            elif kind == "flush":
                # handle_parcel runs outside the library locks (MPI)
                for pop in to_deliver:
                    yield from self._deliver(worker, pop)
                to_deliver.clear()
            # "poll": nothing to charge — LCI's completion-test-driven
            # progress is the dev_cq reap itself (taxed by implicit_tax)

    def _mpi_drain_hw(self, dev: _SimDevice) -> Generator:
        """The MPI library's implicit progress (the engine's ``progress``
        op, §3.3.4): drain hardware arrivals into MPI-internal completion
        state.  Completion of a specific request is only *noticed* later,
        when its turn comes up in the round-robin MPI_Test (§3.3.2)."""
        mech = self.mech
        rank = dev.rank
        while dev.cq:
            ckind, msg = self._cq_pop(dev)
            self._reap_arrival(dev, ckind)
            yield Timeout(mech.t_per_completion)
            if ckind == "send_done":
                self._release_slot(dev, msg)
            elif ckind == "header":
                if rank.mpi_header_req is None:
                    rank.mpi_header_req = msg  # matches the pre-posted recv
                else:
                    rank.mpi_header_backlog.append(msg)  # unexpected queue
            else:
                msg.parcel.mpi_recv_req.done = True
        return False

    def _handle_completion(self, worker: SimWorker, dev: _SimDevice, kind: str, msg: _Message) -> Generator:
        """Dispatch-by-kind for one reaped completion — called ONLY from
        the engine driver (`background_work`), never from private loops."""
        mech, cfg = self.mech, self.cfg
        op = msg.parcel
        rank = worker.rank
        if kind == "send_done":
            # reaping the send completion frees the ring slot / bounce
            # buffer (bounded-injection mode only; t_per_completion already
            # charged by the engine's reap op)
            self._release_slot(dev, msg)
            return
        if kind == "header":
            self._engine.record("header", "eager" if (msg.eager and not cfg.mpi) else "rdv")
            if cfg.header_mode == "put":
                if cfg.header_comp == "sync":
                    # put-signal (§3.3.1, the middle capability-ladder
                    # rung): the receiver discovers the put by scanning
                    # raised per-slot signal flags — no queue machinery,
                    # but the scan is a serialized sweep (one discoverer
                    # at a time), like the functional ShmemSegment's
                    # claim_signals under the slab lock
                    yield Acquire(rank.match_lock)
                    yield Timeout(mech.t_put_signal + mech.t_sync_signal + mech.t_sync_test)
                    rank.match_lock.release()
                else:
                    # put + queue-completion: no matching; the descriptor
                    # goes straight into the client's completion ring
                    yield Timeout(mech.t_put_deliver)
                    yield from self._cq_cost(rank, "push", dev)
                    yield from self._cq_cost(rank, "pop", dev)
            else:
                # two-sided: the matching→signaling path is a sequential
                # bottleneck (§3.3.1) — serialized, but with no futex storm
                yield Acquire(rank.match_lock)
                yield Timeout(mech.t_tag_match + mech.t_post_recv)  # match + re-post
                if cfg.header_comp == "sync":
                    # one pre-posted receive at a time; cheap 4 B signal
                    yield Timeout(mech.t_sync_signal + mech.t_sync_test)
                else:
                    yield from self._cq_cost(rank, "push", dev)
                    yield from self._cq_cost(rank, "pop", dev)
                rank.match_lock.release()
            if op.followup_chunks:
                # rendezvous: allocate zc buffers, post the receive for the
                # *first* chunk, then the sender streams it (chunks of one
                # parcel are strictly sequential, §3.2)
                yield Timeout(mech.t_post_recv)
                self._spawn_followup(op)
            else:
                yield from self._deliver(worker, op)
        else:  # followup chunk op.chunk_idx completed at the receiver
            self._engine.record("chunk")
            yield Timeout(mech.t_tag_match)
            if cfg.followup_comp == "sync":
                # request-pool detection: the completion is only *noticed*
                # by round-robin testing under the pool try-lock (§3.3.2) —
                # serialized, with the wasted tests on not-yet-ready
                # requests (~pool length/2 per detection) amortized in
                yield Acquire(rank.pool_lock)
                yield Timeout(mech.t_sync_signal + 32 * mech.t_sync_test)
                rank.pool_lock.release()
            else:
                yield from self._cq_cost(rank, "push", dev)
                yield from self._cq_cost(rank, "pop", dev)
            op.chunk_idx += 1
            if op.chunk_idx < len(op.followup_chunks):
                yield Timeout(mech.t_post_recv)
                self._spawn_followup(op)
            else:
                yield from self._deliver(worker, op)

    def _spawn_followup(self, op: ParcelOp) -> None:
        if self.cfg.mpi:
            # MPI large-message rendezvous, progress-gated at every step
            # (§3.3.2/§3.3.4): the sender notices the prior chunk's send
            # completion through its round-robin pool ('followup_gate'),
            # sends RTS; the receiver's progress engine matches it and
            # answers CTS ('cts_gate' on the receiver pool); only then does
            # the data move.  Every hop costs a serialized MPI_Test slot.
            self.ranks[op.src].mpi_pool.append(_MPIReq("followup_gate", op, done=True))
            return
        sdev = self.ranks[op.src].devices[op.src_dev_idx % self.cfg.ndevices]
        self.env.process(self._send_followup(sdev, op))

    def _mpi_rts(self, op: ParcelOp) -> Generator:
        """RTS wire hop, then the CTS gate joins the receiver's pool."""
        yield Timeout(self.platform.wire_latency)
        self.ranks[op.dst].mpi_pool.append(_MPIReq("cts_gate", op, done=True))

    def _mpi_cts(self, op: ParcelOp) -> Generator:
        """CTS wire hop, then the sender's NIC streams the chunk."""
        yield Timeout(self.platform.wire_latency)
        sdev = self.ranks[op.src].devices[0]
        yield from self._send_followup(sdev, op)

    def _send_followup(self, sdev: _SimDevice, op: ParcelOp) -> Generator:
        yield Timeout(self.mech.t_post_send)
        yield from self._inject(sdev, _Message("followup", op.followup_chunks[op.chunk_idx], op))

    def _deliver(self, worker: SimWorker, op: ParcelOp) -> Generator:
        """handle_parcel: deserialize + hand the task(s) to the scheduler."""
        mech = self.mech
        self._engine.record("deliver", op.nparcels)
        yield Timeout(mech.t_handle_parcel * op.nparcels + mech.t_serialize_per_byte * op.total_app_bytes)
        worker.rank.handled += op.nparcels
        if op.on_delivered is not None:
            op.on_delivered()

    def _cq_cost(self, rank: SimRank, what: str, dev: Optional[_SimDevice] = None) -> Generator:
        """LCI completion-queue op cost + concurrency penalty (§5.2).

        The contention pool follows the router's topology (§3.3.3):
        ``cq_scope='shared'`` counts accessors per rank (one queue across
        devices); ``'device'`` scopes them to the device's own queue."""
        mech, kind = self.mech, self.cfg.cq_kind
        base = (mech.t_cq_push if what == "push" else mech.t_cq_pop)[kind]
        holder = dev if (dev is not None and self.cfg.cq_scope == "device") else rank
        holder.cq_accessors += 1
        penalty = mech.cq_contention[kind] * max(0, holder.cq_accessors - 1)
        yield Timeout(base + penalty)
        holder.cq_accessors -= 1

    def _poll_completion_objects(self, worker: SimWorker) -> Generator:
        mech, cfg = self.mech, self.cfg
        if cfg.followup_comp == "queue":
            yield from self._cq_cost(worker.rank, "pop", worker.rank.device_for_worker(worker.wid))
            return
        # synchronizer pool: try-lock + one round-robin test (§3.3.2)
        if not worker.rank.pool_lock.try_acquire():
            yield Timeout(mech.t_try_fail)
            return
        yield Timeout(mech.t_sync_test)
        worker.rank.pool_lock.release()

    # ------------------------------------------------------------------ API
    def spawn(self, rank: int, task: Task) -> None:
        self.ranks[rank].runq.put(task)

    def make_parcel(
        self,
        src: int,
        dst: int,
        size: int,
        on_delivered: Optional[Callable[[], None]] = None,
    ) -> ParcelOp:
        return ParcelOp(src=src, dst=dst, size=size, on_delivered=on_delivered)

    def run(self, until: float = float("inf"), max_events: int = 50_000_000) -> None:
        self.env.run(until=until, max_events=max_events)

    def stop(self) -> None:
        self.stopped = True
