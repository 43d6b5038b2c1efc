"""The LCI parcelport (paper §3.3) with every studied technique as a flag.

Techniques (paper Table 1) and the flag that controls each:

* **Protocol** — ``eager_threshold``: parcels whose total size fits the
  threshold ship **eager** (one fabric message through a pre-registered
  bounce buffer, zc chunks inline, zero follow-up round trips); larger
  parcels use the **rendezvous** layout (header + sequential follow-ups).
  ``eager_threshold=0`` disables the eager path (the ``lci_noeager``
  variant).  Backpressured posts (full send queue / exhausted bounce pool,
  §3.3.4) park in a retry queue that the progress engine drains under a
  bounded per-call budget — the sender-side throttle that keeps injection
  inside the fabric's resource limits.
* **Asynchrony** — ``header_mode``: ``'put'`` uses the one-sided *dynamic
  put* primitive, delivering headers straight into a completion queue;
  ``'sendrecv'`` pre-posts tagged receives (the MPI-like path) with either a
  completion queue (``header_comp='queue'``) or a single synchronizer
  (``header_comp='sync'`` — one pre-posted receive at a time, the variant
  that serializes header processing, §5.1).
* **Concurrency** — ``followup_comp``: ``'queue'`` routes every completion
  through MPMC completion queues (``cq_kind`` picks LCRQ / Michael-Scott /
  lock-based, §5.2); ``'sync'`` uses a synchronizer pool (the request-pool
  analogue).  ``cq_scope`` picks the queue *topology* (§3.3.3): ``'shared'``
  — one queue across devices, reducing load imbalance (the default, and the
  ``lci_shared_cq`` variant) — or ``'device'`` — one queue per device,
  trading imbalance for less queue contention.  The choice is routed by the
  engine's :class:`~repro_torch.core.comm.progress.CompletionRouter`.
* **Multithreading** — ``ndevices`` replicates communication resources with
  a static worker→device mapping; ``lock_mode`` wraps each device in a
  coarse blocking/try lock or leaves it fine-grained (§5.3).
* **Progress** — the shared :class:`~repro_torch.core.comm.progress.
  ProgressEngine` drives one canonical step loop; ``progress_mode``
  selects the :class:`~repro_torch.core.comm.progress.ProgressPolicy`
  (``'explicit'`` invokes the device progress engine every step,
  ``'implicit'`` only when a completion poll comes back empty — the MPI
  behaviour), and ``progress_workers`` reserves that many **dedicated
  progress threads** (§3.3.4's omitted experiment, the ``lci_prg{n}``
  family): real daemon threads that drive retries + device progress on
  every device and never execute tasks or touch client completion objects.
* **Aggregation** — ``aggregation`` merges same-destination parcels
  (paper §2.2.2); ``agg_eager`` additionally makes the merge
  threshold-aware: the drain packs parcels into aggregates whose projected
  size stays within ``eager_threshold``, so a batch of eager-sized parcels
  fills at most one bounce buffer and never accidentally crosses onto the
  rendezvous path (the ``lci_agg_eager`` variant).

``background_work`` is a thin call into the shared engine: this module
implements only the op semantics (``execute``) and the per-parcel protocol
actions the engine dispatches to.  The reap loop itself lives once, in
:mod:`repro_torch.core.comm.progress`.

Invariant that makes the queue-based path lock-free at this layer: chunks of
one parcel transfer sequentially, so at most one completion record per
parcel is in flight, so op state machines are never touched concurrently.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field, replace
from typing import Any, List, Optional, Tuple

from .comm.membership import ElasticProgressController, ProgressWorkerPool
from .comm.progress import (
    ROLE_PROGRESS,
    CompletionRouter,
    CompletionSource,
    ProgressEngine,
    ProgressPolicy,
    run_step,
)
from .comm.resources import ResourceLimits
from .completion import (
    CompletionQueue,
    Synchronizer,
    SynchronizerPool,
    make_completion_queue,
)
from .device import WIRE_OVERHEAD, CompletionRecord, LCIDevice, LockMode
from .fabric import Fabric
from .parcel import (
    HEADER_PIGGYBACK_LIMIT,
    Chunk,
    Parcel,
    SendCallback,
    decode_header,
    eager_wire_size,
    encode_eager,
    encode_header,
)
from .parcelport import Locality, Parcelport
from .worker import get_worker_id

TAG_HEADER = 0
HEADER_PREPOST = 16  # sendrecv_queue mode: pre-posted header receives

__all__ = ["LCIParcelport", "LCIPPConfig"]


@dataclass
class LCIPPConfig:
    name: str = "lci"
    header_mode: str = "put"  # 'put' | 'sendrecv'
    header_comp: str = "queue"  # 'queue' | 'sync'  (sendrecv mode only)
    followup_comp: str = "queue"  # 'queue' | 'sync'
    cq_kind: str = "lcrq"  # 'lcrq' | 'ms' | 'lock'
    # Completion-queue topology (§3.3.3), routed by the engine's
    # CompletionRouter: 'shared' = one queue across devices (load balance,
    # the lci_shared_cq variant and the default); 'device' = one per device.
    cq_scope: str = "shared"  # 'shared' | 'device'
    ndevices: int = 2
    lock_mode: str = LockMode.NONE
    progress_mode: str = "explicit"  # 'explicit' | 'implicit'
    # Dedicated progress workers (§3.3.4, the lci_prg{n} family): threads
    # reserved to drive the progress engine, never executing tasks.  0 =
    # every worker polls (the paper's recommended configuration).
    progress_workers: int = 0
    # Elastic progress bounds (the lci_eprg{lo}_{hi} family):
    # (lo, hi) lets an ElasticProgressController grow/shrink the dedicated
    # pool between the bounds from the engine's reap statistics; None
    # keeps the pool fixed at progress_workers.
    elastic_progress: Optional[Tuple[int, int]] = None
    aggregation: bool = False
    # Protocol engine: parcels with total_bytes <= eager_threshold ship as
    # one eager message; 0 disables the eager path entirely.  The default
    # matches the piggyback limit, so plain small parcels behave as before
    # and small zero-copy chunks stop costing follow-up round trips.
    eager_threshold: int = HEADER_PIGGYBACK_LIMIT
    # Threshold-aware aggregation: the drain packs parcels into aggregates
    # whose projected size stays within eager_threshold (fill one bounce
    # buffer, never spill an eager-sized batch into rendezvous).  Only
    # meaningful with aggregation=True and eager_threshold > 0.
    agg_eager: bool = False
    # The shared resource model (paper §3.3.4): send-ring depth, bounce
    # pool, retry throttle.  One object consumed by the fabric, this
    # parcelport, AND the DES SimConfig — never mirrored field by field.
    limits: ResourceLimits = field(default_factory=ResourceLimits)

    @property
    def retry_budget(self) -> int:
        """Sender-side throttle: backpressured posts retried per
        ``background_work`` (delegates to the shared resource model)."""
        return self.limits.retry_budget

    def variant(self, **kw) -> "LCIPPConfig":
        return replace(self, **kw)


class _SendOp:
    __slots__ = ("dest", "parcel", "cb", "msgs", "next_idx", "dev")

    def __init__(self, dest, parcel, cb, msgs, dev):
        self.dest = dest
        self.parcel = parcel
        self.cb = cb
        self.msgs = msgs
        self.next_idx = 1
        self.dev = dev


class _RecvOp:
    __slots__ = ("header", "nzc", "zc_bufs", "idx")

    def __init__(self, header):
        self.header = header
        self.nzc: Optional[bytes] = header.piggybacked_nzc
        self.zc_bufs: List[bytearray] = []
        self.idx = 0


class LCIParcelport(Parcelport):
    def __init__(self, locality: Locality, fabric: Fabric, config: Optional[LCIPPConfig] = None):
        config = config or LCIPPConfig()
        assert config.cq_scope in ("shared", "device"), config.cq_scope
        agg_limit = config.eager_threshold if (config.agg_eager and config.eager_threshold > 0) else 0
        super().__init__(
            locality,
            aggregation=config.aggregation,
            agg_limit_bytes=agg_limit,
            retry_budget=config.limits.retry_budget,
        )
        self.cfg = config
        rank = locality.rank
        # Completion-queue topology (§3.3.3): one shared queue across
        # devices (reduces load imbalance) or one queue per device (less
        # queue contention) — the router reaps whichever exists.
        self._dev_cqs: Optional[List[CompletionQueue]] = None
        if config.cq_scope == "device":
            self._dev_cqs = [make_completion_queue(config.cq_kind) for _ in range(config.ndevices)]
            self.cq: Optional[CompletionQueue] = None
        else:
            self.cq = make_completion_queue(config.cq_kind)
        self.sync_pool = SynchronizerPool()
        # Backend creation is a hook: CollectiveParcelport swaps the LCI
        # devices for CollectiveComm endpoints and inherits every protocol
        # decision above this line untouched (selection is by capability).
        self.devices: List[Any] = self._make_devices(fabric, config)
        # Protocol-path selection by CAPABILITY, not flag alone (§2.3): the
        # one-sided header path needs a backend that advertises dynamic
        # put; a backend without it falls back to the two-sided path the
        # same config would otherwise describe.
        caps = self.devices[0].capabilities
        self._use_put = config.header_mode == "put" and caps.one_sided_put
        self.stats_eager_sent = 0
        self.stats_rendezvous_sent = 0
        # Header receive plumbing for the two-sided path.
        self._header_sync: Optional[Synchronizer] = None
        self._header_sync_lock = threading.Lock()
        if not self._use_put:
            if config.header_comp == "sync":
                self._header_sync = Synchronizer()
                self.devices[0].post_recv(-1, TAG_HEADER, self._header_sync, ctx="header")
            else:
                for d, dev in enumerate(self.devices):
                    for _ in range(HEADER_PREPOST):
                        dev.post_recv(-1, TAG_HEADER, self._cq_for(d), ctx=("header", d))
        # THE progress engine (shared with the DES): policy + router from
        # the config, ops executed by this parcelport.
        self.engine = ProgressEngine(
            ProgressPolicy.for_config(config),
            self._build_router(config),
            ndevices=config.ndevices,
        )
        # Dedicated progress threads (lci_prg{n}): drive the engine's
        # progress role; task workers keep the implicit fallback poll, so
        # delivery never depends on thread scheduling.  Thread lifecycle
        # lives in the membership layer's ProgressWorkerPool; with
        # elastic_progress=(lo, hi) an ElasticProgressController resizes
        # the pool between the bounds from the engine's reap statistics.
        self._pw_pool: Optional[ProgressWorkerPool] = None
        self._elastic: Optional[ElasticProgressController] = None
        initial = config.progress_workers
        if config.elastic_progress is not None:
            lo, hi = config.elastic_progress
            initial = max(initial, lo)
        if initial > 0 or config.elastic_progress is not None:
            self._pw_pool = ProgressWorkerPool(weakref.ref(self), f"lci-prg{rank}")
            self._pw_pool.resize(initial)
            if config.elastic_progress is not None:
                lo, hi = config.elastic_progress
                self._elastic = ElasticProgressController(self.engine, self._pw_pool, lo, hi)

    def _make_devices(self, fabric: Fabric, config: LCIPPConfig) -> List[LCIDevice]:
        """Open this parcelport's communication backends (one per device
        index).  Subclasses swap the backend family here."""
        rank = self.locality.rank
        return [
            LCIDevice(fabric.device(rank, d), lock_mode=config.lock_mode, put_target_comp=self._cq_for(d))
            for d in range(config.ndevices)
        ]

    def _build_router(self, cfg: LCIPPConfig) -> CompletionRouter:
        srcs: List[CompletionSource] = []
        if cfg.followup_comp == "queue" or self._use_put:
            if cfg.cq_scope == "device":
                srcs.append(CompletionSource("cq", batch=8, per_device=True, sweep="all"))
            else:
                srcs.append(CompletionSource("cq", batch=8))
        if cfg.followup_comp == "sync":
            srcs.append(CompletionSource("sync_pool", batch=1))
        if self._header_sync is not None:
            srcs.append(CompletionSource("header_sync", batch=1))
        return CompletionRouter(srcs, ndevices=cfg.ndevices)

    def _cq_for(self, d: int) -> CompletionQueue:
        """The completion queue serving device ``d`` under the configured
        scope (shared: one queue for all)."""
        return self.cq if self._dev_cqs is None else self._dev_cqs[d]

    def close(self) -> None:
        """Stop AND JOIN the dedicated progress threads.  Idempotent.

        Relying on weakref finalization alone leaked live daemon threads
        for as long as the parcelport object survived (benchmarks and
        tests construct many short-lived worlds); an explicit close joins
        them deterministically — the weakref loop remains only the GC
        backstop for worlds that never call it."""
        if self._pw_pool is not None:
            self._pw_pool.close()

    def __enter__(self) -> "LCIParcelport":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------------ send
    def _worker_device(self) -> int:
        return get_worker_id() % self.cfg.ndevices

    def _comp_for(self, kind: str, op: Any, dev: int) -> Any:
        """Completion object for an operation, per the concurrency flag and
        the completion-queue scope."""
        if self.cfg.followup_comp == "queue":
            return self._cq_for(dev)
        sync = Synchronizer()
        self.sync_pool.add(sync, (kind, op))
        return sync

    # Injection backpressure (paper §3.3.4): `_post_or_park` /
    # `_drain_retries` / `pending_work` are inherited from ParcelportBase —
    # the same parking + bounded-retry throttle every parcelport shares.

    # -- protocol selection (eager vs rendezvous) ---------------------------
    def _use_eager(self, parcel: Parcel, dev: LCIDevice) -> bool:
        if self.cfg.eager_threshold <= 0 or parcel.total_bytes > self.cfg.eager_threshold:
            return False
        cap = dev.eager_capacity()
        if cap is None:
            return True
        # the two-sided path prepends the library's tag word to the payload;
        # the whole wire message must fit a bounce buffer or acquire() would
        # fail on every retry (silent parcel loss, not backpressure).
        overhead = 0 if self._use_put else WIRE_OVERHEAD
        return eager_wire_size(parcel) + overhead <= cap

    def _send_impl(self, dest: int, parcel: Parcel, cb: Optional[SendCallback]) -> None:
        d = self._worker_device()
        dev = self.devices[d]
        if self._use_eager(parcel, dev):
            # Eager: the whole parcel in one bounce-buffered fabric message.
            self.engine.record("send", "eager", 0)
            wire = encode_eager(parcel, device_index=d)
            op = _SendOp(dest, parcel, cb, [(TAG_HEADER, wire)], d)
            comp = self._comp_for("send", op, d)
            if self._use_put:
                self._post_or_park(lambda: dev.post_put_signal(dest, d, wire, comp, ctx=("send", op), eager=True))
            else:
                self._post_or_park(lambda: dev.post_send(dest, d, TAG_HEADER, wire, comp, ctx=("send", op), eager=True))
            self.stats_eager_sent += 1
            self.stats_sent += 1
            return
        # Rendezvous: header first, then sequential follow-ups.
        header = encode_header(parcel, device_index=d)
        msgs: List[Tuple[int, bytes]] = [(TAG_HEADER, header)]
        if parcel.nzc_chunk.size > HEADER_PIGGYBACK_LIMIT:
            msgs.append((parcel.parcel_id, parcel.nzc_chunk.data))
        for c in parcel.zc_chunks:
            msgs.append((parcel.parcel_id, c.data))
        self.engine.record("send", "rdv", len(msgs) - 1)
        op = _SendOp(dest, parcel, cb, msgs, d)
        comp = self._comp_for("send", op, d)
        if self._use_put:
            self._post_or_park(lambda: dev.post_put_signal(dest, d, header, comp, ctx=("send", op)))
        else:
            self._post_or_park(lambda: dev.post_send(dest, d, TAG_HEADER, header, comp, ctx=("send", op)))
        self.stats_rendezvous_sent += 1
        self.stats_sent += 1

    def _advance_send(self, op: _SendOp) -> None:
        if op.next_idx < len(op.msgs):
            tag, data = op.msgs[op.next_idx]
            op.next_idx += 1
            dev = self.devices[op.dev]
            comp = self._comp_for("send", op, op.dev)
            self._post_or_park(lambda: dev.post_send(op.dest, op.dev, tag, data, comp, ctx=("send", op)))
        else:
            if op.cb is not None:
                op.cb(op.parcel)

    # ------------------------------------------------------------------ recv
    def _process_header(self, src: int, payload: bytes) -> None:
        h = decode_header(payload)
        if h.is_eager:
            # Everything arrived inline: copy chunks out of the bounce
            # buffer and deliver — no follow-up receives, no round trips.
            self.engine.record("header", "eager")
            self.deliver(
                Parcel(
                    parcel_id=h.parcel_id,
                    source=h.source,
                    dest=h.dest,
                    nzc_chunk=Chunk(h.piggybacked_nzc),
                    zc_chunks=[Chunk(b) for b in h.inline_zc],
                    device_index=h.device_index,
                    is_agg=h.is_agg,
                )
            )
            return
        self.engine.record("header", "rdv")
        op = _RecvOp(h)
        if h.piggybacked_nzc is not None and not h.zc_sizes:
            self._finish_recv(op)
            return
        dev = self.devices[h.device_index]
        comp = self._comp_for("recv", op, h.device_index)
        dev.post_recv(h.source, h.parcel_id, comp, ctx=("recv", op))

    def _advance_recv(self, op: _RecvOp, rec: CompletionRecord) -> None:
        self.engine.record("chunk")
        h = op.header
        if op.nzc is None:
            op.nzc = rec.data
        else:
            if not op.zc_bufs:
                op.zc_bufs = self.locality.allocate_zc_chunks(op.nzc)
            op.zc_bufs[op.idx][:] = rec.data
            op.idx += 1
        if op.idx < len(h.zc_sizes):
            dev = self.devices[h.device_index]
            comp = self._comp_for("recv", op, h.device_index)
            dev.post_recv(h.source, h.parcel_id, comp, ctx=("recv", op))
        else:
            self._finish_recv(op)

    def _finish_recv(self, op: _RecvOp) -> None:
        h = op.header
        if h.zc_sizes and not op.zc_bufs:
            op.zc_bufs = self.locality.allocate_zc_chunks(op.nzc)
        parcel = Parcel(
            parcel_id=h.parcel_id,
            source=h.source,
            dest=h.dest,
            nzc_chunk=Chunk(bytes(op.nzc)),
            zc_chunks=[Chunk(bytes(b)) for b in op.zc_bufs],
            device_index=h.device_index,
            is_agg=h.is_agg,
        )
        self.deliver(parcel)

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, rec: CompletionRecord) -> None:
        if rec.op == "put_recv":
            self._process_header(rec.src_rank, rec.data)
            return
        kind_op = rec.ctx
        if isinstance(kind_op, tuple) and kind_op and kind_op[0] == "header":
            # sendrecv_queue header receive: re-post, then process.
            d = kind_op[1]
            self.devices[d].post_recv(-1, TAG_HEADER, self._cq_for(d), ctx=("header", d))
            self._process_header(rec.src_rank, rec.data)
            return
        kind, op = kind_op
        if kind == "send":
            self._advance_send(op)
        else:
            self._advance_recv(op, rec)

    # ------------------------------------------- the progress-engine hookup
    def background_work(self) -> bool:
        """One step of the SHARED progress engine (drain retries → progress
        → reap → dispatch); this parcelport only supplies op semantics."""
        moved = run_step(self.engine, self, self._worker_device())
        if self._elastic is not None:
            # elastic progress: one cheap control decision per
            # task-side pump — grow/shrink the dedicated pool between the
            # configured bounds from the engine's reap statistics
            self._elastic.maybe_resize()
        return moved

    def progress_work(self) -> bool:
        """One dedicated-progress step (ROLE_PROGRESS): retries + device
        progress on every device; no client-side completion dispatch."""
        return run_step(self.engine, self, get_worker_id(), role=ROLE_PROGRESS)

    def execute(self, op: tuple) -> Any:
        """Execute one engine op against the real devices and completion
        objects (the functional layer's half of the engine contract)."""
        kind = op[0]
        if kind == "reap":
            src, d = op[1], op[2]
            name = src.name
            if name == "cq":
                return (self.cq if d < 0 else self._dev_cqs[d]).reap()
            if name == "sync_pool":
                return self.sync_pool.poll_one()
            # header_sync: single pre-posted receive, one thread owns the
            # test (MPI-style try-lock); re-post before processing.
            if self._header_sync_lock.acquire(blocking=False):
                try:
                    rec = self._header_sync.test()
                    if rec is not None:
                        self.devices[0].post_recv(-1, TAG_HEADER, self._header_sync, ctx="header")
                    return rec
                finally:
                    self._header_sync_lock.release()
            return None
        if kind == "dispatch":
            src, item = op[1], op[3]
            name = src.name
            if name == "cq":
                self._dispatch(item)
            elif name == "sync_pool":
                (skind, sop), rec = item
                if skind == "send":
                    self._advance_send(sop)
                else:
                    self._advance_recv(sop, rec)
            else:  # header_sync
                self._process_header(item.src_rank, item.data)
            return True
        if kind == "progress":
            return self.devices[op[1]].progress()
        if kind == "poll":
            # the MPI behaviour: progress only as a side effect of a failed
            # completion test (the interface's `poll` verb)
            return self.devices[op[1]].poll()
        if kind == "drain_retries":
            return self._drain_retries()
        if kind in ("dev_trylock", "step_trylock"):
            # coarse locking is internal to LCIDevice (its lock_mode); the
            # engine's trylock decision maps to "go ahead" here and the
            # device's own try-acquire reports contention via progress().
            return True
        # dev_lock/dev_unlock/big_*/step_unlock/implicit_tax/reap_begin/
        # reap_end/flush: cost-model ops — the DES charges them, the
        # functional layer has nothing to do.
        return False
