"""Shared parcelport machinery above the :class:`CommInterface` boundary.

Everything here used to be duplicated (or split) across the MPI and LCI
parcelports; it is library-agnostic, so it lives once, in the comm layer:

* **parcel aggregation** (paper §2.2.2) — per-destination queues, the
  drain-and-merge cycle, and the threshold-aware batch packing that keeps
  an aggregate of eager-sized parcels inside one bounce buffer;
* **injection backpressure handling** (paper §3.3.4) — parking posts the
  backend refused (:class:`~repro_torch.core.comm.interface.PostStatus` EAGAIN)
  and retrying them under a bounded per-call budget (the sender-side
  throttle drawn from :class:`~repro_torch.core.comm.resources.ResourceLimits`);
* delivery bookkeeping and the ``sent``/``received`` stats the parity
  tests conserve.

Concrete parcelports implement only ``_send_impl`` (per-parcel protocol
selection) and ``background_work`` (their progress/completion loop).
"""
from __future__ import annotations

import struct
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..parcel import Chunk, Parcel, SendCallback

__all__ = [
    "InjectionThrottle",
    "ParcelportBase",
    "aggregate_parcels",
    "aggregate_projected_bytes",
    "is_aggregate",
    "split_aggregate",
    "AGG_MAGIC",
    "AGG_SUB_SHIFT",
    "AGG_MAX_PARCELS",
    "AGG_PREAMBLE_BYTES",
    "AGG_PER_PARCEL_BYTES",
]

AGG_MAGIC = 0xA6

# Parcel-id bit layout: bits 0..39 are the per-locality counter, bits 40..47
# the source rank (Locality seeds its counter at ``rank << 40``), and bits
# 48..63 are RESERVED for aggregate sub-ids: parcel ``i`` of a split
# aggregate gets ``base_id | ((i + 1) << AGG_SUB_SHIFT)``.  Ordinary ids
# never touch the reserved range, so sub-ids cannot collide with dense
# neighbouring ids (the old ``base_id * 1000 + i`` scheme collided as soon
# as ids were dense or an aggregate held >= 1000 parcels).
AGG_SUB_SHIFT = 48
AGG_MAX_PARCELS = (1 << 16) - 1

# Serialized-aggregate framing overhead: the <BI> preamble plus one <II>
# record per member parcel (see aggregate_parcels).  aggregate_projected_bytes
# must stay in lockstep with the actual encoder.
AGG_PREAMBLE_BYTES = 5
AGG_PER_PARCEL_BYTES = 8


def aggregate_projected_bytes(parcels: Sequence[Parcel]) -> int:
    """``total_bytes`` the aggregate of ``parcels`` will have, without
    building it — the threshold-aware drain sizes batches with this."""
    return AGG_PREAMBLE_BYTES + sum(AGG_PER_PARCEL_BYTES + p.total_bytes for p in parcels)


def aggregate_parcels(parcels: Sequence[Parcel]) -> Parcel:
    """Merge parcels sharing a destination into one (paper §2.2.2)."""
    assert parcels, "cannot aggregate zero parcels"
    assert len(parcels) <= AGG_MAX_PARCELS, "aggregate exceeds the sub-id bit range"
    first = parcels[0]
    parts = [struct.pack("<BI", AGG_MAGIC, len(parcels))]
    zc: List[Chunk] = []
    for p in parcels:
        parts.append(struct.pack("<II", p.nzc_chunk.size, len(p.zc_chunks)))
        parts.append(p.nzc_chunk.data)
        zc.extend(p.zc_chunks)
    return Parcel(
        parcel_id=first.parcel_id,
        source=first.source,
        dest=first.dest,
        nzc_chunk=Chunk(b"".join(parts)),
        zc_chunks=zc,
        is_agg=True,
    )


def is_aggregate(parcel: Parcel) -> bool:
    """Aggregate-ness is an out-of-band property (``Parcel.is_agg``,
    FLAG_AGGREGATE on the wire) — never inferred from payload bytes: an
    ordinary parcel whose serialized pickle length happens to put
    ``AGG_MAGIC`` in byte 0 must not be torn apart by the splitter."""
    return parcel.is_agg


def split_aggregate(parcel: Parcel) -> List[Parcel]:
    # memoryview slices, not bytes slices: the aggregate buffer is already
    # immutable, so each sub-parcel's nzc chunk can be a zero-copy view —
    # ``bytes(nzc)`` here used to copy every sub-payload a second time
    # (pinned by the allocation-count test in tests/test_grad_pack.py).
    buf = memoryview(parcel.nzc_chunk.data)
    (magic, n) = struct.unpack_from("<BI", buf, 0)
    assert magic == AGG_MAGIC, "parcel flagged as aggregate lacks the framing magic"
    off = 5
    zc_off = 0
    out: List[Parcel] = []
    for i in range(n):
        nzc_size, n_zc = struct.unpack_from("<II", buf, off)
        off += 8
        nzc = buf[off : off + nzc_size]
        off += nzc_size
        chunks = parcel.zc_chunks[zc_off : zc_off + n_zc]
        zc_off += n_zc
        out.append(
            Parcel(
                parcel_id=parcel.parcel_id | ((i + 1) << AGG_SUB_SHIFT),
                source=parcel.source,
                dest=parcel.dest,
                nzc_chunk=Chunk(nzc),
                zc_chunks=list(chunks),
            )
        )
    return out


class InjectionThrottle:
    """Park-and-retry machinery for backpressured comm-interface posts
    (paper §3.3.4) — the sender-side throttle, shared verbatim by every
    parcelport AND the serving stack's request/response channel: a post the
    backend refused (falsy :class:`~repro_torch.core.comm.interface.PostStatus`)
    parks as a thunk and is retried under a bounded per-call budget,
    stopping at the first refusal (the backend has not freed resources, so
    the rest would fail too — throttle instead of hammering)."""

    def __init__(self, retry_budget: int = 8):
        self.retry_budget = retry_budget
        self.parks = 0  # EAGAIN-parked posts (backpressure observability)
        self._q: deque = deque()
        # One lock serializes posting AND draining end to end: the FIFO
        # non-overtaking guarantee below must hold even when one thread
        # drains retries while another posts fresh work (e.g. the serve
        # loop flushing a token batch during an executor worker's pump).
        self._lock = threading.Lock()

    def post_or_park(self, thunk: Callable[[], Any]) -> bool:
        """Run a comm-interface post; if it EAGAINs, park it for retry.

        Non-overtaking (FIFO): while parked posts exist, a fresh post
        parks BEHIND them instead of attempting — otherwise a post issued
        after the backend freed resources would bypass an earlier parked
        one, reordering traffic the client issued in order (the serving
        channel's token batches rely on this)."""
        with self._lock:
            if self._q:
                self.parks += 1
                self._q.append(thunk)
                return False
            if thunk():
                return True
            self.parks += 1
            self._q.append(thunk)
            return False

    def drain(self) -> bool:
        """Retry up to ``retry_budget`` parked posts, oldest first.  The
        head stays queued until its retry succeeds, so a concurrent
        ``post_or_park`` always observes it and parks behind."""
        moved = False
        with self._lock:
            for _ in range(self.retry_budget):
                if not self._q:
                    break
                if self._q[0]():
                    self._q.popleft()
                    moved = True
                else:
                    break
        return moved

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


class ParcelportBase:
    """Library-agnostic parcelport core (one per communication library per
    locality).  See the module docstring for what is shared here."""

    def __init__(
        self,
        locality: Any,
        aggregation: bool = False,
        agg_limit_bytes: int = 0,
        retry_budget: int = 8,
    ):
        self.locality = locality
        # The shared progress engine (set by the concrete parcelport once
        # its policy/router are known); also the decision-trace hub the
        # engine-parity suite reads.
        self.engine = None
        self.aggregation = aggregation
        # Threshold-aware aggregation: max projected aggregate size per
        # batch (0 = classic unbounded merge).
        self.agg_limit_bytes = agg_limit_bytes
        self._agg_queues: Dict[int, deque] = {}
        self._agg_lock = threading.Lock()
        # Backpressured posts awaiting retry (sender-side throttle, §3.3.4).
        self.retry_budget = retry_budget
        self._throttle = InjectionThrottle(retry_budget)
        self.stats_sent = 0
        self.stats_received = 0
        self.stats_agg_batches = 0  # threshold-aware drains that split

    # -- public API (paper Listing 2) ---------------------------------------
    def send(self, dest: int, parcel: Parcel, cb: Optional[SendCallback] = None) -> None:
        if not self.aggregation:
            self._send_impl(dest, parcel, cb)
            return
        # Aggregation path: enqueue, then drain everything for this dest.
        with self._agg_lock:
            q = self._agg_queues.setdefault(dest, deque())
            q.append((parcel, cb))
            drained = list(q)
            q.clear()
        if not drained:
            return
        batches = self._agg_batches(drained)
        if len(batches) > 1:
            self.stats_agg_batches += len(batches)
        for batch in batches:
            self._send_batch(dest, batch)

    def _agg_batches(self, drained: List[tuple]) -> List[List[tuple]]:
        """Split the drained queue into aggregate batches.

        Unbounded mode returns one batch (everything merges).  With
        ``agg_limit_bytes`` set, parcels pack greedily in FIFO order until
        the projected aggregate size (:func:`aggregate_projected_bytes`)
        would exceed the limit — so an aggregate of eager-sized parcels
        never spills past the eager threshold into rendezvous.  A parcel
        that alone exceeds the limit gets its own batch (it is rendezvous
        traffic regardless)."""
        if self.agg_limit_bytes <= 0:
            return [drained]
        batches: List[List[tuple]] = []
        cur: List[tuple] = []
        cur_bytes = AGG_PREAMBLE_BYTES
        for p, cb in drained:
            need = AGG_PER_PARCEL_BYTES + p.total_bytes
            if cur and cur_bytes + need > self.agg_limit_bytes:
                batches.append(cur)
                cur, cur_bytes = [], AGG_PREAMBLE_BYTES
            cur.append((p, cb))
            cur_bytes += need
        if cur:
            batches.append(cur)
        return batches

    def _send_batch(self, dest: int, batch: List[tuple]) -> None:
        if len(batch) == 1:
            self._send_impl(dest, batch[0][0], batch[0][1])
            return
        cbs = [c for (_p, c) in batch if c is not None]
        agg = aggregate_parcels([p for (p, _c) in batch])

        def agg_cb(_parcel: Parcel) -> None:
            for c in cbs:
                c(_parcel)

        self._send_impl(dest, agg, agg_cb)

    # -- injection backpressure (paper §3.3.4) ------------------------------
    @property
    def stats_backpressure_parks(self) -> int:
        return self._throttle.parks

    @property
    def _retry_q(self) -> deque:
        """The parked-post deque (the throttle's queue, historical name)."""
        return self._throttle._q

    def _post_or_park(self, thunk: Callable[[], Any]) -> None:
        """Run a comm-interface post; if it EAGAINs, park it for retry
        (delegates to the shared :class:`InjectionThrottle`)."""
        self._throttle.post_or_park(thunk)

    def _drain_retries(self) -> bool:
        """Retry parked posts under the bounded budget."""
        return self._throttle.drain()

    def retry_queue_depth(self) -> int:
        return len(self._throttle)

    def background_work(self) -> bool:
        raise NotImplementedError

    def pending_work(self) -> bool:
        """True while the parcelport still holds work no completion will
        ever surface on its own (e.g. backpressured posts parked for
        retry).  ``World.drain`` refuses to call a world quiescent while
        any parcelport reports pending work."""
        return bool(self._throttle)

    # -- subclass hook --------------------------------------------------------
    def _send_impl(self, dest: int, parcel: Parcel, cb: Optional[SendCallback]) -> None:
        raise NotImplementedError

    # -- receiver-side glue ---------------------------------------------------
    def deliver(self, parcel: Parcel) -> None:
        self.stats_received += 1
        if is_aggregate(parcel):
            parcels = split_aggregate(parcel)
            if self.engine is not None:
                self.engine.record("deliver", len(parcels))
            for p in parcels:
                self.locality.handle_parcel(p)
        else:
            if self.engine is not None:
                self.engine.record("deliver", 1)
            self.locality.handle_parcel(parcel)
