"""In-process "native network layer" with libibverbs semantics (paper §3.1).

This is the lowest layer of the reproduction: it models what Libibverbs (and,
we argue with the paper, Libfabric/Cassini) gives a communication library:

* communication happens between *devices* — sets of hardware resources
  (send queue, receive queue, completion queue).  A process may open several
  devices (→ LCI device replication, uUAR-style hardware parallelism);
* **receives must be pre-posted**; a two-sided send arriving at a device with
  no posted receive triggers an RNR (Receiver Not Ready) event, which real
  hardware turns into a catastrophic retry storm — we count them and make the
  sender retry from its pending queue;
* completed operations are reported **only** through per-device hardware
  completion queues that the library must poll;
* one-sided RDMA put needs no posted receive and can carry a small immediate
  value for remote notification.

Resource boundedness (paper §3.3.4): real NICs have a **finite send queue**
(descriptor ring) and communication libraries draw *eager* messages from a
**finite pool of pre-registered bounce buffers**.  Posting into a full queue
or an exhausted pool fails EAGAIN-style — the library above must retry or
throttle, which is exactly the resource-contention mitigation the paper
credits for LCI's small-message robustness.  Both limits default to
*unbounded* so that higher layers opt in explicitly.  The limits live in
one shared :class:`~repro_torch.core.comm.resources.ResourceLimits` object (the
same model the DES consumes), and refusals are typed
:class:`~repro_torch.core.comm.interface.PostStatus` values — a full descriptor
ring (``EAGAIN_QUEUE``) and an exhausted bounce pool (``EAGAIN_BUFFER``)
are different resources.

Each hardware resource is guarded by its *own* small mutex — "native network
resources typically use distinct locks to ensure thread safety" (§3.3.3).
Coarse-grained locking, when studied, is applied *above* this layer, exactly
where the paper locates it (the communication-library layer).
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock, note_access
from .comm.interface import PostStatus
from .comm.resources import ResourceLimits

__all__ = [
    "Fabric",
    "NetDevice",
    "Completion",
    "FabricStats",
    "RegisteredBufferPool",
]


@dataclass
class Completion:
    """Hardware completion descriptor."""

    kind: str  # 'send' | 'recv' | 'put'
    src_rank: int = -1
    src_dev: int = -1
    data: Optional[bytes] = None  # payload for recv/put completions
    imm: Optional[int] = None  # 4-byte immediate (put with signal)
    ctx: Any = None  # user cookie (send ctx or posted-recv ctx)
    bounce: Any = None  # registered bounce buffer to recycle on send reap


@dataclass
class FabricStats:
    messages: int = 0
    bytes: int = 0
    rnr_events: int = 0
    puts: int = 0
    sends: int = 0
    eager_msgs: int = 0  # messages shipped through the eager protocol
    rendezvous_msgs: int = 0  # header/follow-up (rendezvous) messages
    backpressure_events: int = 0  # EAGAIN-style post rejections
    staged_bytes: int = 0  # payload bytes moved through staged device buffers
    staged_batches: int = 0  # device-buffer staging round trips (1 per drain)


@dataclass
class _SendDesc:
    dst_rank: int
    dst_dev: int
    data: bytes
    ctx: Any
    eager: bool = False
    bounce: Any = None


class RegisteredBufferPool:
    """Finite pool of pre-registered fixed-size bounce buffers.

    Eager sends copy their payload into one of these (registration is
    expensive, so it is done once up front); the buffer returns to the pool
    when the send completion is reaped from the CQ.  ``acquire`` failing is
    the second source of injection backpressure besides the send queue."""

    def __init__(self, nbufs: int, buf_size: int):
        self.buf_size = buf_size
        self.capacity = nbufs
        self._free: deque = deque(bytearray(buf_size) for _ in range(nbufs))
        self._lock = make_lock("RegisteredBufferPool._lock")

    def acquire(self, size: int) -> Optional[bytearray]:
        if size > self.buf_size:
            return None
        with self._lock:
            note_access("RegisteredBufferPool._free", id(self))
            if not self._free:
                return None
            return self._free.popleft()

    def release(self, buf: bytearray) -> None:
        with self._lock:
            note_access("RegisteredBufferPool._free", id(self))
            self._free.append(buf)

    def free_count(self) -> int:
        return len(self._free)


class NetDevice:
    """One set of network hardware resources (≈ QP + CQ + SRQ).

    ``send_queue_depth == 0`` means unbounded (the seed behaviour); a finite
    depth makes :meth:`post_send`/:meth:`post_put` return ``False`` when the
    ring is full.  A send occupies its slot from post until its *send
    completion is reaped* via :meth:`poll_cq` — not polling your CQ
    backpressures your own injection, like real hardware."""

    def __init__(
        self,
        fabric: "Fabric",
        rank: int,
        dev_index: int,
        recv_slots: int = 0,
        send_queue_depth: int = 0,
        bounce_pool: Optional[RegisteredBufferPool] = None,
    ):
        self.fabric = fabric
        self.rank = rank
        self.dev_index = dev_index
        self.send_queue_depth = send_queue_depth
        self.bounce_pool = bounce_pool
        self.bounded = send_queue_depth > 0 or bounce_pool is not None
        # Each resource has a distinct lock (hardware-level concurrency).
        self._recv_lock = make_lock("NetDevice._recv_lock")
        self._cq_lock = make_lock("NetDevice._cq_lock")
        self._send_lock = make_lock("NetDevice._send_lock")
        self._posted_recvs: deque = deque()  # ctx cookies, SRQ-style
        self._cq: deque = deque()  # hardware completion queue
        self._pending_sends: deque = deque()  # RNR'd sends awaiting retry
        self._inflight_sends = 0  # occupied send-queue slots
        for _ in range(recv_slots):
            self._posted_recvs.append(None)

    # -- receive side -------------------------------------------------------
    def post_recv(self, ctx: Any = None) -> None:
        """Pre-post one receive slot (location-agnostic, SRQ semantics)."""
        with self._recv_lock:
            note_access("NetDevice._posted_recvs", id(self))
            self._posted_recvs.append(ctx)

    def posted_recv_count(self) -> int:
        return len(self._posted_recvs)

    # -- send side ----------------------------------------------------------
    def eager_capacity(self) -> Optional[int]:
        """Largest message the eager path can carry here (None = unlimited)."""
        return None if self.bounce_pool is None else self.bounce_pool.buf_size

    def _claim_slot(self, size: int, eager: bool) -> Tuple[PostStatus, Any]:
        """Reserve a send-queue slot (+ bounce buffer for eager sends).
        Returns (status, bounce_buffer); a refusal names the exhausted
        resource (queue vs buffer pool — different remedies)."""
        with self._send_lock:
            note_access("NetDevice.send_ring", id(self))
            if self.send_queue_depth and self._inflight_sends >= self.send_queue_depth:
                self.fabric.stats.backpressure_events += 1
                return PostStatus.EAGAIN_QUEUE, None
            bounce = None
            if eager and self.bounce_pool is not None:
                bounce = self.bounce_pool.acquire(size)
                if bounce is None:
                    self.fabric.stats.backpressure_events += 1
                    return PostStatus.EAGAIN_BUFFER, None
            self._inflight_sends += 1
        return PostStatus.OK, bounce

    def post_send(self, dst_rank: int, dst_dev: int, data: bytes, ctx: Any = None, eager: bool = False) -> PostStatus:
        """Post a two-sided send.  Completion appears in this device's CQ
        once the remote had a posted receive; otherwise the descriptor parks
        in the pending queue and is retried by :meth:`hw_progress` (the
        fabric's stand-in for hardware RNR retransmission).

        Returns a falsy :class:`PostStatus` (EAGAIN) if the send queue is
        full or — for eager sends — no registered bounce buffer is
        available."""
        status, bounce = self._claim_slot(len(data), eager)
        if not status:
            return status
        if bounce is not None:
            bounce[: len(data)] = data  # the copy into registered memory
        desc = _SendDesc(dst_rank, dst_dev, data, ctx, eager=eager, bounce=bounce)
        if not self._try_deliver(desc):
            with self._send_lock:
                note_access("NetDevice.send_ring", id(self))
                self._pending_sends.append(desc)
        return PostStatus.OK

    def post_put(self, dst_rank: int, dst_dev: int, data: bytes, imm: int, ctx: Any = None, eager: bool = False) -> PostStatus:
        """One-sided RDMA put with immediate: lands directly in the remote
        CQ, no posted receive consumed (LCI *dynamic put* maps here).
        Subject to the same send-queue/bounce-pool bounds as two-sided
        sends; returns a falsy :class:`PostStatus` on backpressure."""
        status, bounce = self._claim_slot(len(data), eager)
        if not status:
            return status
        if bounce is not None:
            bounce[: len(data)] = data
        target = self.fabric.device(dst_rank, dst_dev)
        with target._cq_lock:
            note_access("NetDevice._cq", id(target))
            target._cq.append(
                Completion(kind="put", src_rank=self.rank, src_dev=self.dev_index, data=data, imm=imm)
            )
        with self._cq_lock:
            note_access("NetDevice._cq", id(self))
            self._cq.append(Completion(kind="send", ctx=ctx, bounce=bounce))
        st = self.fabric.stats
        st.messages += 1
        st.puts += 1
        st.bytes += len(data)
        if eager:
            st.eager_msgs += 1
        else:
            st.rendezvous_msgs += 1
        return PostStatus.OK

    def _try_deliver(self, desc: _SendDesc) -> bool:
        target = self.fabric.device(desc.dst_rank, desc.dst_dev)
        with target._recv_lock:
            note_access("NetDevice._posted_recvs", id(target))
            if not target._posted_recvs:
                self.fabric.stats.rnr_events += 1
                return False
            recv_ctx = target._posted_recvs.popleft()
        with target._cq_lock:
            note_access("NetDevice._cq", id(target))
            target._cq.append(
                Completion(
                    kind="recv",
                    src_rank=self.rank,
                    src_dev=self.dev_index,
                    data=desc.data,
                    ctx=recv_ctx,
                )
            )
        with self._cq_lock:
            note_access("NetDevice._cq", id(self))
            self._cq.append(Completion(kind="send", ctx=desc.ctx, bounce=desc.bounce))
        st = self.fabric.stats
        st.messages += 1
        st.sends += 1
        st.bytes += len(desc.data)
        if desc.eager:
            st.eager_msgs += 1
        else:
            st.rendezvous_msgs += 1
        return True

    # -- completion / progress ---------------------------------------------
    def poll_cq(self, max_n: int = 16) -> List[Completion]:
        """Poll up to ``max_n`` completions (users must poll with sufficient
        frequency to avoid overflow — we never overflow but the contract
        stands).  Reaping a send completion frees its send-queue slot and
        recycles its bounce buffer."""
        out: List[Completion] = []
        with self._cq_lock:
            note_access("NetDevice._cq", id(self))
            for _ in range(max_n):
                if not self._cq:
                    break
                out.append(self._cq.popleft())
        freed = 0
        for c in out:
            if c.kind == "send":
                freed += 1
                if c.bounce is not None and self.bounce_pool is not None:
                    self.bounce_pool.release(c.bounce)
                    c.bounce = None
        if freed:
            with self._send_lock:
                note_access("NetDevice.send_ring", id(self))
                self._inflight_sends -= freed
        return out

    def hw_progress(self) -> bool:
        """Retry RNR'd sends.  Returns True if anything moved."""
        moved = False
        with self._send_lock:
            note_access("NetDevice.send_ring", id(self))
            pending = list(self._pending_sends)
            self._pending_sends.clear()
        for desc in pending:
            if self._try_deliver(desc):
                moved = True
            else:
                with self._send_lock:
                    note_access("NetDevice.send_ring", id(self))
                    self._pending_sends.append(desc)
        return moved

    def cq_depth(self) -> int:
        return len(self._cq)

    def inflight_sends(self) -> int:
        return self._inflight_sends


class Fabric:
    """The interconnect: a set of (rank, device) endpoints.

    Per-device injection bounds come from one shared
    :class:`~repro_torch.core.comm.resources.ResourceLimits` — pass ``limits``
    directly (the variant registry does, e.g. for the ``lci_b{depth}``
    family), or use the legacy scalar kwargs, which assemble the same
    object.  0 buffers = no pool = eager sends need no registered buffer;
    depth 0 = unbounded ring."""

    def __init__(
        self,
        n_ranks: int,
        devices_per_rank: int = 1,
        recv_slots: int = 0,
        send_queue_depth: int = 0,
        bounce_buffers: int = 0,
        bounce_buffer_size: int = 64 * 1024,
        limits: Optional[ResourceLimits] = None,
    ):
        self.n_ranks = n_ranks
        self.devices_per_rank = devices_per_rank
        self.stats = FabricStats()
        if limits is None:
            limits = ResourceLimits(
                send_queue_depth=send_queue_depth,
                bounce_buffers=bounce_buffers,
                bounce_buffer_size=bounce_buffer_size,
                recv_slots=recv_slots,
            )
        elif recv_slots and not limits.recv_slots:
            limits = limits.variant(recv_slots=recv_slots)
        self.limits = limits
        self._devices: Dict[Tuple[int, int], NetDevice] = {}
        for r in range(n_ranks):
            for d in range(devices_per_rank):
                self._devices[(r, d)] = self._make_device(r, d)

    def _make_device(self, rank: int, dev_index: int) -> NetDevice:
        lim = self.limits
        pool = (
            RegisteredBufferPool(lim.bounce_buffers, lim.bounce_buffer_size)
            if lim.bounce_buffers > 0
            else None
        )
        return NetDevice(
            self,
            rank,
            dev_index,
            recv_slots=lim.recv_slots,
            send_queue_depth=lim.send_queue_depth,
            bounce_pool=pool,
        )

    def device(self, rank: int, dev: int = 0) -> NetDevice:
        return self._devices[(rank, dev)]

    def add_device(self, rank: int) -> NetDevice:
        """Open an extra device on ``rank`` (device replication)."""
        idx = sum(1 for (r, _d) in self._devices if r == rank)
        dev = self._make_device(rank, idx)
        self._devices[(rank, idx)] = dev
        return dev

    def devices_of(self, rank: int) -> List[NetDevice]:
        return [d for (r, _i), d in sorted(self._devices.items()) if r == rank]
