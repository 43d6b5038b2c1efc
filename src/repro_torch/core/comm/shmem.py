"""ShmemComm — the shared-memory :class:`CommInterface` backend with a
TRUE one-sided ``post_put_signal``.

Port of ``repro/core/comm/shmem.py``.  The sender writes the payload
directly into a **receiver-owned slot** of a shared-memory segment and
raises a signal, with no tag matching and no posted receive on the
critical path — LCI's ideal primitive (paper §3.3.1).  One segment
carries the three rungs of the capability ladder:

* **two-sided emulation** (``post_send`` / ``post_recv``): the same
  slots, but messages carry a tag and the receiver runs the
  posted/unexpected matching path;
* **put-signal** (``completion_mode='signal'``): the sender raises the
  per-slot state byte; the receiver's progress discovers completed puts
  by *scanning* the raised signals;
* **put + queue-completion** (``completion_mode='queue'``): after
  writing the slot the sender enqueues a completion descriptor into the
  receiver's completion ring; receiver progress pops descriptors, never
  scans (the paper's preferred mechanism, §3.3.1/§3.3.2).

Slot/buffer accounting draws from one shared
:class:`~repro_torch.core.comm.resources.ResourceLimits`
(``recv_slots`` sizes the receiver-owned slot array,
``bounce_buffer_size`` the slot payload capacity, ``send_queue_depth``
the sender's transit ring), and stats use the collective transport's
:class:`~repro_torch.core.comm.collective.FabricStats`.  The reference's
``ShmemParcelport`` (the LCI parcelport over these endpoints) waits for
the parcelport layer of the port.

Segment backing: ``'anon'`` (default) maps an anonymous shared page range
(``mmap(-1, n)``) — real shared memory, reclaimed by plain GC;
``'shm'`` uses named POSIX segments via :mod:`multiprocessing.shared_memory`
(close/unlink by an explicit :meth:`ShmemGroup.close` plus a
``weakref.finalize`` backstop).  Both stage payload bytes through the one
shared buffer — the bytes the receiver reads are the bytes in the slab,
not a Python-object hand-off.
"""
from __future__ import annotations

import mmap
import struct
import threading
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ...analysis.sanitizer import make_lock, note_access
from .collective import FRAME_OVERHEAD, FabricStats
from .interface import (
    Capabilities,
    CompletionTarget,
    PostStatus,
    UnsupportedCapabilityError,
    complete,
)
from .resources import ResourceLimits

__all__ = [
    "ShmemSegment",
    "ShmemGroup",
    "ShmemComm",
    "shmem_group_for",
    "live_segments",
    "DEFAULT_SLOTS",
    "FRAME_OVERHEAD",
]

#: receiver-owned slots per endpoint when ``limits.recv_slots`` is 0
#: (the reference LCI device's pre-post depth)
DEFAULT_SLOTS = 64

# In-slab slot header: kind, src_rank, src_dev, tag, payload length (the
# tag is 64-bit: follow-up tags are locality-unique parcel ids, rank << 40).
_SLOT_HDR = struct.Struct("<Biiqi")

_KIND_SEND = 1  # two-sided emulation: receiver must run tag matching
_KIND_PUT = 2  # one-sided put: straight to the put-target completion

# Per-slot state byte (the signal word lives IN the shared slab):
_ST_FREE = 0
_ST_WRITTEN = 1  # committed; announced through the descriptor ring
_ST_SIG = 2  # committed; the raised signal, discovered by scanning


class _LiveCount:
    """Process-wide census of open shmem slabs — the fleet lifecycle leak
    regression asserts this stays flat across create/close cycles, so a
    channel or fleet that forgets to release its segments fails a test
    instead of silently accreting mappings."""

    def __init__(self) -> None:
        self.n = 0
        self._lock = threading.Lock()

    def inc(self) -> None:
        with self._lock:
            self.n += 1

    def dec(self) -> None:
        with self._lock:
            self.n -= 1


_LIVE = _LiveCount()


def live_segments() -> int:
    """Open (created, not yet released) :class:`ShmemSegment` count."""
    return _LIVE.n


class ShmemSegment:
    """One receiver-owned shared-memory slab, partitioned into slots.

    Layout: ``nslots`` state bytes (the signal words), then ``nslots``
    slots of ``_SLOT_HDR.size + slot_size`` bytes each.  Senders claim a
    free slot (:meth:`alloc` — the slot accounting), write header +
    payload bytes straight into the slab (:meth:`write`), and commit by
    flipping the state byte last; the receiver reads the same bytes back
    out (:meth:`read`) and returns the slot (:meth:`free`).
    """

    def __init__(self, nslots: int, slot_size: int, backing: str = "anon"):
        assert backing in ("anon", "shm"), backing
        self.nslots = nslots
        self.slot_size = slot_size
        self.backing = backing
        self._stride = _SLOT_HDR.size + slot_size
        nbytes = nslots + nslots * self._stride
        self._shm = None
        self._mmap = None
        _LIVE.inc()
        if backing == "shm":
            from multiprocessing import shared_memory

            self._shm = shared_memory.SharedMemory(create=True, size=nbytes)
            self.buf = self._shm.buf
            # GC backstop: a group that never reaches ShmemGroup.close()
            # must not leak a named /dev/shm segment past interpreter exit.
            self._finalizer = weakref.finalize(
                self, _release_segment, self._shm, None, None
            )
        else:
            self._mmap = mmap.mmap(-1, nbytes)  # anonymous shared mapping
            self.buf = memoryview(self._mmap)
            # anonymous mappings leak too: fleets create and
            # close worker slabs by the dozen, so release the view and
            # unmap eagerly on close() — with the same GC backstop.
            self._finalizer = weakref.finalize(
                self, _release_segment, None, self._mmap, self.buf
            )
        self._lock = make_lock("ShmemSegment._lock")
        self._free: deque = deque(range(nslots))
        # The completion ring for queue-announced arrivals (put+queue-
        # completion descriptors and two-sided exchanges).
        self._rxq: deque = deque()
        self._rxq_lock = make_lock("ShmemSegment._rxq_lock")
        self._closed = False

    # ------------------------------------------------------- slot accounting
    def alloc(self) -> Optional[int]:
        """Claim one free slot (None = receiver slab exhausted — the
        caller surfaces ``EAGAIN_BUFFER``)."""
        with self._lock:
            note_access("ShmemSegment.slots", id(self))
            return self._free.popleft() if self._free else None

    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    # ----------------------------------------------------------- data plane
    def write(self, idx: int, kind: int, src_rank: int, src_dev: int, tag: int, data: bytes) -> None:
        """The sender's one-sided store: header + payload bytes into the
        slab.  The slot is invisible to the receiver until committed."""
        off = self.nslots + idx * self._stride
        _SLOT_HDR.pack_into(self.buf, off, kind, src_rank, src_dev, tag, len(data))
        start = off + _SLOT_HDR.size
        self.buf[start : start + len(data)] = data

    def commit(self, idx: int, state: int) -> None:
        """Flip the slot's state byte LAST — the signal that makes the
        written bytes visible (``_ST_SIG``: discovered by scanning;
        ``_ST_WRITTEN``: announced through the descriptor ring)."""
        with self._lock:
            note_access("ShmemSegment.slots", id(self))
            self.buf[idx] = state

    def announce(self, idx: int) -> None:
        """Enqueue a completion descriptor into the receiver's ring (the
        put+queue-completion notification; also used by two-sided
        exchanges)."""
        with self._rxq_lock:
            note_access("ShmemSegment.rxq", id(self))
            self._rxq.append(idx)

    def pop_announced(self) -> Optional[int]:
        with self._rxq_lock:
            note_access("ShmemSegment.rxq", id(self))
            return self._rxq.popleft() if self._rxq else None

    def claim_signals(self, max_n: int) -> List[int]:
        """Scan the signal words for raised flags (put-signal discovery):
        a serialized sweep over the state array, claiming up to ``max_n``
        signalled slots."""
        out: List[int] = []
        with self._lock:
            note_access("ShmemSegment.slots", id(self))
            for idx in range(self.nslots):
                if self.buf[idx] == _ST_SIG:
                    self.buf[idx] = _ST_WRITTEN  # claimed, pending read
                    out.append(idx)
                    if len(out) >= max_n:
                        break
        return out

    def read(self, idx: int) -> Tuple[int, int, int, int, bytes]:
        """Read one committed slot back out of the slab:
        ``(kind, src_rank, src_dev, tag, payload)``."""
        off = self.nslots + idx * self._stride
        kind, src_rank, src_dev, tag, length = _SLOT_HDR.unpack_from(self.buf, off)
        start = off + _SLOT_HDR.size
        return kind, src_rank, src_dev, tag, bytes(self.buf[start : start + length])

    def free(self, idx: int) -> None:
        """Return a consumed slot to the receiver-owned pool."""
        with self._lock:
            note_access("ShmemSegment.slots", id(self))
            self.buf[idx] = _ST_FREE
            self._free.append(idx)

    def pending(self) -> bool:
        """Committed-but-unconsumed slots (announced or signalled)."""
        with self._rxq_lock:
            if self._rxq:
                return True
        with self._lock:
            return any(self.buf[i] != _ST_FREE for i in range(self.nslots))

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        """Release the slab (idempotent): named segments close + unlink,
        anonymous mappings release their exported view and unmap.  Either
        way the segment leaves the :func:`live_segments` census."""
        if self._closed:
            return
        self._closed = True
        self._finalizer()  # weakref.finalize is call-once: safe + idempotent


def _release_segment(shm: Any, mm: Any, view: Any) -> None:
    """Static teardown (no ref to the segment — runs from GC finalizers)."""
    _LIVE.dec()
    if view is not None:
        try:
            view.release()
        except BufferError:  # pragma: no cover - exported sub-views alive
            pass
    if mm is not None:
        try:
            mm.close()
        except (BufferError, ValueError):  # pragma: no cover
            pass
    if shm is not None:
        try:
            shm.close()
        except BufferError:  # pragma: no cover - exported views still alive
            return
        try:
            shm.unlink()
        except FileNotFoundError:  # pragma: no cover - already unlinked
            pass


class ShmemGroup:
    """The shared-memory transport: one receiver-owned segment per
    ``(rank, device)`` endpoint.

    ``completion_mode`` selects how remote put completions are announced —
    ``'signal'`` (raised per-slot flags, scanned) or ``'queue'``
    (descriptors into the receiver's completion ring); slot and ring
    bounds come from ONE shared :class:`ResourceLimits`, and stats use
    :class:`~repro_torch.core.comm.collective.FabricStats`, the collective
    transport's, so code reads either transport through one accessor."""

    def __init__(
        self,
        n_ranks: int,
        devices_per_rank: int = 1,
        limits: Optional[ResourceLimits] = None,
        completion_mode: str = "queue",
        backing: str = "anon",
    ):
        assert completion_mode in ("signal", "queue"), completion_mode
        self.n_ranks = n_ranks
        self.devices_per_rank = max(1, devices_per_rank)
        self.limits = limits or ResourceLimits()
        self.completion_mode = completion_mode
        self.backing = backing
        self.nslots = self.limits.recv_slots or DEFAULT_SLOTS
        self.slot_size = self.limits.bounce_buffer_size
        self.stats = FabricStats()
        self._stats_lock = make_lock("ShmemGroup._stats_lock")
        self.segments: Dict[Tuple[int, int], ShmemSegment] = {}
        self._endpoints: Dict[Tuple[int, int], ShmemComm] = {}
        for r in range(n_ranks):
            for d in range(self.devices_per_rank):
                self.segments[(r, d)] = ShmemSegment(self.nslots, self.slot_size, backing=backing)
                self._endpoints[(r, d)] = ShmemComm(self, r, d)

    def endpoint(self, rank: int, dev: int = 0) -> "ShmemComm":
        return self._endpoints[(rank, dev)]

    def close(self) -> None:
        """Release every segment (idempotent).  Groups that skip this are
        covered by the per-segment GC finalizer."""
        for seg in self.segments.values():
            seg.close()


def shmem_group_for(
    owner: Any,
    devices_per_rank: int = 1,
    completion_mode: str = "queue",
    backing: str = "anon",
) -> ShmemGroup:
    """The one :class:`ShmemGroup` of an owner with ``n_ranks`` and
    ``limits`` (the reference's fabric), cached on it: every rank joins the
    same group, drawing bounds from ``owner.limits`` (the shared resource
    model); a second completion mode is refused — one owner, one
    discovery discipline."""
    group = getattr(owner, "_shmem_group", None)
    if group is None:
        group = ShmemGroup(
            owner.n_ranks,
            devices_per_rank=devices_per_rank,
            limits=owner.limits,
            completion_mode=completion_mode,
            backing=backing,
        )
        owner._shmem_group = group
    else:
        assert group.completion_mode == completion_mode, (
            f"one owner, one completion mode: group is "
            f"{group.completion_mode!r}, requested {completion_mode!r}"
        )
    return group


class _Transit:
    """One posted-but-not-yet-exchanged two-sided message."""

    __slots__ = ("dst_rank", "dst_dev", "tag", "data", "comp", "ctx", "eager", "bounce")

    def __init__(self, dst_rank, dst_dev, tag, data, comp, ctx, eager, bounce):
        self.dst_rank = dst_rank
        self.dst_dev = dst_dev
        self.tag = tag
        self.data = data
        self.comp = comp
        self.ctx = ctx
        self.eager = eager
        self.bounce = bounce


class _Record:
    """The completion record every backend hands its client (the
    reference device's ``CompletionRecord`` duck type), so dispatch by
    kind works unchanged across backends."""

    __slots__ = ("op", "tag", "src_rank", "src_dev", "data", "ctx")

    def __init__(self, op, tag=-1, src_rank=-1, src_dev=-1, data=None, ctx=None):
        self.op = op
        self.tag = tag
        self.src_rank = src_rank
        self.src_dev = src_dev
        self.data = data
        self.ctx = ctx


class _PostedRecv:
    __slots__ = ("comp", "ctx")

    def __init__(self, comp: Any, ctx: Any):
        self.comp = comp
        self.ctx = ctx


class ShmemComm:
    """One shared-memory endpoint — a full five-verb
    :class:`~repro_torch.core.comm.interface.CommInterface` backend, and
    the port's only transport that GENUINELY implements ``post_put_signal``.

    A two-sided send claims a transit-ring slot (``EAGAIN_QUEUE`` under
    ``limits.send_queue_depth``) plus, for eager messages, one unit of the
    bounce accounting (``EAGAIN_BUFFER``), and is exchanged into a remote
    slot by this endpoint's own :meth:`progress`.  A put bypasses all of
    that machinery: ``post_put_signal`` claims a **remote** receiver-owned
    slot at post time (``EAGAIN_BUFFER`` when the slab is exhausted —
    slot accounting from the shared limits), writes the payload bytes
    straight into the shared slab, and commits per the group's completion
    mode (raised signal, or a descriptor into the receiver's ring).  The
    local injection completion is delivered by the next :meth:`progress`
    call — completion delivery stays an engine-driven event."""

    def __init__(self, group: ShmemGroup, rank: int, dev_index: int):
        self.group = group
        self.rank = rank
        self.dev_index = dev_index
        self.segment = group.segments[(rank, dev_index)]  # this endpoint's RX slab
        #: completion object remote puts land in (the dynamic-put target);
        #: registered by the client (the channel) — the capability is
        #: advertised only once a target exists, like the LCI device.
        self.put_target_comp: Any = None
        self._send_lock = make_lock("ShmemComm._send_lock")
        self._outbox: deque = deque()  # two-sided transit ring
        self._inflight = 0  # occupied ring slots (sends AND puts)
        self._bounce_free = group.limits.bounce_buffers
        self._put_done: deque = deque()  # (comp, ctx) pending local put completions
        self._match_lock = make_lock("ShmemComm._match_lock")
        self._posted: Dict[Tuple[int, int], deque] = {}  # (src, tag)
        self._posted_any: Dict[int, deque] = {}  # tag (any-source)
        self._unexpected: Dict[Tuple[int, int], deque] = {}
        self.progress_calls = 0

    @property
    def capabilities(self) -> Capabilities:
        """Honest capabilities: one-sided put is real here — advertised
        once a put-target completion object is registered (the selection
        surface the channel consults, §2.3)."""
        return Capabilities(
            one_sided_put=self.put_target_comp is not None,
            queue_completion=True,
            explicit_progress=True,
            bounded_injection=self.group.limits.bounded,
        )

    def eager_capacity(self) -> Optional[int]:
        """Largest eager message this endpoint can inject (None = no
        bounce accounting = unlimited) — same contract as the LCI device
        and the collective endpoint, so protocol decisions cannot drift."""
        lim = self.group.limits
        return lim.bounce_buffer_size if lim.bounce_buffers > 0 else None

    def _check_fits(self, data: bytes) -> None:
        if len(data) > self.group.slot_size:
            raise ValueError(
                f"message of {len(data)} B exceeds the receiver-owned slot "
                f"capacity ({self.group.slot_size} B, limits.bounce_buffer_size)"
            )

    # ------------------------------------------------------------------ posts
    def post_send(
        self, dst_rank: int, dst_dev: int, tag: int, data: bytes,
        comp: CompletionTarget, ctx: Any = None, eager: bool = False,
    ) -> PostStatus:
        """Two-sided emulation rung: nonblocking tagged send, exchanged
        into a remote slot at progress time; typed EAGAIN on a full
        transit ring or an exhausted eager bounce accounting."""
        self._check_fits(data)
        lim = self.group.limits
        size = len(data) + FRAME_OVERHEAD
        with self._send_lock:
            note_access("ShmemComm.send_ring", id(self))
            if lim.send_queue_depth and self._inflight >= lim.send_queue_depth:
                with self.group._stats_lock:
                    self.group.stats.backpressure_events += 1
                return PostStatus.EAGAIN_QUEUE
            bounce = False
            if eager and lim.bounce_buffers > 0:
                if self._bounce_free <= 0 or size > lim.bounce_buffer_size:
                    with self.group._stats_lock:
                        self.group.stats.backpressure_events += 1
                    return PostStatus.EAGAIN_BUFFER
                self._bounce_free -= 1
                bounce = True
            self._inflight += 1
            self._outbox.append(
                _Transit(dst_rank, dst_dev, tag, bytes(data), comp, ctx, eager, bounce)
            )
        return PostStatus.OK

    def post_recv(self, src_rank: int, tag: int, comp: CompletionTarget, ctx: Any = None) -> None:
        """Pre-post a tagged receive (``src_rank`` may be -1 = any
        source).  Unexpected-message delivery happens OUTSIDE the matching
        lock (``signal`` may legally post another receive)."""
        pr = _PostedRecv(comp, ctx)
        matched = None
        with self._match_lock:
            if src_rank >= 0:
                uq = self._unexpected.get((src_rank, tag))
                if uq:
                    matched = uq.popleft()
            else:
                for (s, t), uq in self._unexpected.items():
                    if t == tag and uq:
                        matched = uq.popleft()
                        break
            if matched is None:
                if src_rank >= 0:
                    self._posted.setdefault((src_rank, tag), deque()).append(pr)
                else:
                    self._posted_any.setdefault(tag, deque()).append(pr)
        if matched is not None:
            src, data = matched
            self._deliver_recv(pr, src, tag, data)

    def post_put_signal(
        self, dst_rank: int, dst_dev: int, data: bytes,
        comp: CompletionTarget, ctx: Any = None, eager: bool = False,
    ) -> PostStatus:
        """THE genuine one-sided put (§3.3.1): claim a receiver-owned slot
        in the destination's shared slab, store header + payload bytes
        directly into it, and commit per the group's completion mode —
        raise the per-slot signal or enqueue a completion descriptor into
        the receiver's ring.  No tag, no
        matching, no posted receive.  ``EAGAIN_QUEUE`` on a full local
        injection ring; ``EAGAIN_BUFFER`` when the remote slab has no free
        slot (the receiver-owned slot accounting, shared limits)."""
        if self.put_target_comp is None:
            raise UnsupportedCapabilityError(
                "one-sided put needs a registered put-target completion "
                "object (capabilities.one_sided_put=False on this endpoint)"
            )
        self._check_fits(data)
        lim = self.group.limits
        with self._send_lock:
            note_access("ShmemComm.send_ring", id(self))
            if lim.send_queue_depth and self._inflight >= lim.send_queue_depth:
                with self.group._stats_lock:
                    self.group.stats.backpressure_events += 1
                return PostStatus.EAGAIN_QUEUE
            seg = self.group.segments[(dst_rank, dst_dev)]
            idx = seg.alloc()
            if idx is None:
                with self.group._stats_lock:
                    self.group.stats.backpressure_events += 1
                return PostStatus.EAGAIN_BUFFER
            self._inflight += 1
            # the one-sided store: bytes land in the receiver's slab NOW
            seg.write(idx, _KIND_PUT, self.rank, self.dev_index, -1, bytes(data))
            if self.group.completion_mode == "signal":
                seg.commit(idx, _ST_SIG)  # raise the signal flag
            else:
                seg.commit(idx, _ST_WRITTEN)
                seg.announce(idx)  # descriptor into the receiver's CQ ring
            self._put_done.append((comp, ctx))
        with self.group._stats_lock:
            st = self.group.stats
            st.puts += 1
            st.messages += 1
            st.bytes += len(data)  # puts add no frame overhead
            if eager:
                st.eager_msgs += 1
            else:
                st.rendezvous_msgs += 1
        return PostStatus.OK

    # --------------------------------------------------------------- progress
    def progress(self, max_completions: int = 16) -> bool:
        """Explicitly drive the transport: deliver pending local put
        completions (freeing their ring slots), exchange posted two-sided
        messages into remote slots, then consume this endpoint's own slab —
        descriptor-ring arrivals first (put+queue-completion and two-sided
        exchanges), then a scan of the raised signal flags (put-signal)."""
        self.progress_calls += 1
        moved = False
        # 1. local injection completions for puts already stored remotely
        for _ in range(max_completions):
            with self._send_lock:
                note_access("ShmemComm.send_ring", id(self))
                if not self._put_done:
                    break
                comp, ctx = self._put_done.popleft()
                self._inflight -= 1
            complete(comp, _Record(op="send", ctx=ctx))
            moved = True
        # 2. exchange two-sided transits (flow-controlled by remote slots)
        for _ in range(max_completions):
            with self._send_lock:
                note_access("ShmemComm.send_ring", id(self))
                if not self._outbox:
                    break
                t = self._outbox[0]
                seg = self.group.segments[(t.dst_rank, t.dst_dev)]
                idx = seg.alloc()
                if idx is None:
                    break  # remote slab full: keep FIFO order, retry later
                self._outbox.popleft()
                seg.write(idx, _KIND_SEND, self.rank, self.dev_index, t.tag, t.data)
                seg.commit(idx, _ST_WRITTEN)
                seg.announce(idx)
                self._inflight -= 1
                if t.bounce:
                    self._bounce_free += 1
            with self.group._stats_lock:
                st = self.group.stats
                st.messages += 1
                st.sends += 1
                st.bytes += len(t.data) + FRAME_OVERHEAD
                if t.eager:
                    st.eager_msgs += 1
                else:
                    st.rendezvous_msgs += 1
            complete(t.comp, _Record(op="send", tag=t.tag, ctx=t.ctx))
            moved = True
        # 3. descriptor-ring arrivals (putq completions + two-sided sends)
        for _ in range(max_completions):
            idx = self.segment.pop_announced()
            if idx is None:
                break
            kind, src, src_dev, tag, payload = self.segment.read(idx)
            self.segment.free(idx)
            if kind == _KIND_PUT:
                self._complete_put(src, src_dev, payload)
            else:
                self._match_incoming(src, tag, payload)
            moved = True
        # 4. raised signals (put-signal mode): the serialized scan
        if self.group.completion_mode == "signal":
            for idx in self.segment.claim_signals(max_completions):
                _kind, src, src_dev, _tag, payload = self.segment.read(idx)
                self.segment.free(idx)
                self._complete_put(src, src_dev, payload)
                moved = True
        return moved

    def poll(self, max_completions: int = 16) -> bool:
        """Completion-test-driven progress — the implicit entry point; at
        this layer it shares :meth:`progress`'s implementation, as in the
        LCI device and the collective endpoint."""
        return self.progress(max_completions)

    def pending_transport(self) -> bool:
        """Anything still moving through this endpoint: unexchanged
        transits, undelivered put completions, or unconsumed slots."""
        with self._send_lock:
            note_access("ShmemComm.send_ring", id(self))
            if self._outbox or self._put_done:
                return True
        return self.segment.pending()

    # --------------------------------------------------------------- matching
    def _complete_put(self, src: int, src_dev: int, payload: bytes) -> None:
        if self.put_target_comp is None:
            raise RuntimeError("one-sided put received but no target completion object")
        complete(
            self.put_target_comp,
            _Record(op="put_recv", src_rank=src, src_dev=src_dev, data=payload),
        )

    def _match_incoming(self, src: int, tag: int, payload: bytes) -> None:
        with self._match_lock:
            q = self._posted.get((src, tag))
            if q:
                pr = q.popleft()
            else:
                qa = self._posted_any.get(tag)
                if qa:
                    pr = qa.popleft()
                else:
                    self._unexpected.setdefault((src, tag), deque()).append((src, payload))
                    return
        self._deliver_recv(pr, src, tag, payload)

    def _deliver_recv(self, pr: _PostedRecv, src: int, tag: int, data: bytes) -> None:
        complete(pr.comp, _Record(op="recv", tag=tag, src_rank=src, data=data, ctx=pr.ctx))
