"""The serving hand-off over the paper's CommInterface verbs.

Port of ``repro/core/comm/collective.py``:

* :class:`CollectiveGroup` — the transport: ``(rank, device)`` endpoints
  exchanging byte messages, bounded by one shared
  :class:`~.resources.ResourceLimits`.  The default **pure-python
  loopback** stage hands the bytes over as they are; ``stage='device'``
  (the reference's ``stage='jax'``) moves every progress drain through
  ONE staged buffer on a device — the payloads concatenated, one copy to
  the device and one back, sliced into views — which is what an
  all-to-all over the collectives layer degenerates to on one host.
* :class:`CollectiveComm` — one endpoint, a full five-verb
  :class:`~.interface.CommInterface` backend: tagged ``post_send`` /
  ``post_recv`` with an unexpected-message queue, typed
  :class:`~.interface.PostStatus` refusals (``EAGAIN_QUEUE`` on a full
  transit ring, ``EAGAIN_BUFFER`` on exhausted bounce accounting),
  explicit ``progress`` / ``poll``, and honest capabilities (no one-sided
  put).
* :class:`CommChannel` — the serving stack's request/response hand-off
  over a collective or a shared-memory
  (:class:`~.shmem.ShmemGroup`) group: pre-posted tagged receives
  completing into shared completion queues,
  :class:`~.base.InjectionThrottle` parking on both sides, and responses
  over ``post_put_signal`` wherever the server endpoint's capabilities
  advertise a one-sided put.  N channels share one group in the fleet.
* :class:`CollectiveParcelport` — the LCI parcelport's protocol logic
  (eager/rendezvous selection, aggregation, backpressure throttle, the
  shared :class:`~.progress.ProgressEngine`) over CollectiveComm endpoints
  instead of LCI devices: the ``collective`` variant (plus the
  ``collective_prg{n}`` family).  :func:`collective_group_for` caches one
  group per fabric, so a world whose first call asks for
  ``stage='device'`` moves every parcelport drain through the card.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .base import InjectionThrottle
from .interface import (
    Capabilities,
    CompletionTarget,
    PostStatus,
    UnsupportedCapabilityError,
    complete,
)
from .progress import CompletionRouter, CompletionSource
from .resources import ResourceLimits

__all__ = [
    "CollectiveGroup",
    "CollectiveComm",
    "CollectiveParcelport",
    "CommChannel",
    "collective_group_for",
    "TAG_REQUEST",
    "TAG_RESPONSE",
    "FRAME_OVERHEAD",
]

# Per-message framing overhead (the tag word): THE LCI device's wire
# overhead, imported rather than restated, so eager-capacity arithmetic —
# and therefore the engine's protocol decisions — cannot drift between
# backends.
from ..device import WIRE_OVERHEAD as FRAME_OVERHEAD  # noqa: E402

TAG_REQUEST = 1  # serving hand-off: client -> server request bytes
TAG_RESPONSE = 2  # serving hand-off: server -> client token batches


class _Transit:
    """One posted-but-not-yet-exchanged message in an endpoint's ring."""

    __slots__ = ("dst_rank", "dst_dev", "tag", "data", "comp", "ctx", "eager", "bounce")

    def __init__(self, dst_rank, dst_dev, tag, data, comp, ctx, eager, bounce):
        self.dst_rank = dst_rank
        self.dst_dev = dst_dev
        self.tag = tag
        self.data = data
        self.comp = comp
        self.ctx = ctx
        self.eager = eager
        self.bounce = bounce  # True when the post claimed a bounce buffer


class _Record:
    """What the backend hands back to its client — same duck type as
    :class:`repro_torch.core.device.CompletionRecord` so the parcelport's
    dispatch-by-kind works unchanged across backends."""

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


class CollectiveGroup:
    """The collectives transport: ``n_ranks × devices_per_rank`` endpoints.

    Injection bounds come from one shared :class:`ResourceLimits` (the
    same object the fabric consumes); stats use the fabric's
    :class:`~repro_torch.core.fabric.FabricStats` shape so benchmark code
    reads either transport through one accessor.  ``stage='device'``
    stages every drain through a buffer on ``device`` (``cuda`` unless the
    caller asks for the CPU)."""

    def __init__(
        self,
        n_ranks: int,
        devices_per_rank: int = 1,
        limits: Optional[ResourceLimits] = None,
        stage: str = "loopback",
        device: Any = None,
    ):
        assert stage in ("loopback", "device"), stage
        from ..fabric import FabricStats  # stats shape shared with the fabric

        self.n_ranks = n_ranks
        self.devices_per_rank = max(1, devices_per_rank)
        self.limits = limits or ResourceLimits()
        self.stage = stage
        self.device = None
        if stage == "device":
            from ...device import resolve_device

            self.device = resolve_device(device)
        self.stats = FabricStats()
        # Endpoints on different ranks share these counters, and the
        # collective_prg{n} family sweeps them from real threads — every
        # update takes this lock (the fabric guards its stats likewise).
        self._stats_lock = threading.Lock()
        self._endpoints: Dict[Tuple[int, int], CollectiveComm] = {}
        for r in range(n_ranks):
            for d in range(self.devices_per_rank):
                self._endpoints[(r, d)] = CollectiveComm(self, r, d)

    def endpoint(self, rank: int, dev: int = 0) -> "CollectiveComm":
        return self._endpoints[(rank, dev)]

    def _stage_payload(self, data: bytes) -> Any:
        """Move one payload through the configured stage.  ``'device'``
        rides the accelerator: host → device buffer → host, the one-host
        degenerate form of an all-to-all over the collectives layer."""
        return self._stage_batch([data])[0]

    def _stage_batch(self, datas: List[bytes]) -> List[Any]:
        """Move a whole progress drain through the stage at once.

        ``'device'`` concatenates the batch into ONE staged device buffer:
        one copy to the device and one back per drain (never one pair per
        message: the per-message software overhead the paper's data-plane
        argument is about, §5), sliced back into zero-copy views on
        return.  :class:`~repro_torch.core.fabric.FabricStats` counts the
        staged bytes and batches (``staged_bytes`` / ``staged_batches``)."""
        if self.stage == "loopback" or not datas:
            return datas
        import numpy as np
        import torch

        sizes = [len(d) for d in datas]
        total = sum(sizes)
        flat = np.empty((total,), dtype=np.uint8)
        off = 0
        for d, n in zip(datas, sizes):
            flat[off : off + n] = np.frombuffer(d, dtype=np.uint8)
            off += n
        staged = torch.from_numpy(flat).to(self.device, copy=True)
        back = memoryview(staged.to("cpu", copy=True).numpy())
        with self._stats_lock:
            self.stats.staged_bytes += total
            self.stats.staged_batches += 1
        out: List[Any] = []
        off = 0
        for n in sizes:
            out.append(back[off : off + n])
            off += n
        return out


def collective_group_for(
    fabric: Any, devices_per_rank: int = 1, stage: str = "loopback", device: Any = None
) -> CollectiveGroup:
    """The one :class:`CollectiveGroup` of a world, keyed on its fabric —
    every locality's parcelport joins the same group, and the group draws
    its bounds from ``fabric.limits`` (the shared resource model), so
    ``lci_b{depth}``-style limits bind the collective transport too.  The
    first call fixes ``stage`` and ``device``; later calls get that group."""
    group = getattr(fabric, "_collective_group", None)
    if group is None:
        group = CollectiveGroup(
            fabric.n_ranks, devices_per_rank=devices_per_rank, limits=fabric.limits, stage=stage, device=device
        )
        fabric._collective_group = group
    return group


class CollectiveComm:
    """One endpoint of the collectives transport — a full five-verb
    :class:`~repro_torch.core.comm.interface.CommInterface` backend.

    A post claims a transit-ring slot (``EAGAIN_QUEUE`` when
    ``limits.send_queue_depth`` is exhausted) and, for eager messages, one
    unit of the bounce accounting (``EAGAIN_BUFFER``); both free when the
    endpoint's own :meth:`progress` exchanges the message — a rank that
    stops progressing throttles its own injection, like real hardware.
    Receive matching mirrors the LCI device: posted (src, tag) queues,
    any-source queues, and an unexpected-message queue for arrivals that
    beat their receive."""

    def __init__(self, group: CollectiveGroup, rank: int, dev_index: int):
        self.group = group
        self.rank = rank
        self.dev_index = dev_index
        self._send_lock = threading.Lock()
        self._outbox: deque = deque()  # transit ring (posted, unexchanged)
        self._inflight = 0  # occupied ring slots
        self._bounce_free = group.limits.bounce_buffers
        self._inbox: deque = deque()  # arrived (src_rank, tag, payload)
        self._inbox_lock = threading.Lock()
        self._match_lock = threading.Lock()
        self._posted: Dict[Tuple[int, int], deque] = {}  # (src, tag)
        self._posted_any: Dict[int, deque] = {}  # tag (any-source)
        self._unexpected: Dict[Tuple[int, int], deque] = {}
        self.progress_calls = 0

    @property
    def capabilities(self) -> Capabilities:
        """Honest capabilities: the collectives layer offers no one-sided
        put-with-signal; completions queue, progress is explicit, and
        EAGAIN is surfaced whenever the shared limits bound injection."""
        return Capabilities(
            one_sided_put=False,
            queue_completion=True,
            explicit_progress=True,
            bounded_injection=self.group.limits.bounded,
        )

    def eager_capacity(self) -> Optional[int]:
        """Largest eager message this endpoint can inject (None = no
        bounce accounting = unlimited) — same contract as the LCI device."""
        lim = self.group.limits
        return lim.bounce_buffer_size if lim.bounce_buffers > 0 else None

    # ------------------------------------------------------------------ posts
    def post_send(
        self, dst_rank: int, dst_dev: int, tag: int, data: bytes,
        comp: CompletionTarget, ctx: Any = None, eager: bool = False,
    ) -> PostStatus:
        """Nonblocking tagged send; ``comp`` completes locally once the
        message is exchanged.  Typed EAGAIN on a full transit ring or an
        exhausted eager bounce accounting."""
        lim = self.group.limits
        size = len(data) + FRAME_OVERHEAD
        with self._send_lock:
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
        """Pre-post a tagged receive (``src_rank`` may be -1 = any source).
        Delivery of an already-arrived (unexpected) message happens OUTSIDE
        the matching lock: ``signal`` is an arbitrary client callback and
        may legally post another receive on this endpoint."""
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
        raise UnsupportedCapabilityError(
            "the collectives layer has no one-sided put-with-signal "
            "(capabilities.one_sided_put=False) — use the two-sided path"
        )

    # --------------------------------------------------------------- progress
    def progress(self, max_completions: int = 16) -> bool:
        """Explicitly drive the transport: exchange up to
        ``max_completions`` of this endpoint's posted messages (freeing
        their ring slots / bounce units and signalling send completions),
        then match arrivals waiting in this endpoint's inbox."""
        self.progress_calls += 1
        moved = False
        # Drain the whole batch of posted transits first, then stage them
        # through the transport in ONE device-buffer round trip (see
        # CollectiveGroup._stage_batch): one transfer per drain instead of
        # one per message.  Delivery, stats and completion signalling stay
        # per message, in post order.
        batch: List[_Transit] = []
        with self._send_lock:
            while self._outbox and len(batch) < max_completions:
                batch.append(self._outbox.popleft())
        if batch:
            payloads = self.group._stage_batch([t.data for t in batch])
            for t, payload in zip(batch, payloads):
                dest = self.group.endpoint(t.dst_rank, t.dst_dev)
                with dest._inbox_lock:
                    dest._inbox.append((self.rank, t.tag, payload))
                st = self.group.stats
                with self.group._stats_lock:
                    st.messages += 1
                    st.sends += 1
                    st.bytes += len(payload) + FRAME_OVERHEAD
                    if t.eager:
                        st.eager_msgs += 1
                    else:
                        st.rendezvous_msgs += 1
                with self._send_lock:
                    self._inflight -= 1
                    if t.bounce:
                        self._bounce_free += 1
                complete(t.comp, _Record(op="send", tag=t.tag, ctx=t.ctx))
            moved = True
        for _ in range(max_completions):
            with self._inbox_lock:
                if not self._inbox:
                    break
                src, tag, payload = self._inbox.popleft()
            self._match_incoming(src, tag, payload)
            moved = True
        return moved

    def poll(self, max_completions: int = 16) -> bool:
        """Completion-test-driven progress — the implicit entry point; at
        this layer it shares :meth:`progress`'s implementation (polling
        the transport IS both), as in the LCI device."""
        return self.progress(max_completions)

    def pending_transport(self) -> bool:
        """Anything still moving through this endpoint: unexchanged
        transits or unmatched arrivals (the base hook every channel-capable
        backend exposes)."""
        return bool(self._outbox or self._inbox)

    # --------------------------------------------------------------- matching
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


from ..lci_parcelport import LCIParcelport  # noqa: E402  (no cycle: the
# lci parcelport imports comm.progress/resources only, never this module)


class CollectiveParcelport(LCIParcelport):
    """The LCI parcelport's protocol logic over CollectiveComm endpoints.

    Defined by *difference*: only device creation changes.  Because the
    endpoints advertise ``one_sided_put=False``, the inherited
    capability-driven selection drops the header path to two-sided
    send/recv automatically — no protocol code is duplicated, which is the
    paper's whole point about the abstraction (§2.3).  The engine-parity
    suite asserts the decision traces match the LCI backend's bit for bit.
    """

    def _make_devices(self, fabric: Any, config: Any) -> List[CollectiveComm]:
        group = collective_group_for(fabric, devices_per_rank=config.ndevices)
        return [group.endpoint(self.locality.rank, d) for d in range(config.ndevices)]


class CommChannel:
    """The serving stack's request/response hand-off over CommInterface
    verbs (client = rank 0, server = rank 1 unless given).

    Requests ride ``TAG_REQUEST``, responses (token batches) ride
    ``TAG_RESPONSE``; both directions pre-post tagged receives that
    complete into shared completion queues, re-posted on reap.  Posts the
    transport refuses park in per-direction
    :class:`~.base.InjectionThrottle`\\ s and retry under the shared
    ``limits.retry_budget`` — the serving hot path gets the SAME
    backpressure/throttle behaviour as the parcelport study.

    ``backend='shmem'`` swaps in the true one-sided transport
    (:class:`~.shmem.ShmemGroup`, same two-rank topology); ``stage`` and
    ``device`` choose the collective group's stage.

    **Multi-endpoint registration:** the fleet runs N of these channels
    over ONE shared group — pass ``group`` plus explicit ``client_rank`` /
    ``server_rank``, and a shared ``response_cq`` so every worker's token
    batches land in the SAME router-owned queue (rank ``client_rank``'s
    slab is genuinely the router-owned slot space on put-capable
    backends).  Put-target registration on the shared client endpoint is
    idempotent: every channel must bind the same landing queue, never
    silently rebind it."""

    PREPOST = 16

    def __init__(
        self,
        limits: Optional[ResourceLimits] = None,
        stage: str = "loopback",
        backend: str = "collective",
        group: Any = None,
        client_rank: int = 0,
        server_rank: int = 1,
        response_cq: Any = None,
        device: Any = None,
    ):
        from ..completion import LCRQueue

        assert backend in ("collective", "shmem"), backend
        self.limits = limits or ResourceLimits()
        if group is not None:
            self.group = group  # fleet: N channels share one group
        elif backend == "shmem":
            from .shmem import ShmemGroup

            self.group: Any = ShmemGroup(2, 1, limits=self.limits, completion_mode="queue")
        else:
            self.group = CollectiveGroup(2, 1, limits=self.limits, stage=stage, device=device)
        self.client_rank, self.server_rank = client_rank, server_rank
        self.client = self.group.endpoint(client_rank, 0)
        self.server = self.group.endpoint(server_rank, 0)
        self.request_cq = LCRQueue()  # server-side: arrived requests
        # client-side: arrived token batches — shared across a fleet's
        # channels when the router passes its own landing queue in
        self.response_cq = LCRQueue() if response_cq is None else response_cq
        self._client_throttle = InjectionThrottle(self.limits.retry_budget)
        self._server_throttle = InjectionThrottle(self.limits.retry_budget)
        # Register the landing queues as put targets where the backend
        # takes one — what makes ``one_sided_put`` honest (a put needs
        # somewhere to complete): responses land in the client's response
        # queue, requests would land in the server's request queue.
        for ep, landing in ((self.client, self.response_cq), (self.server, self.request_cq)):
            if hasattr(ep, "put_target_comp"):
                prev = ep.put_target_comp
                assert prev is None or prev is landing, (
                    "endpoint already bound to a different put landing queue "
                    "(fleet channels must share the router's response_cq)"
                )
                ep.put_target_comp = landing
        # Selected PURELY by Capabilities (never by backend name or type):
        # when the transport advertises one-sided put, responses ride put
        # straight into the router-owned response queue — no tag, no
        # matching, no pre-posted receive consumed (§3.3.1).
        self._put_responses = self.server.capabilities.one_sided_put
        for _ in range(self.PREPOST):
            self.server.post_recv(-1, TAG_REQUEST, self.request_cq, ctx="request")
            self.client.post_recv(-1, TAG_RESPONSE, self.response_cq, ctx="response")

    # -- posting (any thread) ------------------------------------------------
    def _eager(self, payload: bytes) -> bool:
        cap = self.client.eager_capacity()
        return cap is not None and len(payload) + FRAME_OVERHEAD <= cap

    def send_request(self, payload: bytes) -> None:
        """Client → server; parks on EAGAIN, retried by the engine step."""
        eager = self._eager(payload)
        self._client_throttle.post_or_park(
            lambda: self.client.post_send(self.server_rank, 0, TAG_REQUEST, payload, self.response_cq, ctx="sent", eager=eager)
        )

    def send_response(self, payload: bytes) -> None:
        """Server → client; parks on EAGAIN, retried by the engine step.

        With a put-capable backend (``self._put_responses``, from the
        Capabilities alone) the token batch rides one-sided put into the
        client's router-owned response queue; otherwise the two-sided
        tagged path."""
        eager = self._eager(payload)
        if self._put_responses:
            self._server_throttle.post_or_park(
                lambda: self.server.post_put_signal(self.client_rank, 0, payload, self.request_cq, ctx="sent", eager=eager)
            )
            return
        self._server_throttle.post_or_park(
            lambda: self.server.post_send(self.client_rank, 0, TAG_RESPONSE, payload, self.request_cq, ctx="sent", eager=eager)
        )

    # -- the engine's op surface --------------------------------------------
    def router(self) -> CompletionRouter:
        """The channel's completion topology for the shared engine: the
        server-side request queue, then the client-side response queue."""
        return CompletionRouter(
            [CompletionSource("request"), CompletionSource("response")], ndevices=1
        )

    def progress(self) -> bool:
        a = self.client.progress()
        b = self.server.progress()
        return a or b

    def poll(self) -> bool:
        a = self.client.poll()
        b = self.server.poll()
        return a or b

    def drain_retries(self) -> bool:
        a = self._client_throttle.drain()
        b = self._server_throttle.drain()
        return a or b

    def reap(self, source: str) -> Any:
        return (self.request_cq if source == "request" else self.response_cq).reap()

    def repost(self, ctx: Any) -> None:
        """Keep the pre-post depth after reaping a receive completion."""
        if ctx == "request":
            self.server.post_recv(-1, TAG_REQUEST, self.request_cq, ctx="request")
        elif ctx == "response":
            self.client.post_recv(-1, TAG_RESPONSE, self.response_cq, ctx="response")

    def pending_work(self) -> bool:
        """Anything still moving: parked posts, in-flight transport work
        (the backend's ``pending_transport`` hook), or unreaped
        completions."""
        return bool(
            self._client_throttle
            or self._server_throttle
            or self.client.pending_transport()
            or self.server.pending_transport()
            or len(self.request_cq)
            or len(self.response_cq)
        )

    def backpressure_parks(self) -> int:
        return self._client_throttle.parks + self._server_throttle.parks
