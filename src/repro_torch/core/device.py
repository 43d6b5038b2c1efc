"""The LCI communication-library layer: devices, tag matching, progress.

An :class:`LCIDevice` wraps one :class:`~repro_torch.core.fabric.NetDevice` (the
"complete set of network resources", paper §3.3.3) and adds what a
communication library adds on top of verbs:

* two-sided send/recv with (src, tag) matching and an unexpected-message
  queue (receives may be posted after the message arrives);
* one-sided ``put_dynamic`` whose remote completion lands directly in a
  client-visible completion object (LCI's ideal primitive, §3.3.1);
* **bounded injection**: ``post_send``/``put_dynamic`` return False when the
  underlying fabric refuses the post (full send queue / exhausted bounce
  pool, §3.3.4) — the client retries or throttles;
* an **explicit progress engine** (`progress()`), §3.3.4;
* a configurable **lock discipline** for the factor studies (§5.3):
  ``none``   — fine-grained: only the fabric's per-resource locks,
  ``try``    — one coarse try-lock; progress gives up if contended,
  ``block``  — one coarse blocking lock around every library call.

:class:`LCIDevice` is a full :class:`repro_torch.core.comm.interface.
CommInterface` backend: the five-verb surface (``post_send`` /
``post_recv`` / ``post_put_signal`` / ``progress`` / ``poll``), typed
:class:`PostStatus` backpressure results passed through from the fabric,
and a :class:`Capabilities` descriptor the parcelport consults to select
protocol paths.  Completion objects are anything conforming to
:class:`~repro_torch.core.comm.interface.CompletionTarget` — see
:mod:`repro_torch.core.completion`.
"""
from __future__ import annotations

import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .comm.interface import Capabilities, PostStatus, complete as _complete_target
from .fabric import Fabric, NetDevice

__all__ = ["LCIDevice", "LockMode", "CompletionRecord", "WIRE_OVERHEAD"]


class LockMode:
    NONE = "none"
    TRY = "try"
    BLOCK = "block"


# LCI wire header for two-sided messages: tag; puts carry the target CQ id
# in the immediate instead (no matching at all).
_WIRE_FMT = "<q"
_WIRE_LEN = struct.calcsize(_WIRE_FMT)
# Bytes post_send prepends to every two-sided payload — clients sizing a
# message against a bounce buffer must budget for it (puts add nothing).
WIRE_OVERHEAD = _WIRE_LEN


@dataclass
class CompletionRecord:
    """What the library hands back to its client."""

    op: str  # 'send' | 'recv' | 'put_recv'
    tag: int = -1
    src_rank: int = -1
    src_dev: int = -1
    data: Optional[bytes] = None
    ctx: Any = None


class _PostedRecv:
    __slots__ = ("comp", "ctx")

    def __init__(self, comp: Any, ctx: Any):
        self.comp = comp
        self.ctx = ctx


def _complete(comp: Any, record: CompletionRecord) -> None:
    """Dispatch through the unified CompletionTarget ``signal`` surface
    (queues, synchronizers, and legacy push-only objects alike)."""
    _complete_target(comp, record)


class LCIDevice:
    """Library-level device: matching + progress over one NetDevice."""

    PREPOST_DEPTH = 64

    def __init__(
        self,
        net: NetDevice,
        lock_mode: str = LockMode.NONE,
        put_target_comp: Any = None,
    ):
        self.net = net
        self.lock_mode = lock_mode
        self.put_target_comp = put_target_comp  # completion obj for dynamic puts
        self._coarse = threading.Lock()
        # matching structures (fine-grained lock of their own)
        self._match_lock = threading.Lock()
        self._posted: Dict[Tuple[int, int], deque] = {}  # (src, tag) -> _PostedRecv
        self._posted_any: Dict[int, deque] = {}  # tag -> _PostedRecv (any-source)
        self._unexpected: Dict[Tuple[int, int], deque] = {}
        self.progress_calls = 0
        self.lock_failures = 0
        self._prepost(self.PREPOST_DEPTH)

    @property
    def capabilities(self) -> Capabilities:
        """What this backend can do — the parcelport's selection surface
        (paper §2.3): dynamic put needs a registered target completion
        object, and EAGAIN is only surfaced when the fabric is bounded."""
        return Capabilities(
            one_sided_put=self.put_target_comp is not None,
            queue_completion=True,
            explicit_progress=True,
            bounded_injection=self.net.bounded,
        )

    # ------------------------------------------------------------------ util
    def _prepost(self, n: int) -> None:
        for _ in range(n):
            self.net.post_recv()

    def _acquire(self, try_only: bool = False) -> bool:
        if self.lock_mode == LockMode.NONE:
            return True
        if self.lock_mode == LockMode.TRY and try_only:
            ok = self._coarse.acquire(blocking=False)
            if not ok:
                self.lock_failures += 1
            return ok
        self._coarse.acquire()
        return True

    def _release(self) -> None:
        if self.lock_mode != LockMode.NONE:
            self._coarse.release()

    # ------------------------------------------------------------- two-sided
    def post_send(self, dst_rank: int, dst_dev: int, tag: int, data: bytes, comp: Any, ctx: Any = None, eager: bool = False) -> PostStatus:
        """Nonblocking tagged send; ``comp`` completes locally when sent.
        Returns a falsy :class:`PostStatus` (EAGAIN) when the fabric
        backpressures the post."""
        self._acquire()
        try:
            wire = struct.pack(_WIRE_FMT, tag) + data
            return self.net.post_send(dst_rank, dst_dev, wire, ctx=("send", tag, comp, ctx), eager=eager)
        finally:
            self._release()

    def post_recv(self, src_rank: int, tag: int, comp: Any, ctx: Any = None) -> None:
        """Nonblocking tagged receive; ``src_rank`` may be -1 (any source)."""
        self._acquire()
        try:
            pr = _PostedRecv(comp, ctx)
            with self._match_lock:
                # Check the unexpected queue first.
                if src_rank >= 0:
                    uq = self._unexpected.get((src_rank, tag))
                    if uq:
                        src, data = uq.popleft()
                        self._deliver_recv(pr, src, tag, data)
                        return
                else:
                    for (s, t), uq in self._unexpected.items():
                        if t == tag and uq:
                            src, data = uq.popleft()
                            self._deliver_recv(pr, src, tag, data)
                            return
                if src_rank >= 0:
                    self._posted.setdefault((src_rank, tag), deque()).append(pr)
                else:
                    self._posted_any.setdefault(tag, deque()).append(pr)
        finally:
            self._release()

    def _deliver_recv(self, pr: _PostedRecv, src: int, tag: int, data: bytes) -> None:
        _complete(pr.comp, CompletionRecord(op="recv", tag=tag, src_rank=src, data=data, ctx=pr.ctx))

    # -------------------------------------------------------------- one-sided
    def post_put_signal(self, dst_rank: int, dst_dev: int, data: bytes, comp: Any, ctx: Any = None, eager: bool = False) -> PostStatus:
        """One-sided put into the remote device's dynamic-put completion
        object.  No tag, no matching, no posted receive: the receiver learns
        about the message by reaping its completion target (paper §3.3.1).
        Returns a falsy :class:`PostStatus` (EAGAIN) when the fabric
        backpressures the post."""
        self._acquire()
        try:
            return self.net.post_put(dst_rank, dst_dev, data, imm=0, ctx=("send", -1, comp, ctx), eager=eager)
        finally:
            self._release()

    # historical LCI name for the same primitive
    put_dynamic = post_put_signal

    def eager_capacity(self) -> Any:
        """Largest eager message this device can inject (None = unlimited)."""
        return self.net.eager_capacity()

    # ---------------------------------------------------------------- progress
    def progress(self, max_completions: int = 16) -> bool:
        """Explicit progress (paper §3.3.4): poll the hardware CQ, run the
        matching logic, re-post receives, retry RNR'd sends.  Returns True
        iff any progress was made.  Under ``try`` lock mode a contended call
        returns False immediately — the HPX scheduler has other work."""
        if not self._acquire(try_only=True):
            return False
        try:
            self.progress_calls += 1
            moved = self.net.hw_progress()
            completions = self.net.poll_cq(max_completions)
            reposts = 0
            for c in completions:
                moved = True
                if c.kind == "send":
                    _op, tag, comp, ctx = c.ctx
                    _complete(comp, CompletionRecord(op="send", tag=tag, ctx=ctx))
                elif c.kind == "put":
                    if self.put_target_comp is None:
                        raise RuntimeError("dynamic put received but no target completion object")
                    _complete(
                        self.put_target_comp,
                        CompletionRecord(op="put_recv", src_rank=c.src_rank, src_dev=c.src_dev, data=c.data),
                    )
                elif c.kind == "recv":
                    reposts += 1
                    (tag,) = struct.unpack_from(_WIRE_FMT, c.data, 0)
                    payload = c.data[_WIRE_LEN:]
                    self._match_incoming(c.src_rank, tag, payload)
            # keep the pre-post depth (avoid RNR)
            self._prepost(reposts)
            return moved
        finally:
            self._release()

    def poll(self, max_completions: int = 16) -> bool:
        """Completion-test-driven progress — the implicit entry point of
        the unified interface.  At this layer completion delivery and the
        progress engine are fused (polling the hardware CQ *is* both), so
        ``poll`` and :meth:`progress` share one implementation; the
        parcelport's ``progress_mode`` decides which verb it calls when."""
        return self.progress(max_completions)

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
