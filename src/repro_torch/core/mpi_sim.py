"""A faithful-behaviour MPI emulation over the in-process fabric.

Models the MPI properties the paper identifies as the source of the MPI
parcelport's inefficiencies (§3.3):

* a **single device** per process, wrapped in one coarse-grained blocking
  lock (the typical MPI+UCX structure, §3.3.3);
* the only completion mechanism is the per-operation request object,
  tested one at a time (``MPI_Test``), §3.3.2;
* **no explicit progress**: the progress engine runs only as a side effect
  of ``test`` calls (§3.3.4 — "Current MPICH and OpenMPI implementations
  only poll the progress engine during calls to MPI_Test");
* tag matching on every receive, including ``MPI_ANY_SOURCE``;
* concurrent testing of a *shared* request is disallowed (MPI 4.1 §12.6.2),
  so the client (the parcelport) must wrap its own try-lock around tests.

:class:`MPISim` speaks the same unified
:class:`repro_torch.core.comm.interface.CommInterface` as the LCI device — the
classic ``isend``/``irecv``/``test`` surface is a thin veneer over it —
but its :class:`Capabilities` advertise what MPI *cannot* do: no one-sided
put-with-signal, no shared completion queues, no explicit progress, and no
EAGAIN to the caller (refused posts buffer MPI-internally, FIFO, invisible
to the client — the paper's point about MPI hiding resource exhaustion).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional, Tuple

from .comm.interface import Capabilities, PostStatus, UnsupportedCapabilityError
from .completion import Synchronizer
from .device import LCIDevice, LockMode
from .fabric import Fabric

__all__ = ["MPISim", "MPIRequest", "ANY_SOURCE"]

ANY_SOURCE = -1


class MPIRequest:
    __slots__ = ("sync", "kind", "done", "payload", "src")

    def __init__(self, kind: str):
        self.sync = Synchronizer()
        self.kind = kind  # 'send' | 'recv'
        self.done = False
        self.payload: Optional[bytes] = None
        self.src = -1


class MPISim:
    """Per-rank MPI library instance (a CommInterface backend)."""

    capabilities = Capabilities(
        one_sided_put=False,
        queue_completion=False,
        explicit_progress=False,
        bounded_injection=False,  # EAGAIN is swallowed, never surfaced
    )

    def __init__(self, fabric: Fabric, rank: int):
        # MPI internals: one device, coarse-grained *blocking* lock.
        self._dev = LCIDevice(fabric.device(rank, 0), lock_mode=LockMode.BLOCK)
        self.rank = rank
        # MPI's internal global lock (MPI_THREAD_MULTIPLE big lock).
        self._big_lock = threading.Lock()
        # Sends the fabric backpressured, queued MPI-internally and flushed
        # on progress (real MPI buffers nonblocking sends the NIC refuses).
        # FIFO preserves MPI's non-overtaking order guarantee.
        self._pending_posts: deque = deque()

    # -- unified CommInterface surface --------------------------------------
    def post_send(
        self, dst_rank: int, dst_dev: int, tag: int, data: bytes,
        comp: Any, ctx: Any = None, eager: bool = False,
    ) -> PostStatus:
        """Nonblocking tagged send completing into ``comp``.  Always OK:
        MPI never surfaces EAGAIN — a post the fabric refuses queues
        MPI-internally (FIFO) and flushes on progress, which is exactly the
        opacity the paper critiques (the client cannot throttle what it
        cannot see)."""
        with self._big_lock:
            if self._pending_posts or not self._dev.post_send(
                dst_rank, dst_dev, tag, data, comp, ctx=ctx, eager=eager
            ):
                self._pending_posts.append((dst_rank, dst_dev, tag, data, comp, ctx, eager))
        return PostStatus.OK

    def post_recv(self, src_rank: int, tag: int, comp: Any, ctx: Any = None) -> None:
        """Pre-post a tagged receive (``src_rank`` may be ANY_SOURCE)."""
        with self._big_lock:
            self._dev.post_recv(src_rank, tag, comp, ctx=ctx)

    def post_put_signal(
        self, dst_rank: int, dst_dev: int, data: bytes,
        comp: Any, ctx: Any = None, eager: bool = False,
    ) -> PostStatus:
        raise UnsupportedCapabilityError(
            "MPI has no one-sided put-with-signal (capabilities.one_sided_put=False)"
        )

    def progress(self, max_completions: int = 16) -> bool:
        """Drive the library: drain hardware completions, then flush the
        internally-buffered posts.  MPI offers no *explicit* progress verb
        to clients (``capabilities.explicit_progress=False``) — this runs
        only as a side effect of :meth:`test` / :meth:`poll`."""
        with self._big_lock:
            moved = self._dev.progress(max_completions)
            self._flush_pending()
        return moved

    def poll(self, max_completions: int = 16) -> bool:
        """Completion-test-driven (implicit) progress — all MPI ever has."""
        return self.progress(max_completions)

    def _flush_pending(self) -> None:
        """Retry backpressured sends in order; caller holds the big lock."""
        while self._pending_posts:
            dst_rank, dst_dev, tag, data, comp, ctx, eager = self._pending_posts[0]
            if not self._dev.post_send(dst_rank, dst_dev, tag, data, comp, ctx=ctx, eager=eager):
                return
            self._pending_posts.popleft()

    def pending_post_count(self) -> int:
        return len(self._pending_posts)

    # -- the classic MPI veneer over the interface --------------------------
    def isend(self, dest: int, tag: int, data: bytes) -> MPIRequest:
        req = MPIRequest("send")
        status = self.post_send(dest, 0, tag, data, req.sync)
        if not status:  # post_send's contract is Always-OK (queues internally)
            raise RuntimeError(
                f"MPISim.post_send returned {status!r} — the MPI veneer has no "
                "retry path; a refused post here would drop the send silently"
            )
        return req

    def irecv(self, source: int, tag: int) -> MPIRequest:
        req = MPIRequest("recv")
        self.post_recv(source, tag, req.sync)
        return req

    def test(self, req: MPIRequest) -> Tuple[bool, Optional[bytes]]:
        """MPI_Test: progress runs here and only here (implicit progress).

        The caller must guarantee no concurrent test of the same request —
        the MPI parcelport does this with try-locks around its request
        pools, which is exactly the structure the paper critiques.
        """
        if req.done:
            return True, req.payload
        # implicit progress as a side effect of testing
        self.poll()
        rec = req.sync.test()
        if rec is None:
            return False, None
        req.done = True
        if req.kind == "recv":
            req.payload = rec.data
            req.src = rec.src_rank
        return True, req.payload
