"""The communication interface the paper argues AMTs need (§2.3, §3.3).

The companion proposal (*Contemplating a Lightweight Communication Interface
for Asynchronous Many-Task Systems*, arXiv 2503.15400) turns the paper's
analysis into an explicit contract.  This module is that contract for the
reproduction: every communication backend — the LCI-style device
(:mod:`repro.core.device`) and the MPI emulation (:mod:`repro.core.mpi_sim`)
— speaks the same five-verb surface, and the parcelports above select
protocol paths by *capability*, not by ``isinstance`` checks on the backend.

The surface:

* ``post_send(dst_rank, dst_dev, tag, data, comp)`` — nonblocking tagged
  two-sided send; completes into ``comp``.
* ``post_recv(src_rank, tag, comp)`` — pre-post a tagged receive
  (``src_rank`` may be -1 = any source).
* ``post_put_signal(dst_rank, dst_dev, data, comp)`` — one-sided put whose
  *remote* completion signals the target's dynamic-put completion object
  (LCI's ideal primitive, §3.3.1).  Backends without the capability raise
  :class:`UnsupportedCapabilityError`.
* ``progress()`` — explicitly drive the backend's progress engine (§3.3.4).
* ``poll()`` — completion-test-driven progress: the *implicit* entry point
  (all the progress an MPI-like backend ever gets).

Every post returns a :class:`PostStatus`, making injection backpressure a
first-class part of the interface instead of a boolean side channel:
``OK`` truthy, the two ``EAGAIN_*`` refusals falsy (so legacy
``if not post(...)`` call sites keep working) and distinguishable — a full
descriptor ring and an exhausted bounce pool are different resources with
different remedies (§3.3.4).

Completion delivery is unified by :class:`CompletionTarget`: completion
queues, synchronizers, and synchronizer pools all expose
``signal(item)`` / ``reap() -> item | None`` (see
:mod:`repro.core.completion`), so a backend never needs to know which kind
of completion object its client chose (§3.3.2 / §5.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Optional, Protocol, runtime_checkable

__all__ = [
    "PostStatus",
    "Capabilities",
    "CompletionTarget",
    "CommInterface",
    "UnsupportedCapabilityError",
    "complete",
]


class UnsupportedCapabilityError(RuntimeError):
    """A protocol path was requested that the backend's
    :class:`Capabilities` does not advertise (e.g. a one-sided put on the
    MPI backend).  Parcelports avoid this by consulting ``capabilities``
    before selecting a path."""


class PostStatus(Enum):
    """Result of a nonblocking post (§3.3.4 resource boundedness).

    Truthiness follows success, so ``if not comm.post_send(...)`` reads the
    same as the historical boolean API while the enum distinguishes *which*
    finite resource refused the post."""

    OK = "ok"
    EAGAIN_QUEUE = "eagain_queue"  # descriptor ring (send queue) full
    EAGAIN_BUFFER = "eagain_buffer"  # registered bounce-buffer pool exhausted
    # the target rank is DRAINING or GONE under the membership layer
    # (core/comm/membership.py): the post must be re-queued by the caller,
    # never silently dropped — a lifecycle refusal, not a resource one
    EAGAIN_DRAINING = "eagain_draining"

    def __bool__(self) -> bool:
        return self is PostStatus.OK

    @property
    def ok(self) -> bool:
        return self is PostStatus.OK


@dataclass(frozen=True)
class Capabilities:
    """What a communication backend can do — the selection surface.

    Parcelports branch on these flags instead of on the backend's concrete
    type, which is exactly the "communication abstraction" boundary the
    paper formalizes (§2.3): the same parcelport logic drives any backend
    that advertises the needed capability.
    """

    #: one-sided put with remote-completion signal (LCI dynamic put, §3.3.1)
    one_sided_put: bool = False
    #: completions may land in shared MPMC completion queues (§3.3.2);
    #: without it the client is limited to per-operation requests (MPI)
    queue_completion: bool = False
    #: the client may invoke the progress engine directly (§3.3.4);
    #: without it progress only happens inside completion tests
    explicit_progress: bool = False
    #: posts surface EAGAIN to the caller instead of buffering internally —
    #: the client can throttle; MPI hides refusals inside the library
    bounded_injection: bool = False


@runtime_checkable
class CompletionTarget(Protocol):
    """One surface over completion queues, synchronizers, and pools.

    ``signal`` is the producer side (the backend reporting a completed
    operation); ``reap`` is the consumer side (the parcelport collecting
    one completed item, or ``None``).  :mod:`repro.core.completion` makes
    every existing completion class conform.
    """

    def signal(self, item: Any) -> None: ...

    def reap(self) -> Optional[Any]: ...


@runtime_checkable
class CommInterface(Protocol):
    """The unified communication interface (see module docstring)."""

    @property
    def capabilities(self) -> Capabilities: ...

    def post_send(
        self, dst_rank: int, dst_dev: int, tag: int, data: bytes,
        comp: CompletionTarget, ctx: Any = None, eager: bool = False,
    ) -> PostStatus: ...

    def post_recv(
        self, src_rank: int, tag: int, comp: CompletionTarget, ctx: Any = None
    ) -> None: ...

    def post_put_signal(
        self, dst_rank: int, dst_dev: int, data: bytes,
        comp: CompletionTarget, ctx: Any = None, eager: bool = False,
    ) -> PostStatus: ...

    def progress(self, max_completions: int = 16) -> bool: ...

    def poll(self, max_completions: int = 16) -> bool: ...


def complete(target: Any, item: Any) -> None:
    """Signal a completion into any target.

    Prefers the unified ``signal`` surface; falls back to ``push`` for
    duck-typed legacy objects that predate :class:`CompletionTarget`."""
    signal = getattr(target, "signal", None)
    if signal is not None:
        signal(item)
    else:
        target.push(item)
