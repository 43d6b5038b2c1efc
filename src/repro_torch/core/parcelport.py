"""The HPX parcelport abstraction (paper §2.3, Listing 2) and localities.

The contract a parcelport implements::

    send(locality, parcel, cb) -> None        # any worker thread may call
    background_work() -> bool                 # workers call when idle

and the upper layer provides::

    allocate_zc_chunks(nzc_chunk) -> buffers  # receiver-side zc allocation
    handle_parcel(parcel) -> None             # deliver to the runtime

The library-agnostic machinery — parcel aggregation (paper §2.2.2,
including the threshold-aware drain), backpressure retry parking, and the
send/receive stats — lives in :class:`repro_torch.core.comm.base.ParcelportBase`
and is shared by every concrete parcelport; this module re-exports the
aggregation helpers under their historical names.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional

from .comm.base import (  # noqa: F401  (re-exported public API)
    AGG_MAGIC,
    AGG_MAX_PARCELS,
    AGG_PER_PARCEL_BYTES,
    AGG_PREAMBLE_BYTES,
    AGG_SUB_SHIFT,
    ParcelportBase,
    aggregate_parcels,
    aggregate_projected_bytes,
    is_aggregate,
    split_aggregate,
)
from .fabric import Fabric
from .parcel import Parcel, SendCallback, deserialize_action, serialize_action, zc_sizes_from_nzc

__all__ = [
    "Parcelport",
    "Locality",
    "World",
    "aggregate_parcels",
    "aggregate_projected_bytes",
    "split_aggregate",
]


class Parcelport(ParcelportBase):
    """Abstract parcelport (one per communication library per locality).

    Subclasses implement ``_send_impl`` (per-parcel protocol selection
    against their :class:`~repro_torch.core.comm.interface.CommInterface`
    backend) and ``background_work`` (their progress/completion loop)."""


class Locality:
    """One HPX process: action registry + the upper-layer callbacks."""

    def __init__(self, rank: int, world: "World"):
        self.rank = rank
        self.world = world
        self.actions: Dict[str, Callable[..., Any]] = {}
        self.parcelport: Optional[Parcelport] = None
        # Locality-unique parcel ids, also used as follow-up message tags.
        # Start at 1: tag 0 is reserved for header messages (TAG_HEADER).
        self._pid = itertools.count((rank << 40) + 1)
        self.handled = itertools.count()
        self.handled_count = 0

    def register_action(self, name: str, fn: Callable[..., Any]) -> None:
        self.actions[name] = fn

    # upper-layer callbacks (Listing 2) --------------------------------------
    def allocate_zc_chunks(self, nzc_data: bytes) -> List[bytearray]:
        """Allocate receive buffers for zero-copy chunks; the nzc chunk
        carries their sizes."""
        return [bytearray(sz) for sz in zc_sizes_from_nzc(nzc_data)]

    def handle_parcel(self, parcel: Parcel) -> None:
        action, args = deserialize_action(parcel)
        self.handled_count += 1
        fn = self.actions.get(action)
        if fn is None:
            raise KeyError(f"locality {self.rank}: unknown action {action!r}")
        fn(*args)

    # convenience: HPX async(locality, action, args...) ----------------------
    def async_action(
        self,
        dest: int,
        action: str,
        *args: Any,
        cb: Optional[SendCallback] = None,
        zero_copy_threshold: Optional[int] = None,
    ) -> None:
        kw = {}
        if zero_copy_threshold is not None:
            kw["zero_copy_threshold"] = zero_copy_threshold
        parcel = serialize_action(next(self._pid), self.rank, dest, action, args, **kw)
        assert self.parcelport is not None, "parcelport not attached"
        self.parcelport.send(dest, parcel, cb)


class World:
    """A set of in-process localities joined by one fabric."""

    def __init__(
        self,
        n_localities: int,
        parcelport_factory: Callable[["Locality", Fabric], Parcelport],
        devices_per_rank: int = 1,
        fabric_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self.fabric = Fabric(n_localities, devices_per_rank=devices_per_rank, **(fabric_kwargs or {}))
        self.localities = [Locality(r, self) for r in range(n_localities)]
        for loc in self.localities:
            loc.parcelport = parcelport_factory(loc, self.fabric)
        # Optional lifecycle table (core.comm.membership): a consumer that
        # tracks workers against this world attaches its Membership here so
        # close() can run the abandoned-member liveness sweep BEFORE the
        # parcelports release their resources.
        self.membership: Optional[Any] = None

    def progress_all(self, rounds: int = 1) -> bool:
        """Drive every locality's background work (single-threaded pump,
        used by tests; the executor drives this from worker threads)."""
        any_progress = False
        for _ in range(rounds):
            for loc in self.localities:
                if loc.parcelport.background_work():
                    any_progress = True
        return any_progress

    def close(self) -> None:
        """Release per-parcelport resources — in particular, stop and join
        any dedicated progress threads (``lci_prg{n}``) so repeated world
        construction cannot accumulate live daemons.

        Teardown ordering matters: the membership sweep runs
        FIRST, so a tracked worker that died without ``leave()`` has its
        ``on_gone`` hook return ring/shmem slots while the transports are
        still alive; only then do the parcelports release resources."""
        if self.membership is not None:
            self.membership.sweep()
        for loc in self.localities:
            close = getattr(loc.parcelport, "close", None)
            if close is not None:
                close()

    def drain(self, max_rounds: int = 100_000) -> None:
        """Pump until quiescent (no progress for a few consecutive rounds).
        Raises if the world stops moving while a parcelport still holds
        parked (backpressured) posts — that is silent message loss, not
        quiescence."""
        idle = 0
        for _ in range(max_rounds):
            if self.progress_all():
                idle = 0
            else:
                idle += 1
                if idle > 8:
                    if any(loc.parcelport.pending_work() for loc in self.localities):
                        raise RuntimeError(
                            "world stalled with backpressured posts still parked "
                            "(undeliverable send: check bounce-buffer sizing / send-queue depth)"
                        )
                    return
        raise RuntimeError("world did not quiesce")
