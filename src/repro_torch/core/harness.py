"""Shared delivery harness over the functional parcelport stack.

One helper used by the benchmark smoke gate, the protocol benchmarks, and
the test suite: build a world for a named variant, push payloads through
``async_action``, drain to quiescence, and hand back the world (for
``world.fabric.stats``) plus what arrived.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .parcelport import World
from .variants import make_parcelport_factory, max_devices, variant_limits

__all__ = ["deliver_payloads", "transport_stats"]


def transport_stats(world: "World"):
    """The stats of whichever transport actually carried the bytes: the
    collective group's when the variant rode the collectives backend,
    the shmem group's on the shared-memory backend, the fabric's
    otherwise.  All share the ``FabricStats`` shape, so benchmark code
    reads any transport through this one accessor."""
    for attr in ("_collective_group", "_shmem_group"):
        group = getattr(world.fabric, attr, None)
        if group is not None:
            return group.stats
    return world.fabric.stats


def deliver_payloads(
    variant: str,
    payloads: Sequence[bytes],
    n_loc: int = 2,
    fabric_kwargs: Optional[Dict[str, Any]] = None,
    zero_copy_threshold: int = 1024,
    max_rounds: int = 100_000,
) -> Tuple[World, List[tuple]]:
    """Send each payload round-robin between localities on ``variant``,
    drain (raises on deadlock / parked posts), return ``(world, got)``."""
    if fabric_kwargs is None:
        # A variant may carry its own resource model (e.g. the lci_b{depth}
        # bounded-injection family): build the fabric from it so the limits
        # actually bind.  Explicit fabric_kwargs always win.
        limits = variant_limits(variant)
        if limits.bounded or limits.recv_slots:
            fabric_kwargs = {"limits": limits}
    world = World(
        n_loc,
        make_parcelport_factory(variant),
        devices_per_rank=max_devices(variant),
        fabric_kwargs=fabric_kwargs,
    )
    got: List[tuple] = []
    for loc in world.localities:
        loc.register_action("sink", lambda *a, _g=got: _g.append(a))
    for i, pl in enumerate(payloads):
        world.localities[i % n_loc].async_action(
            (i + 1) % n_loc, "sink", pl, zero_copy_threshold=zero_copy_threshold
        )
    world.drain(max_rounds=max_rounds)
    return world, got
