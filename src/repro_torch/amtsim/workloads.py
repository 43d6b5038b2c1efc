"""The paper's three workloads on the DES parcelport model.

* :func:`flood`   — message-rate microbenchmark (paper Fig 3a): ``nchains``
  very large, ``nsteps = 1`` → one rank floods the other.
* :func:`chains`  — latency microbenchmark (paper Fig 3b): ``nsteps`` large,
  ``nchains`` concurrent ping-pong chains.
* :func:`octotiger` — an octree-structured task graph with Octo-Tiger's
  communication profile (paper Fig 1: frequent small messages, occasional
  large zero-copy transfers, no phases) for the application studies
  (Figs 4, 8, 9).

All return plain dicts so benchmarks can render paper-style tables.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from .costs import DEFAULT_MECHANISMS, EXPANSE, Mechanisms, Platform
from .parcelport_sim import ParcelOp, SimConfig, SimWorld, Task, sim_config_for_variant

__all__ = ["flood", "chains", "octotiger", "MicroResult", "AppResult"]


@dataclass
class MicroResult:
    variant: str
    msg_size: int
    nthreads: int
    elapsed: float
    messages: int
    # bounded-injection/receive counters (zero under the classic unbounded
    # model): EAGAIN refusals, RNR arrival refusals (plus storm-mode
    # retransmission attempts), and the send-ring / bounce-pool /
    # retry-queue occupancy high waters
    backpressure_events: int = 0
    rnr_events: int = 0
    rnr_retries: int = 0
    send_queue_hw: int = 0
    bounce_in_use_hw: int = 0
    retry_queue_hw: int = 0
    # hardware-CQ residency: time completions sat un-reaped —
    # the elastic controller's signal — plus its resize count (zero for
    # fixed variants)
    reap_ewma: float = 0.0
    reap_high: float = 0.0
    reap_p99: float = 0.0
    resizes: int = 0

    @property
    def rate(self) -> float:
        """Delivered parcels per second."""
        return self.messages / self.elapsed if self.elapsed > 0 else 0.0


@dataclass
class AppResult:
    variant: str
    n_nodes: int
    elapsed: float
    tasks: int
    messages: int
    bytes: int
    # bounded-injection/receive counters (zero under the unbounded model)
    backpressure_events: int = 0
    rnr_events: int = 0
    rnr_retries: int = 0
    send_queue_hw: int = 0
    bounce_in_use_hw: int = 0
    retry_queue_hw: int = 0
    reap_ewma: float = 0.0
    reap_high: float = 0.0
    reap_p99: float = 0.0
    resizes: int = 0


def _reap_kwargs(world: SimWorld) -> dict:
    """Reap-latency + elastic telemetry shared by every result type."""
    return {
        "reap_ewma": world.reap_lat_ewma,
        "reap_high": world.reap_lat_high,
        "reap_p99": world.reap_p99(),
        "resizes": world.resizes,
    }


def _world(variant: str, n_ranks: int, workers: int, platform: Platform, mech: Mechanisms) -> SimWorld:
    cfg = sim_config_for_variant(variant) if isinstance(variant, str) else variant
    return SimWorld(n_ranks, workers, cfg, platform=platform, mech=mech)


# --------------------------------------------------------------------- flood
def flood(
    variant: str,
    msg_size: int = 8,
    nthreads: int = 16,
    nmsgs: int = 20_000,
    platform: Platform = EXPANSE,
    mech: Mechanisms = DEFAULT_MECHANISMS,
    max_seconds: float = 5.0,
) -> MicroResult:
    """Rank 0 (nthreads workers) floods rank 1; rate measured at delivery."""
    world = _world(variant, 2, nthreads, platform, mech)
    state = {"delivered": 0, "t_done": None}

    def on_delivered() -> None:
        state["delivered"] += 1
        if state["delivered"] >= nmsgs:
            state["t_done"] = world.env.now
            world.stop()

    def sender_action(worker):
        if world.stopped:
            return None
        op = world.make_parcel(0, 1, msg_size, on_delivered)
        return world.send_parcel(worker, op)

    # one task per message — the paper's benchmark is a task graph with
    # nchains single-send tasks, not a tight per-thread send loop
    for _ in range(nmsgs):
        world.spawn(0, Task(action=sender_action))
    world.run(until=max_seconds)
    elapsed = state["t_done"] if state["t_done"] is not None else world.env.now
    inj = world.injection_stats()
    return MicroResult(
        variant=variant if isinstance(variant, str) else variant.name,
        msg_size=msg_size,
        nthreads=nthreads,
        elapsed=max(elapsed, 1e-12),
        messages=state["delivered"],
        backpressure_events=inj["backpressure_events"],
        rnr_events=inj["rnr_events"],
        rnr_retries=inj["rnr_retries"],
        send_queue_hw=inj["send_queue_hw"],
        bounce_in_use_hw=inj["bounce_in_use_hw"],
        retry_queue_hw=inj["retry_queue_hw"],
        **_reap_kwargs(world),
    )


# -------------------------------------------------------------------- chains
def chains(
    variant: str,
    msg_size: int = 8,
    nchains: int = 64,
    nsteps: int = 50,
    nthreads: int = 16,
    platform: Platform = EXPANSE,
    mech: Mechanisms = DEFAULT_MECHANISMS,
    max_seconds: float = 10.0,
) -> MicroResult:
    """``nchains`` ping-pong chains alternating rank 0 ↔ rank 1;
    reported ``elapsed`` is the mean one-way hop latency."""
    world = _world(variant, 2, nthreads, platform, mech)
    remaining = {"chains": nchains}
    total_steps = nchains * nsteps

    def make_hop(chain: int, step: int):
        """Delivery of step `step` spawns the task that sends step+1."""

        def on_delivered() -> None:
            src = (step + 1) % 2
            if step + 1 >= nsteps:
                remaining["chains"] -= 1
                if remaining["chains"] == 0:
                    world.stop()
                return

            def action(worker):
                op = ParcelOp(src=src, dst=1 - src, size=msg_size, on_delivered=make_hop(chain, step + 1))
                return world.send_parcel(worker, op)

            world.spawn(src, Task(action=action))

        return on_delivered

    def first_send(chain: int):
        def action(worker):
            op = ParcelOp(src=0, dst=1, size=msg_size, on_delivered=make_hop(chain, 0))
            return world.send_parcel(worker, op)

        return action

    for c in range(nchains):
        world.spawn(0, Task(action=first_send(c)))
    world.run(until=max_seconds)
    hops = total_steps if remaining["chains"] == 0 else max(1, total_steps - remaining["chains"] * nsteps)
    inj = world.injection_stats()
    return MicroResult(
        variant=variant if isinstance(variant, str) else variant.name,
        msg_size=msg_size,
        nthreads=nthreads,
        elapsed=world.env.now / hops * nchains,  # per-hop latency per chain
        messages=hops,
        backpressure_events=inj["backpressure_events"],
        rnr_events=inj["rnr_events"],
        rnr_retries=inj["rnr_retries"],
        send_queue_hw=inj["send_queue_hw"],
        bounce_in_use_hw=inj["bounce_in_use_hw"],
        retry_queue_hw=inj["retry_queue_hw"],
        **_reap_kwargs(world),
    )


# ----------------------------------------------------------------- octotiger
def octotiger(
    variant: str,
    n_nodes: int = 8,
    workers: int = 16,
    total_subgrids: int = 512,
    timesteps: int = 5,
    task_compute: float = 25e-6,
    small_msg: int = 1024,
    large_msg: int = 65536,
    large_every: int = 16,
    neighbors_per_task: int = 3,
    platform: Platform = EXPANSE,
    mech: Mechanisms = DEFAULT_MECHANISMS,
    max_seconds: float = 60.0,
    seed: int = 0,
) -> AppResult:
    """Strong-scaling octree task graph with Octo-Tiger's message profile.

    ``total_subgrids`` octants are distributed over ``n_nodes`` ranks
    (over-decomposed: subgrids ≫ workers).  Each timestep, every subgrid
    runs one compute task, then sends boundary data to ``neighbors_per_task``
    neighbor subgrids (mostly small control/boundary messages, every
    ``large_every``-th a large zero-copy transfer — Fig 1's distribution).
    A subgrid's next-step task becomes runnable once it received all its
    neighbor messages for the current step — dependency-driven, no global
    barrier.  Strong scaling: per-rank work shrinks with ``n_nodes`` while
    the communication surface grows, exactly the regime where parcelport
    efficiency dominates (paper Fig 4).
    """
    rng = _LCG(seed)
    world = _world(variant, n_nodes, workers, platform, mech)
    per_rank = max(1, total_subgrids // n_nodes)
    n_sub = per_rank * n_nodes

    # neighbor map: octree siblings + across-rank faces (deterministic)
    owner = lambda g: g // per_rank  # noqa: E731
    neighbors: List[List[int]] = []
    for g in range(n_sub):
        nb = set()
        base = (g // 8) * 8
        for k in range(1, neighbors_per_task + 1):
            nb.add(base + (g + k) % 8)  # octree siblings (often same rank)
        nb.add((g + per_rank) % n_sub)  # face neighbor on the next rank
        nb.discard(g)
        neighbors.append(sorted(nb))

    # dependency bookkeeping: arrivals[g][step] counts received messages
    need: List[int] = [0] * n_sub
    for g in range(n_sub):
        for nb in neighbors[g]:
            need[nb] += 1
    arrivals: Dict[int, int] = {}
    done_tasks = {"n": 0, "target": n_sub * timesteps}
    msg_serial = {"n": 0}

    def run_subgrid(g: int, step: int) -> None:
        def action(worker):
            def gen():
                for nb in neighbors[g]:
                    dst = owner(nb)
                    msg_serial["n"] += 1
                    big = msg_serial["n"] % large_every == 0
                    size = large_msg if big else small_msg
                    if dst == owner(g):
                        # local delivery: scheduler hand-off, no parcelport
                        on_msg(nb, step)
                        continue
                    op = world.make_parcel(owner(g), dst, size, _mk_on_msg(nb, step))
                    yield from world.send_parcel(worker, op)
                done_tasks["n"] += 1
                if done_tasks["n"] >= done_tasks["target"]:
                    world.stop()

            return gen()

        world.spawn(owner(g), Task(compute=task_compute, action=action))

    def _mk_on_msg(g: int, step: int):
        return lambda: on_msg(g, step)

    def on_msg(g: int, step: int) -> None:
        key = g * timesteps + step
        arrivals[key] = arrivals.get(key, 0) + 1
        if arrivals[key] == need[g] and step + 1 < timesteps:
            run_subgrid(g, step + 1)

    for g in range(n_sub):
        run_subgrid(g, 0)
    world.run(until=max_seconds)
    inj = world.injection_stats()
    return AppResult(
        variant=variant if isinstance(variant, str) else variant.name,
        n_nodes=n_nodes,
        elapsed=world.env.now,
        tasks=done_tasks["n"],
        messages=world.msg_count,
        bytes=world.byte_count,
        backpressure_events=inj["backpressure_events"],
        rnr_events=inj["rnr_events"],
        rnr_retries=inj["rnr_retries"],
        send_queue_hw=inj["send_queue_hw"],
        bounce_in_use_hw=inj["bounce_in_use_hw"],
        retry_queue_hw=inj["retry_queue_hw"],
        **_reap_kwargs(world),
    )


class _LCG:
    """Deterministic tiny RNG (no global random state)."""

    def __init__(self, seed: int):
        self.state = (seed * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)

    def next(self, n: int) -> int:
        self.state = (self.state * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
        return (self.state >> 33) % n
