"""A minimal process-based discrete-event simulation kernel.

Generator processes yield simulation primitives:

* ``Timeout(dt)``       — resume after ``dt`` simulated seconds,
* ``Acquire(lock)``     — resume once the FIFO lock is held,
* ``Get(store)``        — resume with the next item from a store,
* ``Wait(event)``       — resume once the event fires.

Locks also expose ``try_acquire()`` (immediate, no yield) for try-lock
modeling.  The kernel is deliberately tiny — just enough to model thread
contention, queue service, and message timing for the parcelport study.

**What is modeled:** virtual time, deterministic event ordering (ties break
by schedule order), FIFO lock hand-off with a contention counter, and
queue-occupancy high-water marks on stores (the observability hook the
bounded-injection model reports through).  **What is abstracted away:**
preemption (a process runs until it yields), memory hierarchy, and real OS
scheduling — their *costs* are charged explicitly by the layer above
(:mod:`repro_torch.amtsim.costs`), never inferred here.

Determinism is a contract: two runs of the same workload produce identical
event sequences, which the test suite asserts and the benchmark claims rely
on.  Resource *boundedness* is likewise not this kernel's job — finite send
rings and bounce pools live in :mod:`repro_torch.amtsim.parcelport_sim`, which
models refusal/park/retry with plain state plus ``Timeout`` charges.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Any, Callable, Deque, Generator, List, Optional, Tuple

__all__ = ["Env", "Timeout", "Acquire", "Get", "Wait", "Event", "Lock", "Store"]


class Timeout:
    __slots__ = ("dt",)

    def __init__(self, dt: float):
        self.dt = dt


class Event:
    """One-shot event; processes may Wait() on it, a value rides along."""

    __slots__ = ("fired", "value", "_waiters", "env")

    def __init__(self, env: "Env"):
        self.env = env
        self.fired = False
        self.value: Any = None
        self._waiters: List[Generator] = []

    def fire(self, value: Any = None) -> None:
        if self.fired:
            return
        self.fired = True
        self.value = value
        for proc in self._waiters:
            self.env._resume(proc, value)
        self._waiters.clear()


class Wait:
    __slots__ = ("event",)

    def __init__(self, event: Event):
        self.event = event


class Lock:
    """FIFO mutex."""

    __slots__ = ("env", "held", "_waiters", "contentions", "acquisitions")

    def __init__(self, env: "Env"):
        self.env = env
        self.held = False
        self._waiters: Deque[Generator] = deque()
        self.contentions = 0
        self.acquisitions = 0

    def try_acquire(self) -> bool:
        if self.held:
            self.contentions += 1
            return False
        self.held = True
        self.acquisitions += 1
        return True

    def release(self) -> None:
        assert self.held
        if self._waiters:
            proc = self._waiters.popleft()
            self.acquisitions += 1
            self.env._resume(proc, None)
        else:
            self.held = False


class Acquire:
    __slots__ = ("lock",)

    def __init__(self, lock: Lock):
        self.lock = lock


class Store:
    """Unbounded FIFO store; Get blocks until an item arrives.

    Tracks its occupancy high-water mark (``max_depth``) so models built on
    top can report queue-depth statistics — e.g. run-queue backlog or the
    parcelport's aggregation queues — without instrumenting every put."""

    __slots__ = ("env", "items", "_getters", "max_depth")

    def __init__(self, env: "Env"):
        self.env = env
        self.items: Deque[Any] = deque()
        self._getters: Deque[Generator] = deque()
        self.max_depth = 0

    def put(self, item: Any) -> None:
        if self._getters:
            proc = self._getters.popleft()
            self.env._resume(proc, item)
        else:
            self.items.append(item)
            if len(self.items) > self.max_depth:
                self.max_depth = len(self.items)

    def get_nowait(self) -> Optional[Any]:
        if self.items:
            return self.items.popleft()
        return None

    def __len__(self) -> int:
        return len(self.items)


class Get:
    __slots__ = ("store",)

    def __init__(self, store: Store):
        self.store = store


class Env:
    def __init__(self) -> None:
        self.now = 0.0
        self._heap: List[Tuple[float, int, Generator, Any]] = []
        self._ids = itertools.count()
        self._nproc = 0

    # -- process management ---------------------------------------------------
    def process(self, gen: Generator) -> Generator:
        self._nproc += 1
        self._schedule(0.0, gen, None)
        return gen

    def _schedule(self, delay: float, gen: Generator, value: Any) -> None:
        heapq.heappush(self._heap, (self.now + delay, next(self._ids), gen, value))

    def _resume(self, gen: Generator, value: Any) -> None:
        self._schedule(0.0, gen, value)

    def timeout_event(self, dt: float) -> Event:
        ev = Event(self)
        dummy = self._fire_later(ev)
        self._schedule(dt, dummy, None)
        return ev

    @staticmethod
    def _fire_later(ev: Event) -> Generator:
        def g():
            ev.fire()
            return
            yield  # pragma: no cover - makes this a generator

        return g()

    # -- main loop --------------------------------------------------------------
    def run(self, until: float = float("inf"), max_events: int = 50_000_000) -> None:
        n = 0
        while self._heap and n < max_events:
            t, _i, gen, value = heapq.heappop(self._heap)
            if t > until:
                self.now = until
                return
            self.now = t
            n += 1
            try:
                cmd = gen.send(value)
            except StopIteration:
                continue
            self._dispatch(gen, cmd)
        if n >= max_events:
            raise RuntimeError("DES event budget exceeded (livelock?)")

    def _dispatch(self, gen: Generator, cmd: Any) -> None:
        if isinstance(cmd, Timeout):
            self._schedule(cmd.dt, gen, None)
        elif isinstance(cmd, Acquire):
            lock = cmd.lock
            if lock.held:
                lock.contentions += 1
                lock._waiters.append(gen)
            else:
                lock.held = True
                lock.acquisitions += 1
                self._resume(gen, None)
        elif isinstance(cmd, Get):
            store = cmd.store
            if store.items:
                self._resume(gen, store.items.popleft())
            else:
                store._getters.append(gen)
        elif isinstance(cmd, Wait):
            ev = cmd.event
            if ev.fired:
                self._resume(gen, ev.value)
            else:
                ev._waiters.append(gen)
        else:  # pragma: no cover - defensive
            raise TypeError(f"process yielded unknown command {cmd!r}")
