"""The AMT worker-thread executor (the HPX runtime analogue, paper §2.2.2).

Port's copy of ``repro/core/executor.py``, unchanged but for its imports.

Worker threads execute tasks from per-worker deques (LIFO locally, FIFO
steals — standard work-stealing) and, when idle, pump the communication
runtime — exactly the integration contract of Listing 2.  The pump is the
repo's ONE :class:`~repro_torch.core.comm.progress.ProgressEngine`: pass
``comm=`` any engine-driven endpoint (a parcelport, the serving channel
ops — anything with ``.engine`` and ``.execute(op)``) and each idle worker
runs one canonical engine step (``run_step``) under its own worker id, so
progress policies, completion routing, and backpressure retry apply to
host-side work the same way they do in the parcelport study.  The legacy
opaque ``background_work`` callable remains for callers without an engine.

The training/serving framework uses this executor for all host-side
asynchronous work (checkpoint shard writes, data prefetch, metric sinks),
making the framework itself an asynchronous many-task consumer of the
communication runtime, per the paper's model.  Work stealing doubles as the
host-level straggler mitigation: a slow worker's queue is drained by its
peers.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional

from .comm.membership import join_workers, spawn_worker
from .comm.progress import run_step
from .worker import set_worker_id

__all__ = ["AMTExecutor", "TaskFuture"]


class TaskFuture:
    """Minimal future: set once, readable from any thread."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def set(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("task not finished")
        if self._error is not None:
            raise self._error
        return self._value


class _WorkerState:
    __slots__ = ("deque", "lock", "steals", "executed")

    def __init__(self):
        self.deque: deque = deque()
        self.lock = threading.Lock()
        self.steals = 0
        self.executed = 0


class AMTExecutor:
    """Work-stealing thread pool with parcelport background-work pumping."""

    def __init__(
        self,
        n_workers: int = 2,
        background_work: Optional[Callable[[], bool]] = None,
        comm: Any = None,
        idle_sleep: float = 50e-6,
        name: str = "amt",
    ):
        """``comm``: an engine-driven communication endpoint — anything
        with ``.engine`` (the shared ProgressEngine) and ``.execute(op)``,
        e.g. a parcelport.  Idle workers then run one engine step per pump
        instead of an opaque callable (the Listing 2 contract over the
        shared engine)."""
        self.n_workers = n_workers
        self.background_work = background_work
        self.comm = comm
        self.idle_sleep = idle_sleep
        self._states = [_WorkerState() for _ in range(n_workers)]
        self._stop = threading.Event()
        self._submit_rr = 0
        # worker threads are spawned through the membership layer's
        # ownership surface so lifecycle accounting (tools/check_api.py
        # gate 7) sees every live worker in one place
        self._threads: List[threading.Thread] = []
        for w in range(n_workers):
            self._threads.append(spawn_worker(self._run, name=f"{name}-w{w}", args=(w,)))

    # ------------------------------------------------------------------ API
    def submit(self, fn: Callable[..., Any], *args: Any, worker: Optional[int] = None) -> TaskFuture:
        fut = TaskFuture()
        w = worker if worker is not None else self._submit_rr % self.n_workers
        self._submit_rr += 1
        st = self._states[w]
        with st.lock:
            st.deque.append((fn, args, fut))
        return fut

    def progress(self) -> bool:
        """Explicit progress from the caller thread (paper §3.3.4 applied to
        host work: the train loop pumps this once per step)."""
        return self._pump(0)

    def _pump(self, wid: int) -> bool:
        """One communication pump: a canonical step of the shared engine
        when a comm endpoint is attached, else the legacy callable."""
        if self.comm is not None:
            return run_step(self.comm.engine, self.comm, wid)
        if self.background_work is not None:
            return self.background_work()
        return False

    def pending(self) -> int:
        return sum(len(s.deque) for s in self._states)

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        if wait:
            join_workers(self._threads)

    def stats(self) -> dict:
        return {
            "executed": [s.executed for s in self._states],
            "steals": [s.steals for s in self._states],
        }

    # ------------------------------------------------------------- internals
    def _pop_local(self, w: int):
        st = self._states[w]
        with st.lock:
            if st.deque:
                return st.deque.pop()  # LIFO: cache-warm own tasks
        return None

    def _steal(self, w: int):
        n = self.n_workers
        for k in range(1, n):
            victim = self._states[(w + k) % n]
            with victim.lock:
                if victim.deque:
                    self._states[w].steals += 1
                    return victim.deque.popleft()  # FIFO steal
        return None

    def _run(self, w: int) -> None:
        set_worker_id(w)
        st = self._states[w]
        while not self._stop.is_set():
            task = self._pop_local(w) or self._steal(w)
            if task is not None:
                fn, args, fut = task
                try:
                    fut.set(fn(*args))
                except BaseException as e:  # noqa: BLE001 - report via future
                    fut.set_error(e)
                st.executed += 1
                continue
            # Idle: pump the communication runtime (Listing 2 contract) —
            # one shared-engine step under this worker's id.
            try:
                progressed = self._pump(w)
            except BaseException:
                progressed = False
            if not progressed:
                time.sleep(self.idle_sleep)
