"""The serving fleet over the comm layer: one router, N model workers.

Port of ``repro/serve/fleet.py``.  One :class:`Router` owns request
admission and response collection; N :class:`ModelWorker`\\ s each hold a
**shard of the slot space** (``slots // workers`` slots, their own decode
cache) and run the SAME :class:`~repro_torch.serve.server.DecodeCore` as
the single-host server, on the one parameter tree and its device.  The
tiers are connected by per-worker
:class:`~repro_torch.core.comm.collective.CommChannel`\\ s over ONE shared
transport group, driven by the one
:class:`~repro_torch.core.comm.progress.ProgressEngine` — scaling out the
serving tier is a backend choice, not a rewrite (the paper's HPX+LCI move
applied to inference serving).

Topology: router = rank 0, worker *w* = rank ``1 + w``.  Every channel
shares the router's landing queue for responses, so on put-capable
backends token batches ride ``post_put_signal`` straight into
**router-owned slots** (rank 0's slab) — selected purely by the
advertised :class:`~repro_torch.core.comm.interface.Capabilities`.
Requests stay two-sided (tagged sends to each worker's rank).

Scheduling:

* **free-slot-load routing** — a new request goes to the worker with the
  most estimated headroom (slot shard + admission queue − outstanding),
  ties to the lowest worker id (deterministic);
* **cache-affinity stickiness** — follow-up prompt chunks always go to
  the worker that admitted the first chunk (its cache holds the prefix);
* **chunked prefill** — prompts longer than ``prefill_chunk`` cross the
  wire split into chunk messages, one per router step, and the worker
  consumes them interleaved with decode (see ``DecodeCore``);
* **typed admission backpressure** — a worker whose admission queue is
  full refuses the request with an ``('eagain', ...)`` response; the
  router RE-QUEUES it (never drops), decrementing that worker's load
  estimate so the retry prefers less-loaded workers;
* **elastic membership** — :meth:`Router.add_worker` /
  :meth:`Router.leave_worker` through
  :class:`~repro_torch.core.comm.membership.Membership`; a leaving
  worker's live slots (mid-decode or mid-prefill) travel to a successor
  as ``checkpoint.snapshot`` bytes over the existing channel.

The headline property (``tests/test_torch_fleet.py``): for any request
trace, the 1-router × N-worker fleet over every backend emits exactly the
per-request token streams of the single-host server — the comm layer and
the sharding move the bytes, not the math, because a row of the batched
decode does not depend on the batch (``models.model.DECODE_TILE``).
"""
from __future__ import annotations

import functools
import itertools
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import obs
from ..checkpoint.snapshot import pack_state, unpack_state
from ..configs.base import ArchConfig
from ..core.comm.collective import CollectiveGroup, CommChannel
from ..core.comm.membership import GONE, Membership
from ..core.comm.progress import (
    CompletionRouter,
    CompletionSource,
    ProgressEngine,
    ProgressPolicy,
    run_step,
)
from ..core.comm.resources import ResourceLimits
from ..core.comm.wire import decode_msg, encode_msg
from .server import DecodeCore, Request

__all__ = ["FleetConfig", "ModelWorker", "Router", "Fleet"]


@dataclass
class FleetConfig:
    workers: int = 2
    slots: int = 4  # TOTAL slot space, sharded slots // workers per worker
    context: int = 256
    max_prefill: int = 64
    # 0 = single-shot prefill at admission; N>0 = prompts cross the wire
    # as N-token chunk messages, consumed interleaved with decode
    prefill_chunk: int = 0
    # per-worker admission-queue bound: a "new" request beyond this is
    # refused with a typed EAGAIN response (router re-queues, never drops)
    admission_depth: int = 2
    # Elastic capacity: rank slots are pre-provisioned for up to
    # max_workers workers (0 = fixed fleet of `workers`), so add_worker /
    # leave_worker never rebuild the transport group — a departed rank's
    # channel and shmem slab are REUSED by the next join, which is what
    # keeps thread/segment counts flat over join/leave cycles.
    max_workers: int = 0
    transport: str = "collective"  # 'inline' | 'collective' | 'shmem'
    # the ProgressPolicy.for_config axes, same as ServeConfig/LCIPPConfig
    progress_mode: str = "explicit"
    lock_mode: str = "none"
    progress_workers: int = 0
    limits: ResourceLimits = field(default_factory=ResourceLimits)


class ModelWorker:
    """One model shard: a :class:`DecodeCore` over ``slots`` of the fleet's
    slot space plus a bounded admission queue.  Transport-blind — the
    router hands it decoded request messages and collects its emissions."""

    def __init__(
        self,
        wid: int,
        arch: ArchConfig,
        params: Any,
        slots: int,
        context: int,
        max_prefill: int,
        prefill_chunk: int,
        admission_depth: int,
    ):
        self.wid = wid
        self.core = DecodeCore(arch, params, slots, context, max_prefill, prefill_chunk)
        self.admission_depth = admission_depth
        self._pending: deque = deque()  # accepted, awaiting a free slot
        self._reqs: Dict[int, Request] = {}  # rid -> worker-side request
        self._open: Dict[int, bool] = {}  # rid -> more chunks expected
        self._adopt_queue: deque = deque()  # handoff snapshots awaiting a slot
        self._adopt_rids: set = set()  # rids whose snapshot awaits splicing
        self._chunk_stash: Dict[int, List[tuple]] = {}  # chunks that outran an adopt
        self.outbox: List[tuple] = []  # (rid, tok, done) of this step
        self.eagain_refusals = 0
        self.adoptions = 0  # slots adopted from departing workers
        self.rids_seen: List[int] = []  # admission order (stickiness proof)

    # --------------------------------------------------------- request plane
    def handle_request(self, msg: tuple) -> Optional[tuple]:
        """Apply one router→worker message.  Returns a refusal message to
        send back, or None."""
        kind = msg[0]
        if kind == "new":
            _, rid, tokens, last, max_new = msg
            self._chunk_stash.pop(rid, None)  # a re-dispatch replans all chunks
            if len(self._pending) >= self.admission_depth:
                # typed admission backpressure: the worker's EAGAIN — the
                # router re-queues the request, it is NEVER dropped here
                self.eagain_refusals += 1
                return ("eagain", self.wid, rid)
            req = Request(rid=rid, prompt=list(tokens), max_new=max_new)
            self._reqs[rid] = req
            self._open[rid] = not last
            self._pending.append(req)
            self.rids_seen.append(rid)
            return None
        if kind == "adopt":
            # a departing worker's slot, serialized by checkpoint.snapshot;
            # queued (admission takes a free slot) and spliced in _admit —
            # adoption has priority over new admissions: it is mid-stream
            _, rid, payload = msg
            self._adopt_queue.append(payload)
            self._adopt_rids.add(rid)
            return None
        assert kind == "chunk", kind
        _, rid, tokens, last = msg
        req = self._reqs.get(rid)
        if req is None:
            if rid in self._adopt_rids:
                # the chunk outran its slot's adoption (the snapshot waits
                # for a free slot): stash it, applied at the splice
                self._chunk_stash.setdefault(rid, []).append((list(tokens), last))
                return None
            # orphan chunk of a refused request: the channel is FIFO per
            # direction, so these all precede any re-dispatched "new"
            return None
        if self.core.prefilling(rid):
            self.core.feed_chunk(rid, list(tokens), last)
        else:  # still queued: extend the prompt before admission
            req.prompt.extend(tokens)
            if last:
                self._open[rid] = False
        if last:
            self._open[rid] = False
        return None

    # ------------------------------------------------------------ decode plane
    def _adopt(self) -> None:
        while self._adopt_queue and self.core.free_slots():
            state, meta = unpack_state(
                self._adopt_queue.popleft(), abstract=self.core.abstract_slot_state()
            )
            req = Request(rid=meta["rid"], prompt=list(meta["prompt"]), max_new=meta["max_new"])
            self._reqs[req.rid] = req
            self._open[req.rid] = bool(meta.get("prefill_open", False))
            self.core.adopt_slot(state, meta, req)
            self.adoptions += 1
            self._adopt_rids.discard(req.rid)
            for tokens, last in self._chunk_stash.pop(req.rid, ()):
                if self.core.prefilling(req.rid):
                    self.core.feed_chunk(req.rid, list(tokens), last)
                else:
                    req.prompt.extend(tokens)
                if last:
                    self._open[req.rid] = False

    def _admit(self) -> None:
        self._adopt()
        while self._pending and self.core.free_slots():
            req = self._pending[0]
            if self.core.prefill_chunk <= 0 and self._open.get(req.rid):
                return  # single-shot prefill needs the whole prompt first
            self._pending.popleft()
            self.core.admit(req, self._emit, more_chunks=self._open[req.rid])

    def _emit(self, req: Request, tok: int, done: bool) -> None:
        self.outbox.append((req.rid, tok, done))
        if done:
            self._reqs.pop(req.rid, None)
            self._open.pop(req.rid, None)

    def step(self) -> bool:
        self._admit()
        return self.core.step(self._emit)

    def busy(self) -> bool:
        return bool(self._pending) or bool(self._adopt_queue) or self.core.active()


class Router:
    """The admission/collection tier.  ``Router`` owns the client-facing
    request objects, the routing + chunking state machine, and (for comm
    transports) the shared group, the per-worker channels and the ONE
    progress engine.  It is also the engine's op adapter (``execute``),
    exactly like :class:`~repro_torch.serve.server.InferenceServer`."""

    def __init__(self, arch: ArchConfig, params: Any, cfg: Optional[FleetConfig] = None):
        self.cfg = cfg = FleetConfig() if cfg is None else cfg
        assert cfg.workers >= 1 and cfg.slots >= cfg.workers, (cfg.workers, cfg.slots)
        self.arch, self.params = arch, params
        self.max_workers = max(cfg.max_workers, cfg.workers)
        self._per_worker_slots = cfg.slots // cfg.workers
        # lifecycle is owned by the Membership subsystem: worker
        # wid == member rank; routing consults the ACTIVE set, racing posts
        # to a DRAINING rank resolve to typed EAGAIN, a worker that dies
        # without leave() is reaped by the finalizer sweep at close()
        self.membership = Membership()
        self.workers: List[Optional[ModelWorker]] = [None] * self.max_workers
        self._rid = itertools.count()
        self._queue: deque = deque()  # un-routed (or re-queued) requests
        self._inflight: Dict[int, Request] = {}  # rid -> client-side request
        self._inflight_lock = threading.Lock()
        self._sticky: Dict[int, int] = {}  # rid -> admitting worker
        self._chunks: Dict[int, deque] = {}  # rid -> unsent chunk messages
        self._orphans: deque = deque()  # handoff snapshots awaiting capacity
        self._outstanding = [0] * self.max_workers  # dispatched - (done|eagain)
        self.eagain_events = 0  # worker refusals observed by the router
        self.requeues = 0
        self.completed = 0
        self.steps = 0
        self.joins = 0
        self.leaves = 0
        self.handoffs = 0
        self.handoff_bytes = 0  # snapshot bytes of the handed-off slots
        # ---- transport ----------------------------------------------------
        # Rank slots are provisioned for max_workers up front: joins and
        # leaves re-point routing, they NEVER rebuild the group — a
        # departed rank's channel/slab is reused by the next join.
        self.group: Any = None
        self.channels: List[CommChannel] = []
        self.engine: Optional[ProgressEngine] = None
        if cfg.transport in ("collective", "shmem"):
            if cfg.transport == "shmem":
                from ..core.comm.shmem import ShmemGroup

                self.group = ShmemGroup(
                    1 + self.max_workers, 1, limits=cfg.limits, completion_mode="queue"
                )
            else:
                self.group = CollectiveGroup(1 + self.max_workers, 1, limits=cfg.limits)
            # channel w: router (rank 0, the shared client endpoint) <->
            # worker w (rank 1+w); ALL channels land responses in channel
            # 0's queue — the router-owned landing slots
            for w in range(self.max_workers):
                self.channels.append(
                    CommChannel(
                        limits=cfg.limits,
                        backend=cfg.transport,
                        group=self.group,
                        client_rank=0,
                        server_rank=1 + w,
                        response_cq=self.channels[0].response_cq if w else None,
                    )
                )
            self.engine = ProgressEngine(
                ProgressPolicy.for_config(cfg).variant(step_lock=True),
                CompletionRouter(
                    [CompletionSource(f"request:{w}") for w in range(self.max_workers)]
                    + [CompletionSource("response")],
                    ndevices=1,
                ),
                ndevices=1,
            )
            self._step_lock = threading.Lock()
        else:
            assert cfg.transport == "inline", cfg.transport
        for _ in range(cfg.workers):
            self.add_worker(initial=True)

    # ------------------------------------------------------- elastic lifecycle
    def add_worker(self, initial: bool = False) -> int:
        """Join a worker on a free rank slot (JOINING → ACTIVE); it picks
        up routing share on the next router step.  The transport was
        provisioned for ``max_workers`` at construction, so a join only
        re-points routing — a departed rank's channel is reused."""
        free = [w for w in range(self.max_workers) if self.membership.state(w) in (None, GONE)]
        if not free:
            raise ValueError(f"fleet is at max_workers={self.max_workers}")
        wid = free[0]
        worker = ModelWorker(
            wid, self.arch, self.params, self._per_worker_slots, self.cfg.context,
            self.cfg.max_prefill, self.cfg.prefill_chunk, self.cfg.admission_depth,
        )
        self.workers[wid] = worker
        self.membership.join(wid, owner=worker, on_gone=functools.partial(_worker_gone, weakref.ref(self)))
        self.membership.activate(wid)
        if not initial:
            self.joins += 1
        return wid

    def leave_worker(self, wid: int) -> bool:
        """Drain worker ``wid`` out of the live fleet: stop admitting,
        pull its un-admitted requests back to the router queue, hand every
        ACTIVE slot to a successor as a ``checkpoint.snapshot`` payload
        over the existing channel (bit-identical continuation), then
        deregister — the rank returns to the free pool.  Idempotent:
        returns False if already DRAINING/GONE."""
        if not any(w != wid for w in self.membership.active_ranks()):
            raise ValueError("cannot drain the last active worker")
        if not self.membership.begin_drain(wid):
            return False
        worker = self.workers[wid]
        # 0) settle the wire: flush emitted tokens, then pump the channel
        #    until nothing to/from the leaver is in flight — an in-flight
        #    "new"/"chunk" must land in the worker's queues (and be drained
        #    below), never die with the rank
        self._flush_workers()
        if self.channels:
            for _ in range(10_000):
                self._comm_step()
                if not self.channels[wid].pending_work():
                    break
        # 1) drain the admission deque: un-admitted requests re-queue at
        #    the router (they re-route by load — zero drops)
        while worker._pending:
            req = worker._pending.popleft()
            worker._reqs.pop(req.rid, None)
            worker._open.pop(req.rid, None)
            self._outstanding[wid] -= 1
            self._sticky.pop(req.rid, None)
            self._chunks.pop(req.rid, None)  # re-planned on re-dispatch
            with self._inflight_lock:
                client_req = self._inflight.get(req.rid)
            if client_req is not None:
                self.requeues += 1
                self._queue.append(client_req)
        # 2) hand off every mid-decode slot, serialized + validated by the
        #    snapshot codec; sticky routing follows the slot
        for slot in worker.core.active_slots():
            state, meta = worker.core.extract_slot(slot)
            rid = meta["rid"]
            worker._reqs.pop(rid, None)
            worker._open.pop(rid, None)
            self._outstanding[wid] -= 1
            self._handoff(rid, pack_state(state, meta))
        # un-adopted snapshots this worker still held travel onward too,
        # with any chunks that outran them re-queued ahead of the plan
        while worker._adopt_queue:
            payload = worker._adopt_queue.popleft()
            _, meta = unpack_state(payload)
            rid = meta["rid"]
            stash = worker._chunk_stash.pop(rid, None)
            if stash:
                rest = self._chunks.setdefault(rid, deque())
                for tokens, last in reversed(stash):
                    rest.appendleft(("chunk", rid, tokens, last))
            self._outstanding[wid] -= 1
            self._handoff(rid, payload)
        # 3) quiesced: deregister, return the rank to the pool
        self.membership.finish_leave(wid)
        self.leaves += 1
        return True

    def _handoff(self, rid: int, payload: bytes) -> None:
        dst = self._pick_successor()
        if dst is None:
            self._orphans.append((rid, payload))  # placed when capacity frees
            return
        self._send_adopt(dst, rid, payload)

    def _send_adopt(self, dst: int, rid: int, payload: bytes) -> None:
        self._sticky[rid] = dst
        self._outstanding[dst] += 1
        self.handoffs += 1
        self.handoff_bytes += len(payload)
        self._send(dst, ("adopt", rid, payload))

    def _pick_successor(self) -> Optional[int]:
        """The ACTIVE worker with the most genuinely free slots (free
        minus queued admissions/adoptions); None if nobody has room."""
        best, best_free = None, 0
        for w in self.membership.active_ranks():
            worker = self.workers[w]
            free = len(worker.core.free_slots()) - len(worker._pending) - len(worker._adopt_queue)
            if free > best_free:
                best, best_free = w, free
        return best

    def _place_orphans(self) -> None:
        for _ in range(len(self._orphans)):
            rid, payload = self._orphans.popleft()
            dst = self._pick_successor()
            if dst is None:
                self._orphans.appendleft((rid, payload))
                return
            self._send_adopt(dst, rid, payload)

    # ------------------------------------------------------------------ client
    def submit(self, prompt: List[int], max_new: int = 16) -> Request:
        req = Request(rid=next(self._rid), prompt=list(prompt), max_new=max_new)
        req.submitted_at = obs.now()
        with self._inflight_lock:
            self._inflight[req.rid] = req
        self._queue.append(req)
        return req

    # ------------------------------------------------- routing + chunk plan
    def _plan(self, req: Request) -> tuple:
        """Split a request into its wire messages: the ``new`` message and
        any follow-up ``chunk`` messages (chunked prefill)."""
        prompt = req.prompt[: self.cfg.max_prefill]
        chunk = self.cfg.prefill_chunk
        if chunk <= 0 or len(prompt) <= chunk:
            return ("new", req.rid, prompt, True, req.max_new), deque()
        pieces = [prompt[i : i + chunk] for i in range(chunk, len(prompt), chunk)]
        rest = deque(
            ("chunk", req.rid, piece, i == len(pieces) - 1)
            for i, piece in enumerate(pieces)
        )
        return ("new", req.rid, prompt[:chunk], False, req.max_new), rest

    def _pick_worker(self) -> Optional[int]:
        """Free-slot-load routing over the ACTIVE membership: most
        headroom wins, ties to the lowest worker id.  Dispatch is
        optimistic — the authoritative bound is the worker's own admission
        queue (its EAGAIN, our re-queue)."""
        active = self.membership.active_ranks()
        if not active:
            return None
        per = self._per_worker_slots

        def headroom(w: int) -> int:
            return per + self.cfg.admission_depth - self._outstanding[w]

        return max(active, key=lambda w: (headroom(w), -w))

    def _send(self, wid: int, msg: tuple) -> None:
        if self.channels:
            self.channels[wid].send_request(encode_msg(msg))
        else:  # inline: same messages, no serialization hop
            refusal = self.workers[wid].handle_request(msg)
            if refusal is not None:
                self._handle_response(encode_msg([refusal]))

    def _route(self) -> None:
        # new (and re-queued) requests: route by load, send first chunk.
        # Snapshot the count: an inline-mode refusal re-queues
        # synchronously, and a refused request must wait for the NEXT
        # router step (after workers have stepped), not spin here.
        for _ in range(len(self._queue)):
            req = self._queue.popleft()
            wid = self._pick_worker()
            if wid is None:
                self._queue.append(req)  # no ACTIVE worker: wait, never drop
                break
            new_msg, rest = self._plan(req)
            self._sticky[req.rid] = wid
            self._chunks[req.rid] = rest
            self._outstanding[wid] += 1
            self._send(wid, new_msg)
        # follow-up chunks: ONE per request per router step, to the sticky
        # worker — prefill traffic interleaves with decode, never bursts
        for rid in list(self._chunks):
            rest = self._chunks.get(rid)
            if rest is None or rid not in self._sticky:
                continue  # refused meanwhile: re-planned on re-dispatch
            if not rest:
                del self._chunks[rid]
                continue
            wid = self._sticky[rid]
            if not self.membership.guard_post(wid):
                # typed EAGAIN_DRAINING: the sticky worker is leaving —
                # the chunk stays queued (its prefill state travels in the
                # handoff snapshot, which re-points sticky), never dropped
                continue
            self._send(wid, rest.popleft())

    # -------------------------------------------------------- response plane
    def _handle_response(self, payload: bytes) -> None:
        now = obs.now()
        for item in decode_msg(payload):
            if item[0] == "eagain":
                _, wid, rid = item
                self.eagain_events += 1
                self.requeues += 1
                self._outstanding[wid] -= 1
                self._sticky.pop(rid, None)
                self._chunks.pop(rid, None)  # re-plan (and re-send) everything
                with self._inflight_lock:
                    req = self._inflight.get(rid)
                if req is not None:
                    self._queue.append(req)  # re-queued, NEVER dropped
                continue
            rid, tok, done = item
            with self._inflight_lock:
                req = self._inflight.get(rid)
            if req is None:
                continue
            if req.first_token_at is None:
                req.first_token_at = now
            req.out_tokens.append(tok)
            if done:
                req.finished_at = now
                req.done_event.set()
                self.completed += 1
                wid = self._sticky.pop(rid, None)
                if wid is not None:
                    self._outstanding[wid] -= 1
                with self._inflight_lock:
                    self._inflight.pop(rid, None)

    def _flush_workers(self) -> None:
        for w, worker in enumerate(self.workers):
            if worker is None or not worker.outbox:
                continue
            batch, worker.outbox = worker.outbox, []
            if self.channels:
                self.channels[w].send_response(encode_msg(batch))
            else:
                self._handle_response(encode_msg(batch))

    # -------------------------------------------- the engine's op adapter
    def execute(self, op: tuple) -> Any:
        """The fleet's half of the engine contract: one op against the
        per-worker channels (N request sources + the shared response
        source — the engine never interprets the names, this adapter
        does)."""
        kind = op[0]
        if kind == "reap":
            name = op[1].name
            if name == "response":
                return self.channels[0].response_cq.reap()
            return self.channels[int(name.split(":", 1)[1])].request_cq.reap()
        if kind == "dispatch":
            src, rec = op[1].name, op[3]
            if rec.op == "send":
                return True
            if src == "response":
                if rec.ctx == "response":  # two-sided recv consumed a pre-post
                    self.channels[0].repost("response")
                self._handle_response(rec.data)
                return True
            wid = int(src.split(":", 1)[1])
            self.channels[wid].repost("request")
            worker = self.workers[wid]
            if worker is None:
                # raced a completed leave (the drain pump settles the wire,
                # so this only guards against loss becoming a crash)
                return True
            refusal = worker.handle_request(decode_msg(rec.data))
            if refusal is not None:
                self.channels[wid].send_response(encode_msg([refusal]))
            return True
        if kind == "progress":
            moved = False
            for ch in self.channels:
                moved = ch.progress() or moved
            return moved
        if kind == "poll":
            moved = False
            for ch in self.channels:
                moved = ch.poll() or moved
            return moved
        if kind == "drain_retries":
            moved = False
            for ch in self.channels:
                moved = ch.drain_retries() or moved
            return moved
        if kind == "step_trylock":
            return self._step_lock.acquire(blocking=False)
        if kind == "step_unlock":
            self._step_lock.release()
            return True
        if kind == "dev_trylock":
            return True
        return False

    def _comm_step(self) -> bool:
        if self.engine is None:
            return False
        return run_step(self.engine, self, 0)

    # ------------------------------------------------------------------ engine
    def step(self) -> bool:
        """One fleet iteration: pump the channels, route, step every
        worker's decode shard, flush token batches back."""
        self._comm_step()
        self._place_orphans()
        self._route()
        worked = False
        for worker in self.workers:
            if worker is not None:
                worked = worker.step() or worked
        self._flush_workers()
        self._comm_step()
        self.steps += 1
        return worked

    @property
    def tokens_out(self) -> int:
        return sum(w.core.tokens_out for w in self.workers if w is not None)

    def idle(self) -> bool:
        if self._queue or self._chunks or self._orphans:
            return False
        if any(w.busy() for w in self.workers if w is not None):
            return False
        if self._inflight:
            return False
        return not any(ch.pending_work() for ch in self.channels)

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step() and self.idle():
                return

    # --------------------------------------------------------------- teardown
    def close(self) -> None:
        """Release transport resources (idempotent) — the fleet lifecycle
        leak regression cycles this 50×.  The membership liveness sweep
        runs FIRST: workers that died without leave() have their on_gone
        hooks return their slots while the transports are still alive."""
        self.membership.sweep()
        if self.group is not None and hasattr(self.group, "close"):
            self.group.close()
        self.channels = []
        self.engine = None
        self.group = None


def _worker_gone(router_ref: "weakref.ref[Router]", member) -> None:
    """A member's GONE hook (leave OR abandon-sweep): the rank's worker
    slot returns to the pool; the channel and slab stay provisioned for
    reuse.  It holds the router weakly: a live worker's liveness finalizer
    holds the membership and its hooks until the worker dies, so a strong
    hook would keep the router, its workers and their caches (on the card)
    alive for as long as the router keeps a worker."""
    router = router_ref()
    if router is not None:
        router.workers[member.rank] = None


# A fleet IS its router plus the workers it owns — constructing one wires
# the whole tier up.
Fleet = Router
