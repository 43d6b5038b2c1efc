"""Continuous-batching inference server over the comm hand-off.

Port of ``repro/serve/server.py``: a fixed pool of ``slots`` shares one
stacked decode cache; requests arrive from any thread, prefill fills a
free slot, and every engine step decodes ALL active slots in one batched
``decode_step``.  With ``transport='collective'`` (the default) requests
and per-token responses cross the paper's :class:`CommInterface` verbs on
a :class:`~repro_torch.core.comm.collective.CommChannel` as bytes, and the
engine loop drives the shared :class:`ProgressEngine`; token completions
of all active slots aggregate into ONE response message per engine step.
``transport='shmem'`` swaps in the true one-sided shared-memory transport
(responses ride ``post_put_signal`` whenever the backend's capabilities
advertise a one-sided put); ``transport='inline'`` is the direct
hand-off, the parity reference.  :class:`DecodeCore` is shared verbatim
with the fleet's :class:`~repro_torch.serve.fleet.ModelWorker`, which
shards the slot space across cores and hands a live slot from one core to
another (:meth:`DecodeCore.extract_slot` / :meth:`DecodeCore.adopt_slot`).

The model runs on the device its parameters lie on.  Where the JAX server
donates the cache to ``jit``, this one updates it in place under
:func:`torch.inference_mode`.  A request is tokens only, as in the
reference, whose ``DecodeCore`` builds the prefill batch from the prompt
alone: a VLM is served text-only, and an encoder-decoder, whose prefill
needs its encoder's frames, is refused (drive it through ``prefill`` and
``decode_step``).
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from .. import obs
from ..configs.base import ArchConfig
from ..core.comm.collective import CommChannel
from ..core.comm.progress import ProgressEngine, ProgressPolicy, run_step
from ..core.comm.resources import ResourceLimits
from ..core.comm.wire import decode_msg, encode_msg
from ..models import init_cache, prefill
from ..models import decode_step as model_decode_step
from ..models.decode_graph import DecodeGraph
from ..models.model import DECODE_TILE
from ..sharding.logical import is_dtensor
from ..tree import tree_map

__all__ = ["ServeConfig", "Request", "DecodeCore", "InferenceServer"]


@dataclass
class ServeConfig:
    slots: int = 4  # concurrent sequences (decode batch)
    context: int = 256  # KV slots per sequence
    max_prefill: int = 64  # prompts are cut to their first max_prefill tokens
    # Request/response hand-off: 'collective' rides CommInterface verbs on
    # a CollectiveComm pair driven by the shared ProgressEngine; 'shmem'
    # the one-sided shared-memory transport (responses by put when the
    # backend's Capabilities advertise one_sided_put); 'inline' is the
    # direct hand-off (the parity reference in tests).
    transport: str = "collective"
    # Chunked prefill: 0 = single-shot prefill at admission; N > 0 = the
    # prompt is consumed one token per engine step through decode_step,
    # interleaved with the other slots' decode.
    prefill_chunk: int = 0
    # ProgressPolicy.for_config axes, the same fields as the parcelports'.
    progress_mode: str = "explicit"  # 'explicit' | 'implicit'
    lock_mode: str = "none"
    progress_workers: int = 0
    # The shared resource model (§3.3.4) bounding the hand-off channel.
    limits: ResourceLimits = field(default_factory=ResourceLimits)


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out_tokens: List[int] = field(default_factory=list)
    done_event: threading.Event = field(default_factory=threading.Event)
    # seconds on the tracer's clock (obs.now)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # server side, ns on the tracer's clock: the arrival in the admission
    # queue and the first token computed (the starts of the request.queue
    # and request.hold intervals)
    arrived_ns: Optional[int] = None
    first_token_ns: Optional[int] = None


# emit(req, token, done) — one generated token leaves the model side.
EmitFn = Callable[[Request, int, bool], None]


def decode_step(params: Any, arch: ArchConfig, tokens: torch.Tensor, positions: torch.Tensor, cache: Any):
    """:func:`models.decode_step`, replayed from the CUDA graphs captured on
    these ``params`` and ``cache`` (:class:`DecodeGraph`) where there are
    some: the one call :class:`DecodeCore` makes into the model's decode."""
    graph = DecodeGraph.on(params, cache)
    if graph is None:
        return model_decode_step(params, arch, tokens, positions, cache)
    with obs.span("decode.graph"):
        return graph(tokens, positions), cache


class DecodeCore:
    """Slot scheduler + batched decode, independent of any transport.

    Owns the batched decode cache (``init_cache(arch, slots, context)``:
    ring K/V, or SSM and conv state, or both) and the per-slot positions /
    budgets.  The single-host :class:`InferenceServer` runs ONE core of
    ``cfg.slots`` slots; the fleet runs N cores of ``slots // n_workers``
    each.  A row of ``decode_step`` is bit-identical whatever the batch
    (``models.model.DECODE_TILE``), so sharding the slot space across
    cores cannot change any request's token stream.  Two admission modes:

    * **single-shot** (``prefill_chunk == 0``): the whole prompt runs
      through ``prefill`` on a one-slot scratch cache whose rows are then
      copied into the slot in place — first token emitted at admission.
    * **chunked** (``prefill_chunk > 0``): the slot starts empty and
      consumes ONE prompt token per engine step through the same batched
      ``decode_step`` that serves the decoding slots (teacher forcing), so
      a long prompt never stalls the other slots' decode.  Chunks may lag
      the consumer: a starved slot re-feeds its last token WITHOUT
      advancing its position, and its cache row (K/V, SSM and conv state)
      is put back as it was before the step, so stall timing cannot
      perturb the stream.

    On a card, a core of one full decode tile (``slots == DECODE_TILE``,
    plain tensors) captures its decode step as CUDA graphs at construction
    (:class:`~repro_torch.models.decode_graph.DecodeGraph`) and replays
    them every step: the same kernels, bit for bit, enqueued in a few
    calls.  Every other core (the CPU, a partial tile, DTensors) runs
    ``models.decode_step`` eagerly.  ``graph_pieces`` counts the graphs
    (0 without), ``graph_steps`` the steps replayed.
    """

    def __init__(
        self,
        arch: ArchConfig,
        params: Any,
        slots: int,
        context: int,
        max_prefill: int = 64,
        prefill_chunk: int = 0,
    ):
        if arch.is_encdec:
            raise ValueError(
                f"{arch.name} is an encoder-decoder: its prefill needs the encoder's frames, and a request "
                "carries tokens only (the reference's DecodeCore builds the prefill batch from the prompt "
                "tokens alone); drive it through models.prefill and models.decode_step"
            )
        self.arch, self.params = arch, params
        self.device = params["embed"].device
        self.slots, self.context = slots, context
        self.max_prefill, self.prefill_chunk = max_prefill, prefill_chunk
        self._slots: List[Optional[Request]] = [None] * slots
        self._positions = np.zeros((slots,), np.int32)
        self._remaining = np.zeros((slots,), np.int32)
        self._last_tok = np.zeros((slots,), np.int32)
        self.cache = init_cache(arch, slots, context, self.device)
        self._graph: Optional[DecodeGraph] = None
        if self.device.type == "cuda" and slots == DECODE_TILE and not is_dtensor(params["embed"]):
            with torch.inference_mode():
                self._graph = DecodeGraph(params, arch, self.cache)
            self._reset_row(slice(None))  # the warm-up and the capture wrote the cache
        self.steps = 0
        self.tokens_out = 0
        self.prefill_calls = 0  # single-shot prefill dispatches (0 when chunked)
        # host wall seconds in the model calls, the sums of their spans
        # (prefill; decode.dispatch + decode.sync); each ends in the argmax
        # read back to the host, so device time is included
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        # worst prompt-tokens-of-prefill-work attributed to a single engine
        # step — the burst chunked prefill exists to bound (<= active slots
        # per step vs a whole prompt per admission single-shot)
        self.max_prefill_burst = 0
        self._pending_burst = 0  # single-shot prefill work since the last step
        # chunked-prefill state: slot -> prompt tokens still to consume, and
        # whether more chunks are on their way
        self._prefill_queue: Dict[int, deque] = {}
        self._prefill_open: Dict[int, bool] = {}
        self._rid_slot: Dict[int, int] = {}
        self._one_slot: Optional[Dict[str, Any]] = None  # abstract_slot_state's tree

    @property
    def graph_pieces(self) -> int:
        return 0 if self._graph is None else self._graph.pieces

    @property
    def graph_steps(self) -> int:
        return 0 if self._graph is None else self._graph.replays

    # ------------------------------------------------------------- occupancy
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def active(self) -> bool:
        return any(r is not None for r in self._slots)

    # ----------------------------------------------------------- cache rows
    def _splice(self, one: Dict[str, Any], slot: int) -> None:
        """Copy a one-slot cache into row ``slot`` of the stacked cache, in
        place: every leaf has its layer (or invocation) dim first and the
        batch at axis 1 (K/V rings, SSM and conv state)."""
        for (_, full), (_, piece) in zip(_named_leaves(self.cache), _named_leaves(one)):
            full[:, slot] = piece[:, 0]

    def _reset_row(self, slot: Union[int, slice]) -> None:
        """Start a recycled row (or rows) afresh: zero K/V, SSM and conv
        state, and every position tag empty (-1), so nothing of the row's
        last request leaks into the next."""
        for name, full in _named_leaves(self.cache):
            full[:, slot] = -1 if name == "pos" else 0

    # ------------------------------------------------------------- admission
    @torch.inference_mode()
    def admit(self, req: Request, emit: EmitFn, more_chunks: bool = False) -> int:
        """Place ``req`` into the lowest free slot; returns the slot index.
        With chunked prefill, ``req.prompt`` may hold only the FIRST chunk:
        ``more_chunks=True`` keeps the slot prefilling until
        :meth:`feed_chunk` delivers the rest (the first chunk is then not
        cut to ``max_prefill``: the sender cut the whole prompt)."""
        slot = self.free_slots()[0]
        if self.prefill_chunk > 0:
            prompt = req.prompt if more_chunks else req.prompt[: self.max_prefill]
            self._reset_row(slot)
            self._slots[slot] = req
            self._positions[slot] = 0
            self._remaining[slot] = req.max_new
            self._prefill_queue[slot] = deque(prompt)
            self._prefill_open[slot] = more_chunks
            self._rid_slot[req.rid] = slot
            if req.arrived_ns is not None:
                obs.interval("request.queue", req.rid, req.arrived_ns, obs.now_ns())
            return slot
        prompt = req.prompt[: self.max_prefill]
        # single-sequence prefill on a scratch cache, then copy into the slot
        one = init_cache(self.arch, 1, self.context, self.device)
        with obs.span("prefill", req.rid) as sp:
            toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
            logits, one = prefill(self.params, self.arch, {"tokens": toks}, one)
            self._splice(one, slot)
            tok = int(torch.argmax(logits[0, -1]))
        if req.arrived_ns is not None:
            obs.interval("request.queue", req.rid, req.arrived_ns, sp.start_ns)
        req.first_token_ns = sp.end_ns
        self.prefill_seconds += (sp.end_ns - sp.start_ns) * 1e-9
        self.prefill_calls += 1
        self._pending_burst += len(prompt)
        done = req.max_new <= 1
        self._slots[slot] = None if done else req
        self._positions[slot] = len(prompt)
        self._remaining[slot] = req.max_new - 1
        self._last_tok[slot] = tok
        if not done:
            self._rid_slot[req.rid] = slot
        self.tokens_out += 1
        emit(req, tok, done)
        return slot

    def feed_chunk(self, rid: int, tokens: List[int], last: bool) -> None:
        """Append a follow-up prompt chunk for an admitted request."""
        slot = self._rid_slot[rid]
        assert self._prefill_open.get(slot), f"slot {slot} is not expecting chunks"
        self._prefill_queue[slot].extend(tokens)
        if last:
            self._prefill_open[slot] = False

    def prefilling(self, rid: int) -> bool:
        slot = self._rid_slot.get(rid)
        return slot is not None and slot in self._prefill_queue

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self, emit: EmitFn) -> bool:
        """One batched decode over all active slots.  Decoding slots
        advance one generated token; prefilling slots consume one prompt
        token (emitting their first token when the prompt is exhausted);
        starved prefilling slots hold their position and cache row.
        Returns False when no slot is active (no decode dispatched)."""
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return False
        fed, starved = set(), []
        for i in active:
            q = self._prefill_queue.get(i)
            if q is None:
                continue  # plain decoding slot
            if q:
                self._last_tok[i] = q.popleft()  # teacher forcing
                fed.add(i)
            else:  # starved mid-prefill: re-feed the last token, hold position
                starved.append(i)
        held = [(i, self._row(i)) for i in starved]
        with obs.span("decode.dispatch") as sp:
            t0 = sp.start_ns
            toks = torch.from_numpy(self._last_tok[:, None].astype(np.int64)).to(self.device)
            pos = torch.from_numpy(self._positions.copy()).to(self.device)
            logits, self.cache = decode_step(self.params, self.arch, toks, pos, self.cache)
            nxt = torch.argmax(logits[:, 0, :], dim=-1)
            sp.then("decode.sync")
            nxt = nxt.cpu().numpy().astype(np.int32)
        self.decode_seconds += (sp.end_ns - t0) * 1e-9
        for i, row in held:
            self._splice(row, i)
        for i in active:
            req = self._slots[i]
            if i in self._prefill_queue:
                if i not in fed:
                    continue  # starved: nothing advanced
                self._positions[i] += 1
                if self._prefill_queue[i] or self._prefill_open[i]:
                    continue  # more prompt to consume: no emission yet
                # the LAST prompt token was just fed: its logits give the
                # first generated token
                del self._prefill_queue[i]
                del self._prefill_open[i]
                req.first_token_ns = sp.end_ns
            else:
                self._positions[i] += 1
            self._remaining[i] -= 1
            self._last_tok[i] = nxt[i]
            done = self._remaining[i] <= 0
            self.tokens_out += 1
            emit(req, int(nxt[i]), done)
            if done:
                self._slots[i] = None
                self._rid_slot.pop(req.rid, None)
        self.steps += 1
        self.max_prefill_burst = max(self.max_prefill_burst, self._pending_burst + len(fed))
        self._pending_burst = 0
        return True

    # ---------------------------------------------------------- slot hand-off
    def _row(self, slot: int) -> Dict[str, Any]:
        """A copy of row ``slot`` of the stacked cache as a one-slot cache."""
        return tree_map(lambda full: full[:, slot : slot + 1].clone(), self.cache)

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is not None]

    @torch.inference_mode()
    def extract_slot(self, slot: int) -> tuple:
        """Snapshot one ACTIVE slot for hand-off to another core and free
        it.  Returns ``(state, meta)``: ``state`` is the slot's cache row as
        a one-slot cache (K/V ring, SSM and conv state, MLA latents alike),
        ``meta`` the scalar scheduler state.  The cache writes are
        position-addressed and rows of a batched decode are independent, so
        splicing these exact bits into ANY core's free slot continues the
        token stream bit-identically."""
        req = self._slots[slot]
        assert req is not None, f"slot {slot} is empty"
        state = self._row(slot)
        meta = {
            "rid": req.rid,
            "prompt": list(req.prompt),
            "max_new": req.max_new,
            "position": int(self._positions[slot]),
            "remaining": int(self._remaining[slot]),
            "last_tok": int(self._last_tok[slot]),
            "prefill_queue": list(self._prefill_queue[slot]) if slot in self._prefill_queue else None,
            "prefill_open": bool(self._prefill_open.get(slot, False)),
        }
        self._slots[slot] = None
        self._rid_slot.pop(req.rid, None)
        self._prefill_queue.pop(slot, None)
        self._prefill_open.pop(slot, None)
        return state, meta

    @torch.inference_mode()
    def adopt_slot(self, state: Any, meta: Dict[str, Any], req: Optional[Request] = None) -> int:
        """Splice a handed-off slot (from :meth:`extract_slot`, possibly
        round-tripped through ``checkpoint.snapshot``) into the lowest free
        slot and resume its schedule exactly where it stopped.  Pass
        ``req`` when the caller tracks its own request object (the fleet
        worker does); emissions will carry it."""
        slot = self.free_slots()[0]
        self._splice(state, slot)
        if req is None:
            req = Request(rid=meta["rid"], prompt=list(meta["prompt"]), max_new=meta["max_new"])
        self._slots[slot] = req
        self._positions[slot] = meta["position"]
        self._remaining[slot] = meta["remaining"]
        self._last_tok[slot] = meta["last_tok"]
        self._rid_slot[req.rid] = slot
        if meta.get("prefill_queue") is not None:
            self._prefill_queue[slot] = deque(meta["prefill_queue"])
            self._prefill_open[slot] = meta["prefill_open"]
        return slot

    def abstract_slot_state(self) -> Dict[str, Any]:
        """Shape, dtype and device reference for validating an incoming
        hand-off snapshot (``unpack_state(..., abstract=...)``): a one-slot
        cache, allocated once."""
        if self._one_slot is None:
            self._one_slot = init_cache(self.arch, 1, self.context, self.device)
        return self._one_slot


def _named_leaves(tree: Dict[str, Any], name: str = ""):
    """(key, tensor) of every leaf of a nested cache dict, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    else:
        yield name, tree


class InferenceServer:
    def __init__(self, arch: ArchConfig, params: Any, cfg: Optional[ServeConfig] = None):
        self.cfg = cfg = ServeConfig() if cfg is None else cfg
        self.arch = arch
        self.params = params
        self._rid = itertools.count()
        # Server-side admission queue: requests that have ARRIVED (through
        # the channel, or directly in inline mode) and await a free slot.
        self._pending: deque = deque()
        self.core = DecodeCore(
            arch, params, cfg.slots, cfg.context, cfg.max_prefill, cfg.prefill_chunk
        )
        # The comm hand-off (collective transport): channel + the SAME
        # progress engine as the parcelports, policy from this config.
        self._channel: Optional[CommChannel] = None
        self.engine: Optional[ProgressEngine] = None
        self._inflight: Dict[int, Request] = {}  # rid -> client-side Request
        self._inflight_lock = threading.Lock()
        self._outbox: List[tuple] = []  # (rid, tok, done) batch of one step
        # rid -> first token computed (ns), of the requests whose first token
        # is in the outbox: request.hold ends when the batch is flushed
        self._holds: Dict[int, int] = {}
        self._flushed_ns = 0
        if cfg.transport in ("collective", "shmem"):
            self._channel = CommChannel(limits=cfg.limits, backend=cfg.transport)
            # step_lock=True: the whole engine step runs behind a try-lock
            # (implemented in `execute`), so a second driver can never
            # interleave dispatches with the serve loop's own step.
            self.engine = ProgressEngine(
                ProgressPolicy.for_config(cfg).variant(step_lock=True),
                self._channel.router(),
                ndevices=1,
            )
            self._step_lock = threading.Lock()
        elif cfg.transport != "inline":
            raise ValueError(f"unknown transport {cfg.transport!r}")

    @property
    def cache(self):
        return self.core.cache

    @property
    def steps(self) -> int:
        return self.core.steps

    @property
    def tokens_out(self) -> int:
        return self.core.tokens_out

    # ----------------------------------------------------------------- client
    def submit(self, prompt: List[int], max_new: int = 16) -> Request:
        if not prompt or max_new < 1:
            raise ValueError(f"a request needs a prompt and max_new >= 1 (got {len(prompt)} tokens, max_new={max_new})")
        req = Request(rid=next(self._rid), prompt=list(prompt), max_new=max_new)
        t = obs.now_ns()
        req.submitted_at = t * 1e-9
        if self._channel is None:
            req.arrived_ns = t
            self._pending.append(req)  # direct hand-off
        else:
            with self._inflight_lock:
                self._inflight[req.rid] = req
            # the request crosses the comm layer as bytes; EAGAIN parks it
            # in the channel throttle, retried by the engine step
            self._channel.send_request(encode_msg((req.rid, req.prompt, req.max_new)))
        return req

    # -------------------------------------------- the engine's op adapter
    def execute(self, op: tuple) -> Any:
        """Execute one :class:`ProgressEngine` op against the hand-off
        channel — the serving stack's half of the engine contract."""
        kind = op[0]
        ch = self._channel
        if kind == "reap":
            return ch.reap(op[1].name)
        if kind == "dispatch":
            rec = op[3]
            if rec.op == "send":
                return True  # send completion: slot already recycled
            ch.repost(rec.ctx)  # keep the pre-post depth
            if rec.ctx == "request":
                rid, prompt, max_new = decode_msg(rec.data)
                self._pending.append(Request(rid=rid, prompt=prompt, max_new=max_new, arrived_ns=obs.now_ns()))
            else:  # response: a token batch for the client side
                self._apply_response(rec.data)
            return True
        if kind == "progress":
            return ch.progress()
        if kind == "poll":
            return ch.poll()
        if kind == "drain_retries":
            return ch.drain_retries()
        if kind == "step_trylock":
            return self._step_lock.acquire(blocking=False)
        if kind == "step_unlock":
            self._step_lock.release()
            return True
        if kind == "dev_trylock":
            return True
        return False

    def _comm_step(self) -> bool:
        """One canonical engine step over the hand-off channel (drain
        retries → progress → reap → dispatch)."""
        if self.engine is None:
            return False
        with obs.span("handoff"):
            return run_step(self.engine, self, 0)

    def _apply_response(self, payload: bytes) -> None:
        """Client side: apply an arrived token batch to its requests.  A
        finished request leaves ``_inflight`` only AFTER its final token is
        appended and ``done_event`` is set."""
        now = obs.now()
        for rid, tok, done in decode_msg(payload):
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
                with self._inflight_lock:
                    self._inflight.pop(rid, None)

    def _emit(self, req: Request, tok: int, done: bool) -> None:
        """One generated token leaves the server: directly into the
        client's Request (inline), or into this step's outbound batch."""
        if self._channel is None:
            t = obs.now_ns()
            now = t * 1e-9
            if req.first_token_at is None:
                req.first_token_at = now
                obs.interval("request.hold", req.rid, req.first_token_ns, t)
            req.out_tokens.append(tok)
            if done:
                req.finished_at = now
                req.done_event.set()
        else:
            self._outbox.append((req.rid, tok, done))
            if req.first_token_ns > self._flushed_ns:  # computed since the last flush: the first token
                self._holds[req.rid] = req.first_token_ns

    def _flush_outbox(self) -> bool:
        if self._channel is None or not self._outbox:
            return False
        with obs.span("flush") as sp:
            batch, self._outbox = self._outbox, []
            self._channel.send_response(encode_msg(batch))
        for rid, t in self._holds.items():
            obs.interval("request.hold", rid, t, sp.start_ns)
        self._holds.clear()
        self._flushed_ns = sp.start_ns
        return True

    # ----------------------------------------------------------------- engine
    def _admit(self) -> None:
        with obs.span("admit"):
            for _ in self.core.free_slots():
                if not self._pending:
                    return
                self.core.admit(self._pending.popleft(), self._emit)

    def step(self) -> bool:
        """One engine iteration: pump the comm hand-off, admit, batched-
        decode all active slots, flush the token batch back."""
        with obs.span("engine.step"):
            self._comm_step()
            self._admit()
            if not self.core.step(self._emit):
                if self._flush_outbox():  # e.g. prefill-only finishes
                    self._comm_step()
                return False
            self._flush_outbox()
            self._comm_step()
            return True

    # ------------------------------------------------------------- lifecycle
    def pending_requests(self) -> int:
        """Requests admitted server-side but not yet slotted."""
        return len(self._pending)

    def idle(self) -> bool:
        """Nothing slotted, nothing pending, nothing in flight on the
        hand-off channel."""
        if self.core.active() or self._pending:
            return False
        if self._channel is not None and (self._inflight or self._channel.pending_work()):
            return False
        return True

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step() and self.idle():
                return
