"""A decode tile replayed from CUDA graphs, cut at the kernel entries.

A decode step of 8 rows launches thousands of small kernels; enqueued one
by one from Python, they keep the card waiting on the host most of the
step.  :class:`DecodeGraph` captures :func:`~.model.decode_step`'s tile for
one set of parameters and one cache on the card, and replays it.

The capture is cut at every call of a kernel entry of
:mod:`repro_torch.kernels.ops` (:data:`ENTRIES`): the work between two
calls is one ``torch.cuda.CUDAGraph``, and each call stays a Python call at
replay, looked up on the module then as the eager step looks it up, with
its output written into the tensor the capture gave it (``out=``).  So the
hand-written kernels launch, count and show in a profiler's ranges as in
an eager step.  A dense or SSM step calls no entry and is one graph; a MoE
layer is cut at its gate, up and down products (:func:`entry_calls`).
A piece in which nothing ran would replay as an empty graph; none of the
served families has one.

The pieces share one memory pool, are captured in order and replay in
order on the current stream.  A tensor that crosses a cut lies in the
pool, which the graphs hold for their life; the entries' outputs, made
between pieces, are held here.  The step reads nothing else but the
runner's token and position buffers, the parameters and the cache, whose
storage must not move: replay checks it.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from .. import obs
from ..kernels import ops as kops
from ..sharding.logical import replicate_plain
from ..tree import leaves
from .layers import Params

__all__ = ["ENTRIES", "DecodeGraph", "entry_calls"]

ENTRIES = ("attention", "ssd_chunk", "expert_ffn_matmul")  # the kernel entries of kernels/ops.py

Call = Tuple[str, tuple, Dict[str, Any], torch.Tensor]  # (entry, args, kwargs, the output it writes)


@contextlib.contextmanager
def _cut_at_entries(on_call: Callable[..., torch.Tensor]) -> Iterator[None]:
    """While the body runs, a call of ``kops.<entry>`` for any of
    :data:`ENTRIES` is ``on_call(entry, the function it replaced, args,
    kwargs)``; the module's functions are put back after."""
    saved = {name: getattr(kops, name) for name in ENTRIES}
    try:
        for name, fn in saved.items():
            setattr(kops, name, lambda *a, _name=name, _fn=fn, **kw: on_call(_name, _fn, a, kw))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


def _tile(params: Params, cfg, tokens: torch.Tensor, positions: torch.Tensor, cache: Params) -> torch.Tensor:
    from .model import _decode_tile  # model imports this module

    with replicate_plain(params):
        return _decode_tile(params, cfg, tokens, positions, cache)


def entry_calls(params: Params, cfg, cache: Params) -> List[str]:
    """The kernel entries one decode tile calls, in order: where a
    :class:`DecodeGraph` cuts its capture.  Runs the tile eagerly on
    ``cache`` (of ``DECODE_TILE`` rows; written at position 0), on any device."""
    from .model import DECODE_TILE

    dev = leaves(cache)[0].device
    names: List[str] = []

    def call(name, fn, args, kwargs):
        names.append(name)
        return fn(*args, **kwargs)

    with torch.inference_mode(), _cut_at_entries(call):
        _tile(params, cfg, torch.zeros((DECODE_TILE, 1), dtype=torch.long, device=dev),
              torch.zeros((DECODE_TILE,), dtype=torch.int32, device=dev), cache)
    return names


class DecodeGraph:
    """:func:`~.model.decode_step` of one full tile on ``params`` and
    ``cache`` (CUDA, plain tensors), captured at construction and replayed
    by calling the instance with the step's tokens (8, 1) and positions (8,).

    Construction runs one eager step on the tile at position 0 (it builds
    what the first call of each op builds, outside the capture), then
    captures: both write ``cache``, which the caller puts back.  Called
    under ``torch.inference_mode`` as the step it replays is.
    ``pieces`` is the number of graphs, ``replays`` the steps replayed;
    each replay adds to :data:`repro_torch.obs.counters` what the captured
    step counted (the shared-block invocations of a hybrid).
    """

    _live: "weakref.WeakValueDictionary[int, DecodeGraph]" = weakref.WeakValueDictionary()

    def __init__(self, params: Params, cfg, cache: Params):
        from .model import DECODE_TILE

        self.params, self.cache = params, cache
        dev = params["embed"].device
        self.tokens = torch.zeros((DECODE_TILE, 1), dtype=torch.long, device=dev)
        self.positions = torch.zeros((DECODE_TILE,), dtype=torch.int32, device=dev)
        self._ptrs = [t.data_ptr() for t in leaves(cache)]
        self._program: List[Union[torch.cuda.CUDAGraph, Call]] = []  # in replay order
        self.replays = 0
        stream = torch.cuda.Stream(dev)  # a capture cannot run on the default stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            _tile(params, cfg, self.tokens, self.positions, cache)
            stream.synchronize()
            before = obs.counters.copy()
            self.logits = self._capture(cfg)
            self._counts = obs.counters - before  # what one step counts, added again at each replay
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.pieces = sum(isinstance(p, torch.cuda.CUDAGraph) for p in self._program)
        DecodeGraph._live[id(cache)] = self

    def _capture(self, cfg) -> torch.Tensor:
        pool = torch.cuda.graph_pool_handle()

        def begin() -> torch.cuda.CUDAGraph:
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            return g

        graph = begin()

        def cut(name, fn, args, kwargs):
            nonlocal graph
            graph.capture_end()
            self._program.append(graph)
            # outside any capture: the kernel runs once on the captured
            # inputs' memory, and makes the output the replays write into
            # (an entry without out= fails here, not in a later step)
            out = fn(*args, out=None, **kwargs)
            self._program.append((name, args, kwargs, out))
            graph = begin()
            return out

        with _cut_at_entries(cut):
            logits = _tile(self.params, cfg, self.tokens, self.positions, self.cache)
        graph.capture_end()
        self._program.append(graph)
        return logits

    @classmethod
    def on(cls, params: Params, cache: Params) -> Optional["DecodeGraph"]:
        """The live runner captured on exactly these ``params`` and ``cache``, if any."""
        g = cls._live.get(id(cache))
        return g if g is not None and g.cache is cache and g.params is params else None

    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """One step: the logits (8, 1, V), in a buffer the next replay
        overwrites; the cache updated in place."""
        if [t.data_ptr() for t in leaves(self.cache)] != self._ptrs:
            raise RuntimeError("DecodeGraph: the cache's storage moved since the capture; "
                               "its graphs would read and write the old memory")
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        for piece in self._program:
            if isinstance(piece, torch.cuda.CUDAGraph):
                piece.replay()
            else:
                name, args, kwargs, out = piece
                getattr(kops, name)(*args, out=out, **kwargs)
        for name, n in self._counts.items():
            obs.count(name, n)
        self.replays += 1
        return self.logits
