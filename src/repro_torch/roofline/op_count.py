"""Per-device op counts of an eager call: the port's counterpart of
``repro/roofline/hlo_parse.py``.

The JAX package parses the compiled, partitioned HLO of a step.  The port
has no HLO: :func:`count_ops` watches every op the call dispatches
(a ``TorchDispatchMode``) and keeps the same fields as
``HLOAnalysis``, so the dry-run and the roofline read the same keys:

* ``dot_flops`` — 2·M·N·K of every matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``; an einsum reaches one of them), and
  ``flat_dot_flops`` for the products with no batch of matrices (``mm``,
  ``addmm``, and a ``bmm`` of one: an einsum with no batch dims, as a
  projection's); ``dot_bytes`` — their operand plus output bytes;
* ``hbm_bytes`` — Σ 2 × output bytes of every op that makes a tensor
  (written once, read about once): views, allocations without a write and
  scalar reads are left out;
* ``collective_bytes`` — by kind, under the reference's names, each
  collective sized by its result on this rank; ``n_collectives``;
* ``while_trip_counts`` — always empty: eager runs every layer, so
  nothing is counted once for many trips;
* ``peak_bytes`` — the peak of the bytes of live op outputs, a stand-in
  for XLA's temp allocation.

**All counts are per device.**  On DTensors the mode sees each op twice
over: the DTensor op (the *global* op, which a FLOP counter around it
would count — 2.4e13 FLOPs for a (256, 4096, 2048) @ (2048, 5632) product
on a 16×16 mesh, not one device's share) and the local ops DTensor runs
on this rank's shards.  Only the local ops are counted; so are the
functional collectives (``_c10d_functional.all_gather_into_tensor``,
``all_reduce``, ``reduce_scatter_tensor``, ``all_to_all_single``, and
DTensor's own ``_dtensor.shard_dim_alltoall``) that a redistribution
issues, and the point-to-point ops of a pipeline hand-off.
DTensor's sharding propagation runs each new op once more on fake
tensors; those runs are skipped.

Eager PyTorch fuses nothing, so ``hbm_bytes`` runs larger than XLA's
count for the same step (every elementwise op writes and reads its
output); it is what this port moves, not a defect to hide.  A kernel
called through ``ctypes`` (the flash, SSD and grouped-matmul kernels on a
card) is invisible to a dispatch mode: on meta tensors their plain
versions run instead, which compute the same function.
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCount", "count_ops"]

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    # the non-functional c10d ops (a process group called directly)
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}
# ops that make no new tensor in memory or move no bytes
_NO_MATERIALIZE = {"_unsafe_view", "detach", "alias", "lift_fresh", "empty", "empty_strided", "new_empty",
                   "new_empty_strided", "empty_like", "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
                   "set_", "resize_"}


@dataclass
class OpCount:
    collective_bytes: Dict[str, int] = field(default_factory=dict)
    dot_flops: float = 0.0
    dot_bytes: float = 0.0  # operand+output bytes of matrix products
    hbm_bytes: float = 0.0  # Σ output bytes of materializing ops ×2 (write+read)
    while_trip_counts: Dict[str, int] = field(default_factory=dict)
    n_collectives: int = 0
    flat_dot_flops: float = 0.0  # products of no batch, or a batch of one
    peak_bytes: int = 0
    live_bytes: int = 0
    n_ops: int = 0  # local ops dispatched
    last_dtensor_op: str = ""  # the DTensor op dispatched last: the one that failed, if the call raised

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_bytes.values())


def _bytes(t: Any) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _dot_flops(name: str, args: tuple, out: torch.Tensor) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    return 2.0 * out.numel() * a.shape[-1]


class _Counter(TorchDispatchMode):
    def __init__(self, rec: OpCount):
        super().__init__()
        self.rec = rec
        self._lock = threading.Lock()

    def _free(self, n: int) -> None:
        with self._lock:
            self.rec.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.rec.last_dtensor_op = str(func)
            return NotImplemented  # DTensor runs the local ops, which come back here
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if any(isinstance(t, FakeTensor) for t in outs) or any(isinstance(t, FakeTensor) for t in _tensors(args)):
            return out  # DTensor's sharding propagation on fake tensors
        name = func._schema.name.split("::")[-1]
        rec = self.rec
        rec.n_ops += 1
        if name in _DOTS:
            f = _dot_flops(name, args, outs[0])
            rec.dot_flops += f
            if outs[0].dim() == 2 or outs[0].shape[0] == 1:
                rec.flat_dot_flops += f
            rec.dot_bytes += sum(_bytes(t) for t in _tensors(args)) + _bytes(outs[0])
        kind = _COLLECTIVES.get(name)
        if kind is not None and func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            b = sum(_bytes(t) for t in (outs or list(_tensors(args))))
            rec.collective_bytes[kind] = rec.collective_bytes.get(kind, 0) + b
            rec.n_collectives += 1
        if name in _NO_MATERIALIZE or func.is_view:
            return out
        aliased = {id(t) for t in _tensors(args)}
        for t in outs:
            n = _bytes(t)
            rec.hbm_bytes += 2.0 * n
            if id(t) in aliased:
                continue  # written in place
            with self._lock:
                rec.live_bytes += n
                rec.peak_bytes = max(rec.peak_bytes, rec.live_bytes)
            weakref.finalize(t, self._free, n)
        return out


@contextmanager
def count_ops() -> Iterator[OpCount]:
    """Count the ops run inside the block, on this rank; the yielded
    :class:`OpCount` fills in as they run."""
    rec = OpCount()
    with _Counter(rec):
        yield rec
