"""Async checkpointing with atomic commit and self-validating restore.

Port of ``repro/checkpoint/manager.py``, on the same on-disk format, so a
checkpoint the JAX package wrote restores here and one written here
restores there:

* **Format**: one ``.npy`` per leaf, named by its tree path
  (``key.replace("/", "__") + ".npy"``), and ``manifest.json`` with each
  leaf's file, dtype and shape.  Keys join dict keys and sequence indices
  with ``/`` in :func:`repro_torch.tree.leaves` order (the reference's
  ``jax.tree_util.tree_flatten_with_path`` order); dtypes carry numpy's
  names (``"float32"``, ``"bfloat16"``, ``"int32"``).  bf16 goes to disk
  as its ``uint16`` bits, with the logical dtype in the manifest, so the
  round trip is bit-identical with no ``ml_dtypes``.
* **Async**: every leaf is written by an :class:`AMTExecutor` task, then a
  finalize task commits; ``wait()`` (or the next ``save``) joins them.
  The device-to-host copy happens in ``save`` itself, before the tasks are
  submitted, so the caller may update the state in place as soon as
  ``save`` returns (the port's train step does).
* **Atomic**: leaves land in ``step_<n>.tmp/``; the manifest is written
  last and the directory is renamed to ``step_<n>``, so a crash mid-save
  never corrupts the latest checkpoint.  Only the newest ``keep`` steps
  are kept.
* **Self-validating, in place**: ``restore(like)`` checks every leaf's
  shape and dtype against ``like`` before it copies anything, fails
  loudly on a mismatch, then copies each leaf into ``like``'s tensor on
  that tensor's device, so a full-width restart holds one train state, not
  two (the reference rebuilds from a ``jax.eval_shape`` abstract state,
  which has no torch counterpart that allocates nothing).

* **Sharded**: a DTensor leaf is saved as its ``full_tensor()`` (every
  rank takes part in the gather; rank 0 alone writes), in the same
  format.  ``restore(like, shardings=tree)`` is the reference's elastic
  re-placement: each leaf comes back as a DTensor on its sharding's
  ``(mesh, placements)`` (a :class:`~repro_torch.sharding.NamedSharding`
  tree, as ``sharding.params.tree_shardings`` makes), whatever mesh wrote
  it; ``like`` then only names the leaves, shapes and dtypes (meta tensors
  will do).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.executor import AMTExecutor, TaskFuture

__all__ = ["CheckpointManager"]

_BF16 = "bfloat16"
# torch dtypes under numpy's names (the reference writes str(jax dtype))
_TORCH_NAMES: Dict[torch.dtype, str] = {
    getattr(torch, n): n
    for n in ("float32", "float64", "float16", "bfloat16", "int8", "int16", "int32", "int64", "uint8", "bool")
}


def _flatten(tree: Any) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in :func:`repro_torch.tree.leaves` order: dict
    keys sorted, sequence indices as numbers, ``None`` an empty subtree."""
    out: List[Tuple[str, Any]] = []

    def walk(t: Any, path: Tuple[str, ...]) -> None:
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), t))

    walk(tree, ())
    return out


def _dtype_name(dtype: Any) -> str:
    """numpy's name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_NAMES:
            raise TypeError(f"no checkpoint dtype for {dtype}")
        return _TORCH_NAMES[dtype]
    return np.dtype(dtype).name


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as (a host array that owns its bytes, the logical dtype's
    name); bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        name = _dtype_name(leaf.dtype)
        t = leaf.detach().to("cpu", copy=True)  # a copy on the CPU too: the caller may update the leaf in place
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name == _BF16:  # an ml_dtypes array
        arr = arr.view(np.uint16)
    return arr, name


def _from_host(arr: np.ndarray, dtype: str, where: str) -> torch.Tensor:
    """The CPU tensor of logical dtype ``dtype`` stored in ``arr``."""
    want = "uint16" if dtype == _BF16 else dtype
    if arr.dtype.name != want:
        raise ValueError(f"{where}: stored as {arr.dtype.name}, want {want} for dtype {dtype}")
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _full(leaf: Any) -> Any:
    """A DTensor leaf's whole value (a collective: every rank calls it)."""
    from ..sharding.logical import is_dtensor

    return leaf.full_tensor() if is_dtensor(leaf) else leaf


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _writer() -> bool:
    """Rank 0 writes; the other ranks of a group only take part in the
    gathers."""
    return _rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, executor: Optional[AMTExecutor] = None, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.executor = executor
        self.keep = keep
        self._pending: List[TaskFuture] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ save
    def save(self, state: Any, step: int, wait: bool = False) -> None:
        self.wait()  # only one save in flight
        gathered = [(key, _to_host(_full(leaf))) for key, leaf in _flatten(state)]
        if not _writer():
            return
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {"step": step, "leaves": {}}
        host_leaves = []
        for key, (arr, dt) in gathered:
            fname = key.replace("/", "__") + ".npy"
            manifest["leaves"][key] = {"file": fname, "dtype": dt, "shape": list(arr.shape)}
            host_leaves.append((tmp / fname, arr))

        def write_shard(path: Path, arr: np.ndarray) -> None:
            np.save(path, arr)

        def commit() -> None:
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if final.exists():  # re-save of the same step: replace
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.executor is None:
            for p, a in host_leaves:
                write_shard(p, a)
            commit()
            return
        futs = [self.executor.submit(write_shard, p, a) for p, a in host_leaves]

        def finalize() -> None:
            for f in futs:
                f.result(timeout=120.0)
            commit()

        with self._lock:
            self._pending = [self.executor.submit(finalize)]
        if wait:
            self.wait()

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result(timeout=300.0)

    def _gc(self) -> None:
        steps = sorted(self.available_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def available_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, shardings: Optional[Any] = None) -> Tuple[Any, int]:
        """Copy checkpoint ``step`` (default: the latest) into ``like``'s
        tensors in place and return ``(like, step)``.  Every leaf's shape
        and dtype is checked against the manifest before anything is
        copied.  With ``shardings`` (a tree of ``(mesh, placements)``
        leaves matching ``like``) each leaf is instead rebuilt as a DTensor
        on its placement and a new tree is returned."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        plan = []
        for key, ref in _flatten(like):
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint {d} missing leaf {key!r}")
            if not isinstance(ref, torch.Tensor):
                raise TypeError(f"leaf {key}: restore copies into tensors, got {type(ref).__name__}")
            if tuple(ent["shape"]) != tuple(ref.shape):
                raise ValueError(f"leaf {key}: ckpt shape {tuple(ent['shape'])} != target {tuple(ref.shape)}")
            if _dtype_name(ref.dtype) != ent["dtype"]:
                raise ValueError(f"leaf {key}: ckpt dtype {ent['dtype']} != target {_dtype_name(ref.dtype)}")
            plan.append((key, ref, ent))
        if shardings is not None:
            return self._restore_placed(like, d, plan, shardings), int(manifest["step"])
        with torch.no_grad():
            for key, ref, ent in plan:
                arr = np.load(d / ent["file"])
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {key}: file shape {arr.shape} != manifest {tuple(ent['shape'])}")
                ref.copy_(_from_host(arr, ent["dtype"], f"leaf {key}"))
        return like, int(manifest["step"])

    def _restore_placed(self, like: Any, d: Path, plan: List[Any], shardings: Any) -> Any:
        """Each planned leaf as a DTensor on its sharding; every rank reads
        the file and keeps its own shard (no collective)."""
        from torch.distributed.tensor import distribute_tensor

        from ..tree import unflatten

        sh = dict(_flatten(shardings))
        out = []
        for key, ref, ent in plan:
            if key not in sh:
                raise KeyError(f"shardings has no leaf {key!r}")
            mesh, placements = sh[key]
            t = _from_host(np.load(d / ent["file"]), ent["dtype"], f"leaf {key}").to(mesh.device_type)
            out.append(distribute_tensor(t, mesh, placements, src_data_rank=None))
        return unflatten(like, out)
