"""Mesh construction.

Port of ``repro/launch/mesh.py``.  Functions (not module constants), so
importing never touches the process group.  Single pod: 16×16 = 256
devices, axes (data, model).  Multi-pod: 2×16×16 = 512 devices, axes
(pod, data, model) — the pod axis is pure data parallelism in the
baseline layout.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group, which must already exist: NCCL on a card, gloo on
the CPU, or the ``fake`` group of the dry-run
(:mod:`repro_torch.launch.dryrun`), whose world stands in for the
production one.  A production mesh over a world of another size raises
and names the world it needs, as ``jax.make_mesh`` fails with too few
devices.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from ..sharding.logical import DEFAULT_TABLE, ShardingRules, mesh_shape

__all__ = ["make_production_mesh", "make_rules", "make_test_mesh", "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def _device_type() -> str:
    """``cuda`` over NCCL and over the dry-run's fake group (which stands
    in for a cluster of cards: its redistributions then take the cards'
    collectives, all-to-all included), ``cpu`` over gloo."""
    import torch.distributed as dist

    backend = str(dist.get_backend()).lower()
    return "cuda" if ("nccl" in backend or backend == "fake") else "cpu"


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Any:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh {axes} needs a default process group of world {n}; none is initialized")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {shape} mesh {axes} needs a process group of world {n}, this one has world {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> Any:
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return _make_mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2), axes: Tuple[str, ...] = ("data", "model")) -> Any:
    return _make_mesh(tuple(shape), tuple(axes))


def make_rules(mesh: Any, *, long_context: bool = False, overrides: Optional[dict] = None) -> ShardingRules:
    """Bind the logical table to a mesh.  Axes missing from the mesh are
    dropped; ``long_context`` turns on KV-cache sequence sharding (context
    parallelism for the ``long_500k`` decode cells)."""
    table = dict(DEFAULT_TABLE)
    if long_context:
        table["seq_kv"] = "data"
    if overrides:
        table.update(overrides)
    present = set(mesh_shape(mesh))

    def fix(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            kept = tuple(a for a in v if a in present)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return v if v in present else None

    return ShardingRules({k: fix(v) for k, v in table.items()}, mesh)
