"""Logical-axis sharding: model code names axes, rules map them to the mesh.

Port of ``repro/sharding/logical.py``.  Model code annotates activations
with *logical* axis names (``shard(x, "batch", "seq", "embed")``).  A
:class:`ShardingRules` table maps logical names to mesh axes (or None =
replicated).  Outside a rules context, with rules that have no mesh, and
on a plain (non-DTensor) tensor the annotations are no-ops, so the same
model code runs everywhere and a plain run changes no bit.

The default rules implement the framework's parallelism layout:

* ``batch``  → (pod, data)   — data parallelism across pods and hosts
* ``heads/kv_heads/mlp/vocab/experts`` → model — tensor/expert parallelism
* ``seq_kv`` → data for long-context decode (context parallelism), else None

A spec is a :class:`PartitionSpec`, a tuple of per-dim entries (a mesh
axis name, a tuple of names, or None), equal to ``tuple()`` of the JAX
package's.  A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
or any object whose ``.shape`` maps axis names to sizes.  Where the
reference constrains a value with ``with_sharding_constraint``,
:func:`shard` redistributes a DTensor to the sanitized spec's placements
(:func:`placements`).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

__all__ = [
    "PartitionSpec",
    "ShardingRules",
    "NamedSharding",
    "DEFAULT_TABLE",
    "DEFAULT_RULES",
    "use_rules",
    "current_rules",
    "shard",
    "logical_spec",
    "named_sharding",
    "sanitize_spec",
    "axis_size",
    "mesh_shape",
    "placements",
    "is_dtensor",
    "replicate_plain",
    "contiguous_grads",
    "local_einsum",
]


class PartitionSpec(tuple):
    """Per-dim mesh-axis entries; ``PartitionSpec("model", None)`` equals
    ``("model", None)``.  A list entry becomes a tuple."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class ShardingRules:
    """Mapping: logical axis name → mesh axis (str/tuple) or None."""

    def __init__(self, table: Dict[str, Optional[object]], mesh: Any = None):
        self.table = dict(table)
        self.mesh = mesh

    def spec(self, *names: Optional[str]) -> PartitionSpec:
        out = []
        used = set()
        for n in names:
            axis = self.table.get(n) if n is not None else None
            # one mesh axis may shard only one tensor dim
            if axis is not None:
                key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
                if any(k in used for k in key):
                    axis = None
                else:
                    used.update(key)
            out.append(axis)
        return P(*out)

    def with_overrides(self, **kw) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return ShardingRules(t, self.mesh)


DEFAULT_TABLE: Dict[str, Optional[object]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_act": None,  # sequence parallelism inside attention (set to
    # "model" when head counts don't divide the TP axis)
    "seq_kv": None,  # long-context decode flips this to "data"
    "embed": None,
    "embed_model": "model",  # ffn/attn input dim when 2D-sharding params
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    # co-sharding dispatch slots with experts ("moe_tokens": "model")
    # doubled collective volume in the reference's measurements; kept as an
    # override hook, default off
    "moe_tokens": None,
    "head_dim": None,
    "state": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
    "frames": None,
    "latent": None,
    "window": None,
    "conv": None,
    "stage": None,  # pipeline stages (optional PP mode)
}

DEFAULT_RULES = ShardingRules(DEFAULT_TABLE)

_ctx = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules) -> Iterator[ShardingRules]:
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def logical_spec(*names: Optional[str]) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return P(*([None] * len(names)))
    return rules.spec(*names)


def mesh_shape(mesh: Any) -> Mapping[str, int]:
    """Axis name → size of a ``DeviceMesh`` or of a mesh-like object whose
    ``.shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def axis_size(mesh: Any, entry: Any) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= shape.get(a, 1)
        return n
    return shape.get(entry, 1)


def sanitize_spec(spec: Tuple, shape, mesh: Any) -> PartitionSpec:
    """Drop spec entries whose mesh-axis size does not divide the dim;
    non-divisible dims replicate (e.g. 28 query heads or 4 KV heads on a
    16-way model axis)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        out.append(e if (e is None or (dim % axis_size(mesh, e) == 0 and dim > 0)) else None)
    return P(*out)


def placements(spec: Tuple, mesh: Any) -> Tuple[Any, ...]:
    """DTensor placements of a (sanitized) spec on a ``DeviceMesh``: each
    mesh dim named by the entry of tensor dim ``d`` — alone or inside a
    tuple entry such as ``("pod", "data")`` — gets ``Shard(d)``, every
    other mesh dim ``Replicate()``.  A dim sharded over several mesh dims
    is split in mesh-dim order.  A mesh dim of size 1 replicates: its one
    shard is the whole dim, and DTensor refuses to reshape a dim it holds
    sharded (a 1×1 mesh then runs every op as the unsharded program)."""
    from torch.distributed.tensor import Replicate, Shard

    owner: Dict[str, int] = {}
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                owner[a] = d
    return tuple(Shard(owner[n]) if n in owner and size > 1 else Replicate()
                 for n, size in zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it; ``mesh, placements = sharding`` unpacks
    the DTensor placement.  Not a tuple, so a tree of them has one leaf
    per sharding."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)

    def __iter__(self):
        yield self.mesh
        yield self.placements


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate_plain(*trees: Any) -> contextlib.AbstractContextManager:
    """Where a call runs on DTensors, the plain tensors it makes inside
    (``arange`` positions, masks, one-hots, zero states, a decode tile's
    padding) count as replicated on the mesh (what ``implicit_replication``
    turns on); a null context when no leaf of ``trees`` is a DTensor.
    Nested uses keep the outer setting on exit (``implicit_replication``
    itself turns it off), so a remat'd forward rerun inside the backward
    still sees it."""
    from ..tree import leaves

    if any(is_dtensor(t) for tree in trees for t in leaves(tree)):
        return _implicit_replication()
    return contextlib.nullcontext()


@contextlib.contextmanager
def _implicit_replication() -> Iterator[None]:
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def contiguous_grads(*tensors: torch.Tensor) -> None:
    """Make the gradients that reach ``tensors`` (a ``local_map`` body's
    local inputs) contiguous: DTensor rebuilds its global strides from the
    local gradient's, and a permuted local gradient then breaks the
    ``view`` of an einsum's backward upstream."""
    for t in tensors:
        if t.requires_grad:
            t.register_hook(lambda g: g.contiguous())


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Place ``x`` by the mesh sharding of the given logical axes.  A no-op
    outside a rules context, for rules without a mesh and for a plain
    tensor; a DTensor is redistributed (differentiably)."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    spec = sanitize_spec(rules.spec(*names), x.shape, rules.mesh)
    want = placements(spec, rules.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def named_sharding(mesh: Any, *names: Optional[str], rules: Optional[ShardingRules] = None) -> NamedSharding:
    r = rules or current_rules() or DEFAULT_RULES
    return NamedSharding(mesh, r.spec(*names))


def local_einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *operands)``; on DTensors, on each rank's shards
    (``local_map``).  On each mesh dim the first operand sharded there
    names the letter it shards, and every operand holding that letter is
    sharded by it; the others are read whole, and their gradients are
    partial sums over its shards.  A letter the output keeps shards the
    output; a summed one leaves each rank a partial sum, and the output is
    ``Partial`` there.  Mesh dims no operand shards replicate.  (DTensor's
    own einsum folds letters into one dim of a matrix product, a ``view``
    that merges a sharded dim behind another, which some releases
    refuse.)"""
    if not any(is_dtensor(t) for t in operands):
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, out = eq.replace(" ", "").split("->")
    specs = ins.split(",")
    mesh = next(t.device_mesh for t in operands if is_dtensor(t))
    letters = []
    for m in range(mesh.ndim):
        pls = [(spec, t.placements[m]) for spec, t in zip(specs, operands) if is_dtensor(t)]
        letters.append(next((spec[pl.dim] for spec, pl in pls if isinstance(pl, Shard)), None))

    def placed(spec: str) -> Tuple[Any, ...]:
        return tuple(Shard(spec.index(c)) if c is not None and c in spec else Replicate() for c in letters)

    out_pl = [Partial() if c is not None and c not in out else pl for c, pl in zip(letters, placed(out))]
    in_pl = tuple(placed(spec) for spec in specs)
    grad_pl = tuple(tuple(Partial() if c is not None and c not in spec else pl for c, pl in zip(letters, placed(spec)))
                    for spec in specs)
    return local_map(lambda *ts: torch.einsum(eq, *ts), out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh, redistribute_inputs=True)(*operands)
