"""PartitionSpec derivation for parameter / optimizer / cache trees.

Port of ``repro/sharding/params.py``.  Leaf specs are matched by leaf
*name* on the trailing dimensions (stacked per-layer params have a
leading layer dim that is never sharded), then resolved through the
active :class:`~repro_torch.sharding.logical.ShardingRules`, so the same
table drives single-pod, multi-pod and test meshes.  The port's trees are
nested dicts with the JAX package's keys, so the paths match name for
name.

SSM projection matrices stay replicated in the baseline layout (their
fused [z‖x‖B‖C‖dt] output dim does not shard cleanly).  Optimizer moments
optionally ZeRO-shard over the data axis: the first free dimension
divisible by the data-axis size gets "data" appended to its spec.

:func:`tree_shardings` turns a spec tree into
:class:`~repro_torch.sharding.logical.NamedSharding` leaves (sanitized
against the leaves' shapes when given them), and :func:`distribute_tree`
places a tree of plain tensors as DTensors on those placements.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .logical import NamedSharding, PartitionSpec, ShardingRules, mesh_shape, sanitize_spec

__all__ = ["param_specs", "opt_specs", "batch_specs", "cache_specs", "tree_shardings", "distribute_tree", "map_with_path"]

P = PartitionSpec

# leaf name → logical axes of the *trailing* dims
_LEAF_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "lm_head": ("vocab", "embed"),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "router": ("embed", "experts"),
    # MLA
    "wq_a": ("embed", "latent"),
    "wq_b": ("latent", "heads", "head_dim"),
    "wkv_a": ("embed", "latent"),
    "wk_b": ("latent", "heads", "head_dim"),
    "wv_b": ("latent", "heads", "head_dim"),
    # SSM (baseline: replicated projections — see module docstring)
    "in_proj": ("embed", None),
    "conv_w": (None, None),
    "conv_b": (None,),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm_w": (None,),
    "out_proj": (None, "embed"),
    # norms
    "ln1": ("embed",),
    "ln2": ("embed",),
    "ln": ("embed",),
    "ln_f": ("embed",),
    "enc_ln_f": ("embed",),
}

# MoE expert stacks: (E, D, F)/(E, F, D) keyed by path containing "moe"
_MOE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("experts", "embed", "mlp"),
    "w_up": ("experts", "embed", "mlp"),
    "w_down": ("experts", "mlp", "embed"),
}


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf, *others)`` over a tree of nested dicts (the port's
    trees); a :class:`PartitionSpec` is a leaf, never a subtree.  ``rest``
    are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,)) for k, v in tree.items()}
    return fn(path, tree, *rest)


def _ndim(leaf: Any) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)


def _leaf_spec(path: Tuple[str, ...], leaf: Any, rules: ShardingRules) -> PartitionSpec:
    leaf_name = path[-1]
    in_moe = "moe" in path and "shared" not in path
    table = _MOE_RULES if (in_moe and leaf_name in _MOE_RULES) else _LEAF_RULES
    logical = table.get(leaf_name)
    if logical is None:
        return P()  # unknown leaf: replicate
    pad = _ndim(leaf) - len(logical)
    full = (None,) * pad + tuple(logical)
    return rules.spec(*full)


def param_specs(params: Any, rules: ShardingRules) -> Any:
    return map_with_path(lambda p, l: _leaf_spec(p, l, rules), params)


def _zero_extend(spec: Tuple, shape, data_axes: Tuple[str, ...], mesh: Any) -> PartitionSpec:
    """ZeRO-1: shard the first free, divisible dim of an optimizer moment
    over the data axes."""
    sizes = mesh_shape(mesh)
    dsize = 1
    for a in data_axes:
        if a in sizes:
            dsize *= sizes[a]
    if dsize <= 1:
        return P(*spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if e is None:
            continue
        for a in e if isinstance(e, tuple) else (e,):
            used.add(a)
    if any(a in used for a in data_axes):
        return P(*spec)
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsize == 0 and dim > 0:
            entries[i] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
            return P(*entries)
    return P(*spec)


def opt_specs(opt_state: Any, params: Any, rules: ShardingRules, zero: bool = True, mesh: Any = None) -> Any:
    """Moment specs = param specs, optionally ZeRO-extended over data."""
    pspecs = param_specs(params, rules)
    data_axes = rules.table.get("batch") or ()
    if isinstance(data_axes, str):
        data_axes = (data_axes,)

    def mom_specs(moments: Any) -> Any:
        if not (zero and mesh is not None and data_axes):
            return pspecs
        return map_with_path(lambda _, s, l: _zero_extend(s, l.shape, tuple(data_axes), mesh), pspecs, moments)

    return {"mu": mom_specs(opt_state["mu"]), "nu": mom_specs(opt_state["nu"]), "count": P()}


def batch_specs(batch: Any, rules: ShardingRules) -> Any:
    def leaf(path: Tuple[str, ...], x: Any) -> PartitionSpec:
        n = path[-1]
        nd = len(x.shape)
        if n == "positions":
            return rules.spec("batch")
        if n in ("prefix", "frames"):
            return rules.spec("batch", "seq", "embed")
        if nd == 2:
            return rules.spec("batch", "seq")
        if nd == 1:
            return rules.spec("batch")
        return rules.spec(*(["batch"] + [None] * (nd - 1)))

    return map_with_path(leaf, batch)


def cache_specs(cache: Any, rules: ShardingRules) -> Any:
    """Decode-cache specs: (L, B, S, KV, hd) KV rings, (L, B, H, P, N) SSM
    states, (L, B, K, C) conv states, (L, B, S) position tags."""

    def leaf(path: Tuple[str, ...], x: Any) -> PartitionSpec:
        nd = len(x.shape)
        last = path[-1]
        # a batch dim of 1 (single-request long-context decode) must not
        # claim the data axes in spec dedup — it cannot shard, and letting
        # it win would starve seq_kv of those axes (the 500k cache would
        # silently replicate)
        batch = "batch" if (nd >= 2 and x.shape[1] > 1) else None
        if last in ("k", "v"):
            return rules.spec(None, batch, "seq_kv", "kv_heads", "head_dim")
        if last == "pos":
            return rules.spec(None, batch, "seq_kv")
        if last == "c_kv":
            return rules.spec(None, batch, "seq_kv", "latent")
        if last == "k_rope":
            return rules.spec(None, batch, "seq_kv", None)
        if last == "ssm":
            return rules.spec(None, batch, "ssm_heads", None, None)
        if last == "conv":
            return rules.spec(None, batch, None, None)
        return rules.spec(*([None] * nd))

    return map_with_path(leaf, cache)


def tree_shardings(mesh: Any, spec_tree: Any, shape_tree: Any = None) -> Any:
    """Specs → :class:`NamedSharding` leaves (``mesh, placements =
    leaf``); with ``shape_tree`` each spec is first sanitized against the
    leaf's shape (a placement must divide its dim evenly)."""
    if shape_tree is None:
        return map_with_path(lambda _, s: NamedSharding(mesh, P(*s)), spec_tree)
    return map_with_path(lambda _, s, l: NamedSharding(mesh, sanitize_spec(s, l.shape, mesh)), spec_tree, shape_tree)


def _place(t: Any, sh: NamedSharding) -> Any:
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(t, torch.Tensor):
        return t
    mesh, pl = sh
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    if t.device.type == "meta":  # no data to scatter: each rank's shard as meta
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        local_shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(t.new_empty(local_shape), mesh, pl, run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl)


def distribute_tree(tree: Any, mesh: Any, spec_tree: Any) -> Any:
    """``tree``'s tensors as DTensors on ``mesh``, placed by ``spec_tree``
    (each spec sanitized against its leaf's shape).  A plain tensor is
    scattered from its value on every rank (``distribute_tensor``); a meta
    tensor becomes a meta DTensor of its local shape; a DTensor is
    redistributed."""
    shardings = tree_shardings(mesh, spec_tree, tree)
    return map_with_path(lambda _, t, sh: _place(t, sh), tree, shardings)
