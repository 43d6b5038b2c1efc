"""Trees of tensors: nested dicts, lists and tuples.

The port's stand-in for ``jax.tree``: :func:`leaves` walks a tree in
``jax.tree.leaves``'s order (dict keys sorted, lists and tuples in order,
``None`` an empty subtree), so a leaf list of the port lines up with the
reference's; :func:`unflatten` rebuilds a tree of the same structure and
:func:`tree_map` maps over one or more trees of one structure.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence

__all__ = ["leaves", "unflatten", "tree_map"]


def _iter(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter(v)
    else:
        yield tree


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return list(_iter(tree))


def unflatten(like: Any, new_leaves: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are ``new_leaves``, in
    :func:`leaves` order."""
    it = iter(new_leaves)

    def build(t: Any) -> Any:
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: the trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
