"""GPipe-style pipeline parallelism over a mesh axis (point-to-point
hand-offs over ``torch.distributed``).

Port of ``repro/sharding/pipeline.py``: stage ``s`` on the rank at
position ``s`` along ``axis`` holds its slice of the stacked stage
params; microbatches stream through the classic GPipe schedule (stage s
computes microbatch m at step ``t = s + m``), and activations hop
stage→stage by ``isend``/``irecv`` inside the axis's process group — the
counterpart of the reference's ``lax.ppermute``, and of the LCI one-sided
put on the device fabric.  The last stage's outputs are broadcast along
the axis, so every stage returns them (the reference's ``psum`` of a
value only the last stage holds).

Where the reference computes every stage at every step and masks the
inactive ones to zero, a stage here computes only its active steps: the
outputs are the same.

Bubble fraction = (n_stages − 1) / (n_stages + n_micro − 1); choose
``n_micro ≫ n_stages`` as usual.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..tree import tree_map

__all__ = ["gpipe"]


def _stage_slice(t: torch.Tensor, s: int) -> torch.Tensor:
    """Stage ``s``'s slice of a stacked leaf: a DTensor sharded along the
    stage axis holds exactly it; a plain tensor holds every stage's."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        local = t.to_local()
        return local[0] if local.shape[0] == 1 else t.full_tensor()[s]
    return t[s]


def gpipe(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    micro_x: torch.Tensor,  # (M, ...) microbatches, identical in/out shape
    mesh: Any,
    axis: str = "pod",
) -> torch.Tensor:
    """Apply ``n_stages`` stages sequentially to each of M microbatches.

    ``stacked_params``: a tree with leading dim = n_stages (plain, or
    DTensors sharded over ``axis``); ``stage_fn(params_slice, x) -> x``
    must preserve shape.  ``micro_x`` is the same on every rank.  Returns
    the (M, ...) outputs on every rank of the axis."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    s = mesh.get_local_rank(axis)
    m_count = micro_x.shape[0]
    p_here = tree_map(lambda t: _stage_slice(t, s), stacked_params)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n - 1 else None
    outs = torch.empty_like(micro_x)
    sends = []
    for t in range(n + m_count - 1):
        m = t - s
        if not 0 <= m < m_count:
            continue
        if prev is not None:  # the previous stage computed microbatch m at step t - 1
            inp = torch.empty_like(micro_x[0])
            dist.irecv(inp, src=prev, group=group).wait()
        else:
            inp = micro_x[m]
        out = stage_fn(p_here, inp).contiguous()
        if nxt is not None:
            sends.append((dist.isend(out, dst=nxt, group=group), out))  # out stays alive until sent
        else:
            outs[m] = out
    for req, _ in sends:
        req.wait()
    # replicate the result across stages (only stage n-1 holds it)
    dist.broadcast(outs, src=dist.get_global_rank(group, n - 1), group=group)
    return outs
