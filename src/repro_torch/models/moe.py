"""Mixture-of-Experts FFN: shared + routed experts, capacity dispatch.

Port of ``repro/models/moe.py``.  Token-choice top-k routing with a
per-expert capacity per batch row, and two dispatch implementations:

* ``scatter`` (default) — tokens go into per-expert queues and are
  gathered back; memory O(S·D + E·C·D).
* ``einsum`` — the classic GShard dense dispatch/combine masks (B,S,E,C);
  O(S·E·C) memory, the small-shape oracle in tests.

The three expert products run through
:func:`repro_torch.kernels.ops.expert_ffn_matmul`, where the reference
lowers them through einsum: on a CUDA tensor the grouped-matmul kernel,
by :class:`GroupedMatmulFn` with or without autograd.
The queues are laid out (E, B, C, D), so the kernel sees one (E, B·C, D)
batch and reads each expert's weights once per call, however many rows
the batch has.  Routing and capacity stay per batch row, so the rows of a
batched decode are independent of one another.

The reference scatters and gathers at positions ``pos >= C`` for dropped
slots, which JAX drops (scatter) and clamps (gather).  Here a dropped slot
writes to one spare row behind the queues that nothing reads, and its
gathered row is zeroed, so every kept (expert, row, position) has exactly
one writer: plain assignment, no atomics, deterministic.  Under autograd
the spare row's gradient is 0 (it is cut off before the experts), so a
dropped slot's token gets none, as the reference's dropped scatter gives.
The router's gradient flows through the gates and, into the aux loss,
through the probabilities.

A slot's position in its expert's queue (the number of earlier slots on
that expert) comes from a stable sort of the slot-major expert ids, where
the reference counts them with a prefix sum over a one-hot (B, k·S, E);
the integers are the same.

On DTensors the routing runs as DTensor ops, and the positions, the
dispatch and the combine run on each rank's batch rows (``local_map``):
each rank fills its own (E, B_local, C, D) queues, which are then
redistributed to the expert sharding, and gathers its rows back from
them.  The einsum oracle runs unsharded only.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import obs
from ..configs.base import ArchConfig
from ..kernels import ops as kops
from ..sharding.logical import contiguous_grads, is_dtensor, shard
from .layers import Params, dense_init, ffn_apply, ffn_init

__all__ = ["moe_init", "moe_apply", "expert_capacity", "DISPATCH_MODES", "GroupedMatmulFn"]

DISPATCH_MODES = ("scatter", "einsum")


def expert_capacity(tokens: int, cfg: ArchConfig) -> int:
    """Per-expert token capacity for a routing group of ``tokens`` tokens."""
    cap = int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(cap, 4)


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """The reference's tree: an f32 router (D, E), expert weights (E, D, F)
    and (E, F, D) scaled by 1/sqrt(E) (``dense_init``'s fan-in is the first
    dim, as in the reference), and the shared experts as one FFN of width
    F · n_shared."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    p: Params = {
        "router": dense_init(gen, (d, e), torch.float32),
        "w_up": dense_init(gen, (e, d, f), dtype),
        "w_down": dense_init(gen, (e, f, d), dtype),
    }
    if cfg.gated_ffn:
        p["w_gate"] = dense_init(gen, (e, d, f), dtype)
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(gen, d, f * cfg.n_shared_experts, dtype, gated=cfg.gated_ffn)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool one-hot of ``idx`` (all False outside [0, n))."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _router_probs(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,E) f32 router probabilities."""
    logits = shard(torch.einsum("bsd,de->bse", x.float(), p["router"]), "batch", "seq", None)  # routing is per-token
    return torch.softmax(logits, dim=-1)


def _route(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """Top-k routing: per-slot expert ids, in-expert positions, keep mask
    and gates — all (B, k·S) slot-major — plus the capacity and the
    load-balancing aux loss."""
    probs = _router_probs(p, x)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (B,S,k), descending
    return _assign(probs, gate_vals, gate_idx, cfg)


def _assign(probs: torch.Tensor, gate_vals: torch.Tensor, gate_idx: torch.Tensor, cfg: ArchConfig):
    """:func:`_route`'s outputs from the probabilities and the chosen
    experts' ids (B,S,k) and probabilities."""
    b, s, e = probs.shape
    k = gate_idx.shape[-1]
    cap = expert_capacity(s, cfg)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # slot-major flattening: slot 0 of every token, then slot 1, …
    e_idx = shard(gate_idx.transpose(1, 2).reshape(b, k * s), "batch", None)  # (B,kS)
    gates = shard(gate_vals.transpose(1, 2).reshape(b, k * s), "batch", None)
    pos = _positions_local(e_idx, e) if is_dtensor(e_idx) else _positions(e_idx, e)
    keep = pos < cap
    # aux loss (Switch/GShard): E · Σ_e frac_tokens_e · mean_prob_e
    frac_tokens = _one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * mean_probs)
    return e_idx, pos, keep, gates, cap, aux


def _positions(e_idx: torch.Tensor, e: int) -> torch.Tensor:
    """(B,kS) int64 number of earlier slots on each slot's expert, from a
    stable sort of the ids: a slot's rank in sorted order less the first
    rank of its expert there.  The sort keeps slot order within an
    expert, so this is the one-hot prefix count of the reference, integer
    for integer; it sorts a narrow copy of the ids (fewer radix passes on
    the card) and reads nothing back to the host."""
    ids, order = torch.sort(e_idx.to(torch.uint8 if e <= 256 else torch.int32), dim=1, stable=True)
    rank = torch.arange(ids.shape[1], device=ids.device) - torch.searchsorted(ids, ids)
    return torch.empty_like(rank).scatter_(1, order, rank)


def _positions_local(e_idx: torch.Tensor, e: int) -> torch.Tensor:
    """:func:`_positions` of a DTensor on each rank's batch rows
    (``local_map``): a row's positions depend on its own slots only, and
    DTensor takes no ``searchsorted`` of a tensor and a DTensor."""
    from torch.distributed.tensor.experimental import local_map

    pl = _batch_placements(e_idx, 0)
    return local_map(lambda el: _positions(el, e), out_placements=list(pl), in_placements=(pl,),
                     device_mesh=e_idx.device_mesh, redistribute_inputs=True)(e_idx)


def _queue_rows(e_idx: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor, cap: int, e: int) -> torch.Tensor:
    """(B,kS) row of each slot in the flattened (E, B, C) queues; every
    dropped slot gets the spare row E·B·C behind them."""
    b = e_idx.shape[0]
    row_of_batch = torch.arange(b, device=e_idx.device)[:, None]
    rows = (e_idx * b + row_of_batch) * cap + pos
    return torch.where(keep, rows, torch.full_like(rows, e * b * cap))


def _dispatch_scatter(x: torch.Tensor, rows: torch.Tensor, cap: int, e: int) -> torch.Tensor:
    """(B,S,D) tokens → (E,B,C,D) expert queues, one writer per kept row."""
    contiguous_grads(x)  # as on local shards: the same gradient layouts, so the same sums upstream
    b, s, d = x.shape
    x_rep = shard(x.repeat(1, rows.shape[1] // s, 1), "batch", "moe_tokens", "embed")  # slot-major: (B, kS, D)
    flat = x.new_zeros((e * b * cap + 1, d))  # + the spare row of dropped slots
    flat[rows.reshape(-1)] = x_rep.reshape(-1, d)
    return flat[:-1].view(e, b, cap, d)


def _combine_gather(expert_out: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor, s: int) -> torch.Tensor:
    """(E,B,C,D) expert outputs → (B,S,D) via gather + gated sum over k."""
    contiguous_grads(expert_out, gates)
    e, b, cap, d = expert_out.shape
    hit = expert_out.reshape(e * b * cap, d)[torch.where(keep, rows, 0)]  # (B,kS,D)
    hit = shard(hit, "batch", "moe_tokens", "embed")
    hit = torch.where(keep[..., None], hit, 0) * gates[..., None].to(hit.dtype)
    return hit.reshape(b, -1, s, d).sum(dim=1)


def _batch_placements(t: torch.Tensor, dim: int) -> Tuple:
    """Per mesh dim: ``Shard(dim)`` where ``t`` (a DTensor whose dim 0 is
    the batch) holds its batch sharded, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if pl == Shard(0) else Replicate() for pl in t.placements)


def _dispatch_local(x: torch.Tensor, e_idx: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor, cap: int,
                    e: int) -> torch.Tensor:
    """:func:`_dispatch_scatter` of DTensors on each rank's shards
    (``local_map``): a rank scatters the slots of its batch rows into its
    local (E, B_local, C, D) queues, with the rows :func:`_queue_rows`
    gives its shard (the unsharded rows on a mesh whose batch is whole).
    Every other dim replicated; the queues come back sharded over their
    batch dim (1) as x is over its dim 0.  DTensor has no working rule for
    the indexed write (``index_put_``) on every release."""
    from torch.distributed.tensor.experimental import local_map

    x_pl, q_pl = _batch_placements(x, 0), _batch_placements(x, 1)

    def body(xl, el, pl, kl):
        return _dispatch_scatter(xl, _queue_rows(el, pl, kl, cap, e), cap, e)

    return local_map(body, out_placements=list(q_pl), in_placements=(x_pl,) * 4, in_grad_placements=(x_pl,) * 4,
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, e_idx, pos, keep)


def _combine_local(expert_out: torch.Tensor, e_idx: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
                   gates: torch.Tensor, s: int) -> torch.Tensor:
    """:func:`_combine_gather` of DTensors on each rank's shards: the
    queues gathered over the experts and kept sharded over the batch as
    the slots are (the dispatch's layout), each rank gathers its rows'
    slots back; the output (B,S,D) sharded as the slots' batch."""
    from torch.distributed.tensor.experimental import local_map

    cap, e = expert_out.shape[2], expert_out.shape[0]
    s_pl, q_pl = _batch_placements(e_idx, 0), _batch_placements(e_idx, 1)

    def body(ql, el, pl, kl, gl):
        return _combine_gather(ql, _queue_rows(el, pl, kl, cap, e), kl, gl, s)

    return local_map(body, out_placements=list(s_pl), in_placements=(q_pl,) + (s_pl,) * 4,
                     in_grad_placements=(q_pl,) + (s_pl,) * 4, device_mesh=e_idx.device_mesh,
                     redistribute_inputs=True)(expert_out, e_idx, pos, keep, gates)


class GroupedMatmulFn(torch.autograd.Function):
    """An expert product through the grouped-matmul kernel, under autograd
    or not.

    Forward: the kernel (``kops.expert_ffn_matmul``, looked up at call
    time), with grad mode off as every ``Function.forward`` runs.
    Backward: not a kernel — the gradient of the kernel's plain version
    (``grouped_matmul_plain``: dX = dY·Wᵀ and dW = Xᵀ·dY in f32, cast back),
    recomputed from the saved x and w with PyTorch ops.  The reference has
    no backward kernel, so the port has none either."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return kops.expert_ffn_matmul(x, w)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        with torch.enable_grad():
            ins = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
            return torch.autograd.grad(kops.grouped_matmul_plain(*ins), ins, dout)


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, R, D) × w (E, D, F): :class:`GroupedMatmulFn` on CUDA tensors,
    the plain version on the CPU; DTensors on each rank's experts and rows
    (``local_map``), the same route per shard."""
    if is_dtensor(x):
        return _expert_matmul_local(x, w)
    contiguous_grads(x, w)  # as on local shards
    return GroupedMatmulFn.apply(x, w) if x.is_cuda else kops.expert_ffn_matmul(x, w)


def _expert_matmul_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`_expert_matmul` of DTensors on local shards: x keeps its
    expert (dim 0) and row (dim 1) sharding, w follows x's expert sharding
    and is gathered elsewhere; the output is placed as x.  w's gradient is
    a partial sum over x's row shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    x_pl = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 1) else Replicate() for pl in x.placements)
    w_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in x_pl)
    w_grad = tuple(Partial() if pl == Shard(1) else wp for pl, wp in zip(x_pl, w_pl))  # one partial a row shard
    return local_map(_expert_matmul, out_placements=list(x_pl), in_placements=(x_pl, w_pl), in_grad_placements=(x_pl, w_grad),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, w)


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, dispatch_mode: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux_loss f32 scalar)."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"moe_apply: dispatch_mode {dispatch_mode!r} not in {DISPATCH_MODES}")
    b, s, d = x.shape
    e = cfg.n_experts
    with obs.range("moe.route"):
        e_idx, pos, keep, gates, cap, aux = _route(p, x, cfg)
    sharded = is_dtensor(x)
    if sharded and dispatch_mode != "scatter":
        raise NotImplementedError(f"moe_apply: dispatch_mode {dispatch_mode!r} runs unsharded only; "
                                  "DTensors take 'scatter'")
    with obs.range("moe.dispatch"):
        if sharded:
            expert_in = _dispatch_local(x, e_idx, pos, keep, cap, e)
        elif dispatch_mode == "scatter":
            rows = _queue_rows(e_idx, pos, keep, cap, e)
            expert_in = _dispatch_scatter(x, rows, cap, e)
        else:  # einsum oracle (small shapes only)
            slot_oh = _one_hot(pos, cap).to(x.dtype) * keep[..., None].to(x.dtype)
            disp = _one_hot(e_idx, e).to(x.dtype)[..., None] * slot_oh[:, :, None, :]  # (B,kS,E,C)
            x_rep = x.repeat(1, e_idx.shape[1] // s, 1)
            expert_in = torch.einsum("bkec,bkd->ebcd", disp, x_rep).contiguous()
        expert_in = shard(expert_in, "experts", "batch", "expert_cap", "embed")
    with obs.range("moe.experts"):
        q = expert_in.view(e, b * cap, d)  # one (E, B·C, D) batch for the kernel
        if cfg.gated_ffn:
            h = F.silu(_expert_matmul(q, p["w_gate"])) * _expert_matmul(q, p["w_up"])
        else:
            h = F.gelu(_expert_matmul(q, p["w_up"]), approximate="tanh")
        expert_out = shard(_expert_matmul(h, p["w_down"]).view(e, b, cap, d), "experts", "batch", "expert_cap", "embed")
    with obs.range("moe.combine"):
        if sharded:
            out = _combine_local(expert_out, e_idx, pos, keep, gates, s)
        elif dispatch_mode == "scatter":
            out = _combine_gather(expert_out, rows, keep, gates, s)
        else:
            comb = disp * gates[:, :, None, None].to(x.dtype)
            out = torch.einsum("bkec,ebcd->bkd", comb, expert_out)
            out = out.reshape(b, -1, s, d).sum(dim=1)
    if "shared" in p:
        with obs.range("moe.shared"):
            out = out + ffn_apply(p["shared"], x, gated=cfg.gated_ffn)
    return out, aux.float()
