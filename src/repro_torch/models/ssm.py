"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Port of ``repro/models/ssm.py``.  Prefill runs the chunked SSD algorithm:
a quadratic, attention-like block inside fixed-size chunks, then a linear
recurrence across chunk states (a Python loop over chunks where the
reference has ``lax.scan``).  Decode is the O(1)-state recurrent step.

The intra-chunk block (steps 1 and 2 of :func:`ssd_chunked`) is routed by
the tensors' device: on CUDA it runs the Hopper SSD kernel
(:func:`repro_torch.kernels.ops.ssd_chunk`) through :class:`SSDChunkFn`,
with or without autograd, in the layout and with the casts of the
reference's Pallas branch; on the CPU it takes the reference's plain
einsum branch.  The f32 leaves of a bf16 model (``A_log``, ``D``,
``dt_bias``) stay f32, and every dtype cast sits where the reference has
it.  Where the JAX package donates the decode state, these functions write
into the given state in place and return it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import obs
from ..configs.base import ArchConfig, ssm_groups, zamba2_layout
from ..kernels import ops as kops
from ..sharding.logical import contiguous_grads, is_dtensor, local_einsum, shard
from .layers import Params, dense_init, rms_norm

__all__ = ["ssm_init", "ssm_apply", "init_ssm_cache", "ssm_decode", "ssd_chunked", "SSDChunkFn"]


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    n_groups = ssm_groups(cfg)
    d_state = cfg.ssm_state
    conv_dim = d_in + 2 * n_groups * d_state
    return d_in, n_heads, n_groups, d_state, conv_dim


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    d = cfg.d_model
    d_in, n_heads, n_groups, d_state, conv_dim = _dims(cfg)
    dev = gen.device
    # in_proj emits [z, x, B, C, dt]
    proj_out = 2 * d_in + 2 * n_groups * d_state + n_heads
    return {
        "in_proj": dense_init(gen, (d, proj_out), dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), dtype, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32, device=dev)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((n_heads,), 1e-2, dtype=torch.float32, device=dev))),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_in, d), dtype),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] = sum(a[j+1..i])."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


class SSDChunkFn(torch.autograd.Function):
    """The SSD intra-chunk block through the kernel, under autograd or not.

    Forward: the kernel (``kops.ssd_chunk``, looked up at call time), with
    grad mode off as every ``Function.forward`` runs; it returns (y_diag,
    f32 chunk states).  Backward: not a kernel — the gradient of the
    kernel's plain version (``ssd_chunk_plain``), recomputed from the saved
    a_dt, x, b and c with PyTorch ops.  b and c are per group: autograd
    through the plain version's ``repeat_interleave`` sums their gradients
    over the heads of a group.  The reference has no backward kernel (no
    ``custom_vjp`` in the JAX package), so the port has none either."""

    @staticmethod
    def forward(ctx, a_dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
        ctx.save_for_backward(a_dt, x, b, c)
        return kops.ssd_chunk(a_dt, x, b, c)

    @staticmethod
    def backward(ctx, dy: torch.Tensor, dstates: torch.Tensor):
        with torch.enable_grad():
            ins = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
            outs = kops.ssd_chunk_plain(*ins)
            return torch.autograd.grad(outs, ins, (dy, dstates))


def _chunk_blocks_kernel(xc, ac, b, c, bsz, nc, chunk, g, n):
    """Steps 1 and 2 through the kernel, in the reference's Pallas-branch
    layout: (B,H,nc,Q[,·]) views in, y_diag (B,nc,Q,H,P) and the f32 chunk
    states cast to x's dtype (B,nc,H,P,N) out."""
    yk, sk = SSDChunkFn.apply(
        ac.permute(0, 3, 1, 2),
        xc.permute(0, 3, 1, 2, 4),
        b.reshape(bsz, nc, chunk, g, n).permute(0, 3, 1, 2, 4),
        c.reshape(bsz, nc, chunk, g, n).permute(0, 3, 1, 2, 4),
    )
    return yk.permute(0, 2, 3, 1, 4), sk.permute(0, 2, 1, 3, 4).to(xc.dtype)


def _chunk_blocks_plain(xc, ac, a_cum, b, cc, bsz, nc, chunk, g, n, rep):
    """Steps 1 and 2 as the reference's plain branch, in the model dtype."""
    bc = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    # 1. intra-chunk (the "attention-like" quadratic block)
    L = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp", cc, bc, L.to(cc.dtype), xc)
    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", bc, decay_states.to(bc.dtype), xc)
    return y_diag, states


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) pre-discretized inputs (x * dt)
    a_dt: torch.Tensor,  # (B, S, H)  A * dt (negative)
    b: torch.Tensor,  # (B, S, G, N)
    c: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked algorithm; returns (y (B,S,H,P), final_state).
    DTensors run it on each rank's shards (:func:`_ssd_chunked_local`)."""
    if is_dtensor(x):
        return _ssd_chunked_local(x, a_dt, b, c, chunk, init_state)
    contiguous_grads(x, a_dt, b, c)  # as on local shards: the same gradients' layouts, so the same sums upstream
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    s_orig = s
    if s % chunk:
        # pad to a chunk multiple; padded steps are identity on the state
        # (a_dt = 0 → decay 1, x = B = 0 → no contribution)
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g
    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = a_dt.reshape(bsz, nc, chunk, h).float()
    a_cum = torch.cumsum(ac, dim=2)  # (B,nc,Q,H)
    cc = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    if x.is_cuda:
        y_diag, states = _chunk_blocks_kernel(xc, ac, b, c, bsz, nc, chunk, g, n)
    else:
        y_diag, states = _chunk_blocks_plain(xc, ac, a_cum, b, cc, bsz, nc, chunk, g, n, rep)

    # 3. inter-chunk recurrence (a loop over chunks)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B,nc,H)
    state = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device) if init_state is None else init_state
    prev = []
    for i in range(nc):
        prev.append(state)
        state = chunk_decay[:, i, :, None, None].to(states.dtype) * state + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    # 4. state → output contribution
    state_decay = torch.exp(a_cum)  # (B,nc,Q,H)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", cc, prev_states, state_decay.to(cc.dtype))
    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y, state


def _ssd_chunked_local(x, a_dt, b, c, chunk: int, init_state=None):
    """:func:`ssd_chunked` of DTensors on each rank's shards
    (``local_map``): the kernel on CUDA shards, the plain branch on CPU
    and meta ones, and the inter-chunk recurrence on each shard's own
    heads, so DTensor sees none of the pads, chunk reshapes and per-chunk
    slices.  Batch (dim 0) and heads (dim 2 of x (B,S,H,P) and a_dt
    (B,S,H)) stay as x's placements, any other sharding (the sequence) is
    gathered; b and c (B,S,G,N) follow the batch sharding only — one
    group, so every local head reads it whole, and their gradients are
    partial sums over the head shards.  Out: y placed as x, the final
    state (B,H,P,N) with the heads sharding on its dim 1."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    x_pl = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate() for pl in x.placements)
    if b.shape[2] != 1 and Shard(2) in x_pl:
        raise NotImplementedError(f"sharded SSD heads take one group of B/C, got {b.shape[2]}")
    bc_pl = tuple(pl if pl == Shard(0) else Replicate() for pl in x_pl)
    st_pl = tuple(Shard(1) if pl == Shard(2) else pl for pl in x_pl)
    bc_grad = tuple(Partial() if pl == Shard(2) else bp for pl, bp in zip(x_pl, bc_pl))  # one partial a head shard

    st = () if init_state is None else (init_state,)  # (local_map takes no None input)
    return local_map(lambda xl, al, bl, cl, *sl: ssd_chunked(xl, al, bl, cl, chunk, *sl), out_placements=(x_pl, st_pl),
                     in_placements=(x_pl, x_pl, bc_pl, bc_pl) + (st_pl,) * len(st),
                     in_grad_placements=(x_pl, x_pl, bc_grad, bc_grad) + (st_pl,) * len(st),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, a_dt, b, c, *st)


def _in_proj_split(p: Params, u: torch.Tensor, cfg: ArchConfig):
    d_in, n_heads, n_groups, d_state, conv_dim = _dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", u, p["in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim :]  # (B,S,H)
    return z, xbc, dt


def _conv_apply(p: Params, xbc: torch.Tensor, conv_state: Optional[torch.Tensor], cfg: ArchConfig):
    """Depthwise causal conv1d over (B,S,conv_dim); returns (out, new_state).
    DTensors run it on each rank's shards (:func:`_conv_local`)."""
    if is_dtensor(xbc) and conv_state is None:
        return _conv_local(p, xbc, cfg)
    k = cfg.ssm_conv
    if conv_state is not None:
        xbc_full = torch.cat([conv_state, xbc], dim=1)
    else:
        contiguous_grads(xbc, p["conv_w"], p["conv_b"])  # as on local shards
        xbc_full = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    # sum_k w[k] * x[t - (K-1) + k]
    out = sum(xbc_full[:, i : i + s] * p["conv_w"][i][None, None, :] for i in range(k))
    out = F.silu(out + p["conv_b"])
    new_state = xbc_full[:, -(k - 1) :] if k > 1 else xbc[:, :0]
    return out, new_state


def _conv_local(p: Params, xbc: torch.Tensor, cfg: ArchConfig):
    """:func:`_conv_apply` of a DTensor prompt on each rank's shards
    (``local_map``), the causal pad and the shifted-window sum included.
    The conv is depthwise over ``conv_dim`` and runs along the sequence,
    which no rule shards for a prompt: xbc keeps its batch sharding and
    gathers any other (a sequence shard would need the K−1 inputs before
    it); the weights are read whole, and their gradients are partial sums
    over the batch shards.  Out: the activations and the last K−1 inputs,
    both placed as xbc's batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    x_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in xbc.placements)
    w_pl = (Replicate(),) * len(x_pl)
    w_grad = tuple(Partial() if pl == Shard(0) else Replicate() for pl in x_pl)  # one partial a batch shard

    return local_map(lambda xl, wl, bl: _conv_apply({"conv_w": wl, "conv_b": bl}, xl, None, cfg),
                     out_placements=(x_pl, x_pl), in_placements=(x_pl, w_pl, w_pl),
                     in_grad_placements=(x_pl, w_grad, w_grad), device_mesh=xbc.device_mesh,
                     redistribute_inputs=True)(xbc, p["conv_w"], p["conv_b"])


def _ssd_inputs(p: Params, xbc: torch.Tensor, dt: torch.Tensor, cfg: ArchConfig):
    d_in, n_heads, n_groups, d_state, _ = _dims(cfg)
    x = xbc[..., :d_in]
    b = xbc[..., d_in : d_in + n_groups * d_state]
    c = xbc[..., d_in + n_groups * d_state :]
    bsz, s = x.shape[:2]
    x = x.reshape(bsz, s, n_heads, cfg.ssm_head_dim)
    b = b.reshape(bsz, s, n_groups, d_state)
    c = c.reshape(bsz, s, n_groups, d_state)
    # jax.nn.softplus is logaddexp(x, 0), in f32
    dt = torch.logaddexp(dt.float() + p["dt_bias"], torch.zeros((), device=dt.device))  # (B,S,H)
    a = -torch.exp(p["A_log"])  # (H,)
    return x, b, c, dt, a


def _out_norm(p: Params, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The mixer's gated output norm of y (B,S,d_in): RMS of y·silu(z) over
    the whole width; in the zamba2 layout, transformers'
    ``Zamba2RMSNormGated``: y·silu(z) in f32, RMS over each of
    ``ssm_groups`` groups of d_in / ssm_groups, cast back, times the weight."""
    if not zamba2_layout(cfg):
        return rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    gated = (y.float() * F.silu(z.float())).unflatten(-1, (ssm_groups(cfg), -1))
    gated = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return p["norm_w"] * gated.flatten(-2).to(y.dtype)


def ssm_apply(
    p: Params,
    u: torch.Tensor,
    cfg: ArchConfig,
    state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full-sequence SSD pass.  ``state`` (prefill) is filled in place and
    returned: the final SSM state and the last (K-1) pre-activation inputs."""
    z, xbc, dt = _in_proj_split(p, u, cfg)
    xbc, conv_state = _conv_apply(p, xbc, None, cfg)
    x, b, c, dt, a = _ssd_inputs(p, xbc, dt, cfg)
    x = shard(x, "batch", "seq", "ssm_heads", None)
    xd = x * dt[..., None].to(x.dtype)
    a_dt = a * dt  # (B,S,H)
    with obs.range("mixer.ssd"):
        y, final_state = ssd_chunked(xd, a_dt, b, c, cfg.ssm_chunk)
    y = y + x * p["D"][None, None, :, None].to(x.dtype)
    bsz, s = u.shape[:2]
    y = y.reshape(bsz, s, -1)
    with obs.range("mixer.norm"):
        y = _out_norm(p, y, z, cfg)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    if state is not None:
        state["ssm"].copy_(final_state)
        state["conv"].copy_(conv_state)
    return out, state


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, device: torch.device) -> Params:
    d_in, n_heads, n_groups, d_state, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, n_heads, cfg.ssm_head_dim, d_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def ssm_decode(p: Params, u: torch.Tensor, cfg: ArchConfig, state: Params) -> Tuple[torch.Tensor, Params]:
    """Single-token recurrent step.  u: (B,1,D).  Updates ``state`` in place
    and returns it."""
    d_in, n_heads, n_groups, d_state, conv_dim = _dims(cfg)
    z, xbc, dt = _in_proj_split(p, u, cfg)
    # conv over [state ‖ new token]
    window = torch.cat([state["conv"], xbc], dim=1)  # (B,K,conv_dim)
    out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc_t = F.silu(out)[:, None, :]
    new_conv = window[:, 1:]
    x, b, c, dt, a = _ssd_inputs(p, xbc_t, dt, cfg)
    # recurrence: s = exp(a·dt)·s + dt·B ⊗ x
    decay = torch.exp(a * dt[:, 0])  # (B,H)
    bsz = u.shape[0]
    rep = n_heads // n_groups
    b1 = b[:, 0].repeat_interleave(rep, dim=1)  # (B,H,N)
    c1 = c[:, 0].repeat_interleave(rep, dim=1)
    xd = x[:, 0] * dt[:, 0, :, None].to(x.dtype)  # (B,H,P)
    ssm = state["ssm"]
    with obs.range("mixer.ssd"):
        s_new = decay[..., None, None].to(ssm.dtype) * ssm + torch.einsum("bhp,bhn->bhpn", xd, b1).to(ssm.dtype)
        y = local_einsum("bhpn,bhn->bhp", s_new, c1)  # (B,H,P); on DTensors each rank's batch and heads
    y = y + x[:, 0] * p["D"][None, :, None].to(x.dtype)
    y = y.reshape(bsz, 1, d_in)
    with obs.range("mixer.norm"):
        y = _out_norm(p, y, z, cfg)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    ssm.copy_(s_new)
    state["conv"].copy_(new_conv)
    return out, state
