"""GQA attention (full / sliding-window / chunked-local / bidirectional).

Port of the GQA half of ``repro/models/attention.py``; MLA waits for a
later slice (ROADMAP.md, queue A).  Three entry points:

* :func:`attention_train` — full-sequence attention of the train forward.
  On a CUDA tensor it runs the Hopper flash-attention kernel inside an
  ``autograd.Function`` (:class:`FlashAttentionFn`): the forward is the
  kernel, the backward the gradient of the reference's q-chunked lowering,
  recomputed from the saved q, k and v with PyTorch ops (the reference has
  no backward kernel, so none is ported).  On the CPU autograd runs
  through that lowering directly.
* :func:`attention_prefill` — prompt attention + ring-cache population.
  On a CUDA tensor every prefill runs the Hopper flash-attention kernel
  (:mod:`repro_torch.kernels`), whatever the prompt length: the kernel
  masks the ragged tail itself.  On the CPU it keeps the reference's
  q-chunked plain path.
* :func:`attention_decode` — one-token step against the cache, plain
  tensor ops on both devices (the reference has no kernel for it).

The KV cache is the reference's uniform ring buffer: every slot carries
its absolute position (-1 = empty), so masking is position-driven.  Where
the JAX package donates the cache to ``jit``, these functions write into
the given cache in place and return it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops as kops
from .layers import Params, apply_rope, dense_init

__all__ = [
    "NEG_INF",
    "attn_init",
    "FlashAttentionFn",
    "attention_train",
    "init_kv_cache",
    "attention_prefill",
    "attention_decode",
]

NEG_INF = -1e30
KINDS = ("full", "swa", "chunked", "bidir")


# ---------------------------------------------------------------- GQA params
def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype),
        "wk": dense_init(gen, (d, kv, hd), dtype),
        "wv": dense_init(gen, (d, kv, hd), dtype),
        "wo": dense_init(gen, (h, hd, d), dtype, scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n, hd), dtype=dtype, device=gen.device)
    return p


def _project_qkv(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B,S,D) → q (B,S,H,hd), k/v (B,S,KV,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


# ------------------------------------------------------------- mask builders
def _mask_block(qpos: torch.Tensor, kpos: torch.Tensor, kind: str, window: int) -> torch.Tensor:
    """(Sq, Skv) boolean visibility from absolute positions."""
    q = qpos[:, None]
    k = kpos[None, :]
    if kind == "bidir":
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    causal = k <= q
    if kind == "full":
        return causal
    if kind == "swa":
        return causal & (k > q - window)
    if kind == "chunked":
        return causal & (k // window == q // window)
    raise ValueError(f"unknown attention kind {kind!r}")


# ------------------------------------------------- core (q-chunked, online)
def _kernel_kw(kind: str, window: int) -> dict:
    """The kernel's mask arguments for an attention ``kind``."""
    return dict(causal=kind != "bidir", window=window if kind == "swa" else 0, chunk=window if kind == "chunked" else 0)


def _attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    kind: str,
    window: int,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Scaled-dot-product GQA over full K/V (prefill: qpos and kpos both
    ``arange``).  CUDA tensors go to the flash-attention kernel, CPU
    tensors to :func:`_attention_core_plain`."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    if q.is_cuda:
        return kops.attention(q, k, v, **_kernel_kw(kind, window))
    return _attention_core_plain(q, k, v, qpos, kpos, kind, window, q_chunk)


def _attention_core_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    kind: str,
    window: int,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """The reference's lowering (``_attention_core``'s scan), on any
    device: q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd); scanned over query chunks,
    with K/V sliced per chunk for swa/chunked so those flavours cost
    O(S·window); scores in f32, probabilities cast to v's dtype."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    cq = min(q_chunk, sq)
    n_chunks = sq // cq if sq % cq == 0 else 0
    if n_chunks == 0:  # ragged: single block
        cq, n_chunks = sq, 1

    # static KV slice length per chunk for bounded-window flavours
    if kind in ("swa", "chunked") and skv > window + cq:
        kv_len = min(window + cq if kind == "swa" else window, skv)
    else:
        kv_len = skv

    qg = q.reshape(b, n_chunks, cq, kvh, g, hd).permute(1, 0, 3, 4, 2, 5)
    # → (n_chunks, B, KV, G, cq, hd)
    qpos_c = qpos.reshape(n_chunks, cq)
    outs = []
    for c in range(n_chunks):
        qc, qp = qg[c], qpos_c[c]
        if kv_len == skv:
            kc, vc, kp = k, v, kpos
        else:
            # slice the kv range this chunk can see
            if kind == "swa":
                start = int(qp[-1]) + 1 - kv_len
            else:  # chunked: the chunk containing the queries
                start = (int(qp[0]) // window) * window
            start = min(max(start, 0), skv - kv_len)
            kc, vc = k[:, start : start + kv_len], v[:, start : start + kv_len]
            kp = kpos[start : start + kv_len]
        scores = torch.einsum("bkgqh,bskh->bkgqs", qc, kc).float() * scale
        mask = _mask_block(qp, kp, kind, window)
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bkgqh", probs, vc))
    # (n_chunks, B, KV, G, cq, hd) → (B, Sq, H, hd)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd)


class FlashAttentionFn(torch.autograd.Function):
    """Train-path attention through the flash-attention kernel.

    Forward: the kernel (``kops.attention``), with grad mode off as every
    ``Function.forward`` runs.  Backward: not a kernel — the gradient of
    the reference's lowering (:func:`_attention_core_plain`), recomputed
    from the saved q, k and v with PyTorch ops.  The reference has no
    backward kernel (no ``custom_vjp`` in the JAX package), so the port has
    none either; a backward kernel is queued work."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str, window: int) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.kind, ctx.window = kind, window
        return kops.attention(q, k, v, **_kernel_kw(kind, window))

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            qpos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
            kpos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
            out = _attention_core_plain(qd, kd, vd, qpos, kpos, ctx.kind, ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), dout)
        return dq, dk, dv, None, None


def attention_train(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, window: int = 0) -> torch.Tensor:
    """Full-sequence self-attention of the train forward (RoPE on; the
    reference's ``kv_x`` cross-attention and ``rope=False`` encoder forms
    wait for the encoder-decoder slice)."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    sq = x.shape[1]
    q, k, v = _project_qkv(p, x)
    pos = torch.arange(sq, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if q.is_cuda:
        out = FlashAttentionFn.apply(q, k, v, kind, window)
    else:
        out = _attention_core_plain(q, k, v, pos, pos, kind, window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ------------------------------------------------------------------ KV cache
def init_kv_cache(cfg: ArchConfig, batch: int, context: int, dtype: torch.dtype, device: torch.device) -> Params:
    """Ring-buffer cache.  ``S_slots`` = window for bounded flavours."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    slots = context
    if cfg.attn_kind in ("swa", "chunked") and cfg.window and not cfg.global_every:
        slots = min(context, cfg.window)  # global layers need the full context
    return {
        "k": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    }


def _cache_write_prefill(cache: Params, k: torch.Tensor, v: torch.Tensor, kpos: torch.Tensor) -> Params:
    """Write the last ``S_slots`` tokens of a prefill into the ring, in
    place (the JAX package donates the cache)."""
    slots = cache["k"].shape[1]
    s = k.shape[1]
    if s >= slots:
        ktail, vtail, ptail = k[:, -slots:], v[:, -slots:], kpos[-slots:]
        roll = int(ptail[0]) % slots  # ring alignment: slot index = pos % slots
        cache["k"].copy_(torch.roll(ktail, roll, dims=1))
        cache["v"].copy_(torch.roll(vtail, roll, dims=1))
        cache["pos"].copy_(torch.roll(ptail, roll, dims=0)[None].expand_as(cache["pos"]))
        return cache
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    cache["pos"][:, :s] = kpos[None]
    return cache


def attention_prefill(
    p: Params, x: torch.Tensor, cfg: ArchConfig, cache: Params, kind: str, window: int = 0
) -> Tuple[torch.Tensor, Params]:
    """Prompt attention; fills ``cache`` in place and returns it."""
    sq = x.shape[1]
    q, k, v = _project_qkv(p, x)
    qpos = torch.arange(sq, dtype=torch.int32, device=x.device)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    out = _attention_core(q, k, v, qpos, qpos, kind, window)
    _cache_write_prefill(cache, k, v, qpos)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def attention_decode(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    cache: Params,
    positions: torch.Tensor,
    kind: str,
    window: int = 0,
) -> Tuple[torch.Tensor, Params]:
    """One-token step.  x: (B,1,D); positions: (B,) absolute position of the
    new token per request.  Writes each row's slot of ``cache`` in place
    (the JAX package donates the cache) and returns it."""
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kvh
    q, k, v = _project_qkv(p, x)  # (B,1,·,hd)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = (positions % ck.shape[1]).long()
    rows = torch.arange(b, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cpos[rows, slot] = positions.to(cpos.dtype)
    # visibility: position-tagged slots, per-request mask
    qp = positions[:, None]
    visible = (cpos >= 0) & (cpos <= qp)
    if kind == "swa":
        visible &= cpos > qp - window
    elif kind == "chunked":
        visible &= (cpos // window) == (qp // window)
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, ck).float()
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~visible[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, cv).reshape(b, 1, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
