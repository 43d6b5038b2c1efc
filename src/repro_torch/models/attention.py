"""Attention: GQA (full / sliding-window / chunked-local / bidirectional)
and MLA.

Port of ``repro/models/attention.py``.  Three GQA entry points:

* :func:`attention_train` — full-sequence attention of the train forward,
  the encoder (``rope=False``, ``"bidir"``) and cross-attention
  (``kv_x``).  Self-attention on a CUDA tensor runs the Hopper
  flash-attention kernel inside an
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

The kernel takes queries and keys of one length, as the reference's
Pallas route does (``sq == skv``): cross-attention (a decoder's queries
against the encoder's frames) takes the plain path on either device
(:func:`_kernel_route`).

MLA (``minicpm3``): :func:`mla_train`, :func:`mla_prefill` and
:func:`mla_decode` over a latent cache (``c_kv``, the shared ``k_rope``)
of the full context, slot == position.  The reference attends by einsum
there with no kernel, and so does the port, on both devices: per-head
K/V reconstructed from the latent for the prompt, the absorbed form
(scores in latent space) for a decode step.

The KV cache is the reference's uniform ring buffer: every slot carries
its absolute position (-1 = empty), so masking is position-driven.  Where
the JAX package donates the cache to ``jit``, these functions write into
the given cache in place and return it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import obs
from ..configs.base import ArchConfig
from ..kernels import ops as kops
from ..sharding.logical import contiguous_grads, current_rules, is_dtensor, local_einsum, shard
from .layers import Params, apply_rope, dense_init

__all__ = [
    "NEG_INF",
    "attn_init",
    "FlashAttentionFn",
    "attention_train",
    "init_kv_cache",
    "attention_prefill",
    "attention_decode",
    "mla_init",
    "mla_train",
    "init_mla_cache",
    "mla_prefill",
    "mla_decode",
]

NEG_INF = -1e30
KINDS = ("full", "swa", "chunked", "bidir")


# ---------------------------------------------------------------- GQA params
def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, cross: bool = False) -> Params:
    """GQA projections; ``cross`` (a decoder's cross-attention) has no
    biases, as in the reference."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype),
        "wk": dense_init(gen, (d, kv, hd), dtype),
        "wv": dense_init(gen, (d, kv, hd), dtype),
        "wo": dense_init(gen, (h, hd, d), dtype, scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n, hd), dtype=dtype, device=gen.device)
    return p


def _project_qkv(
    p: Params, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B,S,D) → q (B,S,H,hd), k/v (B,Skv,KV,hd); ``kv_x`` for
    cross-attention."""
    kv_src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
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


def _kernel_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether q against k goes to the flash-attention kernel: a CUDA
    tensor whose queries and keys have one length.  The reference's Pallas
    route has the same condition (``sq == skv``); the kernel never
    computes cross-attention."""
    return q.is_cuda and q.shape[1] == k.shape[1]


def _attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    kind: str,
    window: int,
    q_chunk: int = 1024,
    grad: bool = False,
) -> torch.Tensor:
    """Scaled-dot-product GQA over full K/V (qpos and kpos both
    ``arange``).  Under rules that map ``seq_act`` to a mesh axis, the
    reference's sequence-parallel einsums (:func:`_attention_seq_act`,
    never the kernel).  Any attention of DTensors (self- and
    cross-attention, under ``seq_act`` or not) runs on each rank's shards
    (:func:`_attention_local`); self-attention of plain CUDA tensors the
    flash-attention kernel (through :class:`FlashAttentionFn` when
    ``grad``, the train path); everything else
    :func:`_attention_core_plain`."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    seq_act = _seq_act()
    if is_dtensor(q):
        return _attention_local(q, k, v, kind, window, grad, seq_act)
    if seq_act:
        return _attention_seq_act(q, k, v, qpos, kpos, kind, window)
    if _kernel_route(q, k):
        if grad:
            return FlashAttentionFn.apply(q, k, v, kind, window)
        return kops.attention(q, k, v, **_kernel_kw(kind, window))
    return _attention_core_plain(q, k, v, qpos, kpos, kind, window, q_chunk)


def _attention_seq_act(q, k, v, qpos, kpos, kind: str, window: int) -> torch.Tensor:
    """Sequence-parallel attention: the score computation is partitioned
    over the *query sequence* instead of heads — the win for archs whose
    head counts don't divide the model axis (28/40/20 heads on a 16-way
    axis would otherwise replicate all attention compute).  The
    reference's plain einsums of the queries at ``qpos`` over the whole
    key range; on DTensors each rank runs them on its block of queries
    (:func:`_attention_local`)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = shard(q, "batch", "seq_act", "heads", "head_dim")
    qg = q.reshape(b, sq, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * (1.0 / math.sqrt(hd))
    scores = shard(scores, "batch", "kv_heads", None, "seq_act", "seq_kv")
    scores = scores.masked_fill(~_mask_block(qpos, kpos, kind, window), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = shard(probs, "batch", "kv_heads", None, "seq_act", "seq_kv")
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(b, sq, h, hd)
    return shard(out, "batch", "seq_act", "heads", "head_dim")


def _seq_act() -> bool:
    """Whether the active rules map ``seq_act`` to a mesh axis."""
    rules = current_rules()
    return bool(rules is not None and rules.table.get("seq_act"))


def _kv_pick(a: int, hl: int, b0: int, kl: int, g: int):
    """The local kv heads that local query heads a..a+hl-1 (global
    numbering, G query heads a kv head) read, from a kv shard of kl heads
    starting at global kv head b0: None when the shard lines up as it is,
    a slice when they are a contiguous run each read by the same number of
    query heads, else one kv head index per query head."""
    need = [(a + i) // g - b0 for i in range(hl)]
    lo, n = need[0], need[-1] - need[0] + 1
    if hl % n == 0 and need == [lo + i // (hl // n) for i in range(hl)]:
        return None if (lo, n) == (0, kl) else slice(lo, lo + n)
    return need


def _attention_local(q, k, v, kind: str, window: int, grad: bool, seq_act: bool = False) -> torch.Tensor:
    """Attention of DTensors q (B,Sq,H,D) and k/v (B,Skv,KV,D) on each
    rank's local shards (``local_map``): the kernel on CUDA shards
    (:class:`FlashAttentionFn` when ``grad``), :func:`_attention_core_plain`
    on CPU and meta ones, so the placement logic is the same on every
    device; under ``seq_act`` the queries are sharded over the sequence as
    the rules say and each rank runs :func:`_attention_seq_act` on its
    block of queries against all keys.  Batch, heads (and the query
    sequence under ``seq_act``) stay sharded as q's are; k and v follow
    q's batch sharding, and any other sharding (the sequence, a partial
    sum) is gathered first.  Each rank hands its attention the kv heads
    its query heads use: with kv heads replicated and query heads sharded
    (4 kv heads on a 16-way axis), local head h' of a shard starting at
    global head a reads kv head (a + h') // G, not h' // G'."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    if seq_act:
        q = shard(q, "batch", "seq_act", "heads", "head_dim")
    keep = lambda pl, dims: pl if isinstance(pl, Shard) and pl.dim in dims else Replicate()  # noqa: E731
    q_pl = tuple(keep(pl, (0, 1, 2) if seq_act else (0, 2)) for pl in q.placements)
    kv_pl = tuple(Shard(0) if qp == Shard(0) else (keep(kp, (2,)) if qp == Shard(2) else Replicate())
                  for qp, kp in zip(q_pl, k.placements))
    q = q if tuple(q.placements) == q_pl else q.redistribute(mesh, q_pl)
    k = k if tuple(k.placements) == kv_pl else k.redistribute(mesh, kv_pl)
    v = v if tuple(v.placements) == kv_pl else v.redistribute(mesh, kv_pl)
    (_, _, hl, _), (_, s0, a, _) = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)
    (_, _, kl, _), (_, _, b0, _) = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)
    pick = _kv_pick(a, hl, b0, kl, q.shape[2] // k.shape[2])

    def body(ql: torch.Tensor, kl_: torch.Tensor, vl: torch.Tensor) -> torch.Tensor:
        contiguous_grads(ql, kl_, vl)
        if pick is not None:
            idx = pick if isinstance(pick, slice) else torch.tensor(pick, device=kl_.device)
            kl_, vl = kl_[:, :, idx].contiguous(), vl[:, :, idx].contiguous()
        kpos = torch.arange(kl_.shape[1], dtype=torch.int32, device=kl_.device)
        qpos = torch.arange(s0, s0 + ql.shape[1], dtype=torch.int32, device=ql.device)
        if seq_act:
            return _attention_seq_act(ql, kl_, vl, qpos, kpos, kind, window)
        if _kernel_route(ql, kl_):
            if grad:
                return FlashAttentionFn.apply(ql, kl_, vl, kind, window)
            return kops.attention(ql, kl_, vl, **_kernel_kw(kind, window))
        return _attention_core_plain(ql, kl_, vl, qpos, kpos, kind, window)

    # a kv shard replicated across query shards (heads, or the sequence
    # under seq_act) gets one partial gradient from each of them
    kv_grad = tuple(Partial() if qp in (Shard(1), Shard(2)) and kp == Replicate() else kp
                    for qp, kp in zip(q_pl, kv_pl))
    return local_map(body, out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh)(q, k, v)


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
    device: q: (B,Sq,H,hd); k,v: (B,Skv,KV,hd); qpos = arange(Sq), kpos =
    arange(Skv); scanned over query chunks, with K/V sliced per chunk for
    swa/chunked so those flavours cost O(S·window); scores in f32,
    probabilities cast to v's dtype.  The slices are computed from the
    chunk index, never read from a position tensor, so a meta tensor (the
    dry-run) takes this path too."""
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
                start = (c + 1) * cq - kv_len  # the chunk's last query + 1 - kv_len
            else:  # chunked: the chunk containing the queries
                start = (c * cq // window) * window
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


def attention_train(
    p: Params,
    x: torch.Tensor,
    cfg: ArchConfig,
    kind: str,
    window: int = 0,
    kv_x: Optional[torch.Tensor] = None,
    rope: bool = True,
) -> torch.Tensor:
    """Full-sequence attention: the train forward, the encoder
    (``rope=False``) and cross-attention (keys and values from ``kv_x``)."""
    q, k, v = _project_qkv(p, x, kv_x)
    qpos = torch.arange(q.shape[1], dtype=torch.int32, device=x.device)
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    if rope:
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, kpos, cfg.rope_theta)
    out = _attention_core(q, k, v, qpos, kpos, kind, window, grad=True)
    out = shard(out, "batch", "seq", "heads", "head_dim")
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
    """Write the last ``S_slots`` tokens of a prefill (kpos = arange(s))
    into the ring, in place (the JAX package donates the cache)."""
    slots = cache["k"].shape[1]
    s = k.shape[1]
    if s >= slots:
        ktail, vtail, ptail = k[:, -slots:], v[:, -slots:], kpos[-slots:]
        roll = (s - slots) % slots  # ring alignment: slot index = pos % slots, ptail[0] = s - slots
        if roll:  # (a prompt of a whole number of rings needs none: DTensor has no rule for roll)
            ktail, vtail, ptail = torch.roll(ktail, roll, dims=1), torch.roll(vtail, roll, dims=1), torch.roll(ptail, roll, dims=0)
        cache["k"].copy_(ktail)
        cache["v"].copy_(vtail)
        cache["pos"].copy_(ptail[None].expand_as(cache["pos"]))
        return cache
    _write_prefix(cache["k"], k)
    _write_prefix(cache["v"], v)
    _write_prefix(cache["pos"], kpos[None])
    return cache


def _write_prefix(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, :s] = src`` in place, s = ``src.shape[1]`` (``src`` may
    broadcast over the batch).  A DTensor cache is written on each rank's
    shards (``local_map``): the rank holding slots [o, o + n) of a cache
    sharded over its slot dim writes the prompt's tokens that fall there,
    from ``src`` gathered over the sequence and placed as ``dst`` on every
    other dim.  (A slice of a DTensor sharded over the sliced dim is a new
    tensor, not a view, so assigning into it would write nothing.)"""
    if not is_dtensor(dst):
        dst[:, : src.shape[1]] = src
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh, d_pl, s = dst.device_mesh, tuple(dst.placements), src.shape[1]
    s_pl = tuple(Replicate() if pl == Shard(1) or src.shape[0] == 1 else pl for pl in d_pl)
    (_, n, *_), (_, o, *_) = compute_local_shape_and_global_offset(dst.shape, mesh, d_pl)

    def body(dl: torch.Tensor, sl: torch.Tensor) -> torch.Tensor:
        if min(o + n, s) > o:
            dl[:, : min(o + n, s) - o] = sl[:, o : min(o + n, s)]
        return dl

    local_map(body, out_placements=list(d_pl), in_placements=(d_pl, s_pl), device_mesh=mesh,
              redistribute_inputs=True)(dst, src)


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
    # placed as the train path places it (the reference leaves it to GSPMD):
    # a seq_act-sharded output would merge two sharded dims into the
    # projection's rows, which DTensor plans by a search too slow for 3-D meshes
    out = shard(out, "batch", "seq", "heads", "head_dim")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def _group_heads(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """(B,S,H,hd) → (B,S,KV,G,hd) for the keys ``kv`` (B,T,KV,hd).  A
    DTensor q is first gathered over its heads on every mesh dim where
    ``kv``'s heads are not sharded alike: its heads dim cannot split into
    (KV, G) over more shards than there are kv heads (32 query heads, 8 kv
    heads, a 16-way axis), and against a cache sharded over its sequence
    (the serving cells) DTensor would search a 3-D mesh's plans for the
    product for minutes.  A decode step's q is one token: the gather is
    small."""
    b, s, h, hd = q.shape
    kvh = kv.shape[2]
    if is_dtensor(q):
        from torch.distributed.tensor import Replicate, Shard

        kv_pl = tuple(kv.placements) if is_dtensor(kv) else (Replicate(),) * q.device_mesh.ndim
        pl = tuple(Replicate() if p == Shard(2) and kp != Shard(2) else p for p, kp in zip(q.placements, kv_pl))
        if pl != tuple(q.placements):
            q = q.redistribute(q.device_mesh, pl)
    return q.reshape(b, s, kvh, h // kvh, hd)


def _write_slots(dst: torch.Tensor, slot: torch.Tensor, val: torch.Tensor, names: Tuple[str, ...],
                 guard: bool = False) -> None:
    """``dst[b, slot[b]] = val[b]`` for every row b, in place; with
    ``guard`` a slot outside ``dst`` writes nothing (MLA's cache is not a
    ring).  A DTensor cache takes the reference's one-hot select over the
    slot dim (elementwise, so it partitions when the cache sequence is
    sharded; an outside slot matches none) placed by the logical
    ``names``, then copies it back; a plain one an indexed write of the B
    rows."""
    if is_dtensor(dst):
        oh = torch.arange(dst.shape[1], device=slot.device)[None, :] == slot[:, None]  # (B, slots)
        oh = oh.reshape(oh.shape + (1,) * (dst.dim() - 2))
        dst.copy_(shard(torch.where(oh, val[:, None].to(dst.dtype), dst), *names))
        return
    rows = torch.arange(dst.shape[0], device=dst.device)
    if not guard:
        dst[rows, slot.long()] = val.to(dst.dtype)
        return
    inside = (slot >= 0) & (slot < dst.shape[1])
    idx = slot.clamp(0, dst.shape[1] - 1).long()
    keep = inside.reshape(inside.shape + (1,) * (val.dim() - 1))
    dst[rows, idx] = torch.where(keep, val.to(dst.dtype), dst[rows, idx])


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
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    with obs.range("attn.qkv"):
        q, k, v = _project_qkv(p, x)  # (B,1,·,hd)
        q = apply_rope(q, positions[:, None], cfg.rope_theta)
        k = apply_rope(k, positions[:, None], cfg.rope_theta)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    with obs.range("attn.kv_write"):
        slot = positions % ck.shape[1]
        _write_slots(ck, slot, k[:, 0], ("batch", "seq_kv", "kv_heads", "head_dim"))
        _write_slots(cv, slot, v[:, 0], ("batch", "seq_kv", "kv_heads", "head_dim"))
        _write_slots(cpos, slot, positions, ("batch", "seq_kv"))
    with obs.range("attn.attend"):
        # visibility: position-tagged slots, per-request mask
        qp = positions[:, None]
        visible = (cpos >= 0) & (cpos <= qp)
        if kind == "swa":
            visible &= cpos > qp - window
        elif kind == "chunked":  # div, not //: DTensor has no floor_divide strategy on every release
            visible &= cpos.div(window, rounding_mode="floor") == qp.div(window, rounding_mode="floor")
        qg = _group_heads(q, ck)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, ck).float()
        scores = scores / math.sqrt(hd)
        scores = scores.masked_fill(~visible[:, None, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cv.dtype)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, cv).reshape(b, 1, h, hd)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


# ============================================================== MLA (minicpm3)
def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (d, qr), dtype),  # down-project q
        "wq_b": dense_init(gen, (qr, h, dn + dr), dtype),  # up-project q
        "wkv_a": dense_init(gen, (d, kvr + dr), dtype),  # latent + shared k_rope
        "wk_b": dense_init(gen, (kvr, h, dn), dtype),  # latent → per-head k_nope
        "wv_b": dense_init(gen, (kvr, h, dv), dtype),  # latent → per-head v
        "wo": dense_init(gen, (h, dv, d), dtype, scale=1.0 / math.sqrt(h * dv)),
    }


def _mla_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig, qpos: torch.Tensor):
    """Project to q (nope‖rope), the latent c_kv and the shared k_rope
    (RoPE through a head axis of 1)."""
    kvr, dn = cfg.kv_lora_rank, cfg.nope_head_dim
    q = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
    q = torch.einsum("bsr,rhe->bshe", q, p["wq_b"])  # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], qpos, cfg.rope_theta)
    kv = torch.einsum("bsd,de->bse", x, p["wkv_a"])  # (B,S,kvr+dr)
    c_kv = shard(kv[..., :kvr], "batch", "seq", "latent")
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], qpos, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_softmax(s_nope: torch.Tensor, s_rope: torch.Tensor, mask: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype) -> torch.Tensor:
    """The two score terms summed in their own dtype, then f32 (the
    reference's order: in bf16 the sum rounds before the cast), scaled,
    masked, softmaxed and cast to ``dtype``; scores and probabilities
    (B, H, Sq, T) placed over heads or, under ``seq_act``, the queries."""
    scores = (s_nope + s_rope).float() / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    scores = shard(scores, "batch", "heads", "seq_act", "seq_kv")
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return shard(probs, "batch", "heads", "seq_act", "seq_kv")


def _shard_q(q_nope: torch.Tensor, q_rope: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLA queries placed over heads or, under ``seq_act``, the sequence."""
    return (shard(q_nope, "batch", "seq_act", "heads", "head_dim"),
            shard(q_rope, "batch", "seq_act", "heads", "head_dim"))


def _mla_attend(p: Params, q_nope, q_rope, c_kv, k_rope, mask, cfg: ArchConfig) -> torch.Tensor:
    """Absorbed-matmul attention (decode): wk_b folded into the query, so
    the scores live in latent space and the latent cache is never expanded
    per head."""
    q_nope, q_rope = _shard_q(q_nope, q_rope)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p["wk_b"])
    s_nope = torch.einsum("bshr,btr->bhst", q_lat, c_kv)
    s_rope = torch.einsum("bshe,bte->bhst", q_rope, k_rope)
    probs = _mla_softmax(s_nope, s_rope, mask, cfg, c_kv.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_kv)
    out = torch.einsum("bshr,rhe->bshe", ctx_lat, p["wv_b"])  # (B,Sq,H,dv)
    out = shard(out, "batch", "seq_act", "heads", "head_dim")
    return local_einsum("bshe,hed->bsd", out, p["wo"])  # on DTensors a partial sum over the head shards


def _mla_attend_reconstructed(p: Params, q_nope, q_rope, c_kv, k_rope, mask, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence MLA (prefill and train) through per-head K/V
    reconstructed from the latent; materialises (B, H, S, S) f32 scores.
    DTensors run it on each rank's shards (:func:`_mla_attend_local`) and
    hand the output back placed as the residual stream (the train path's
    backward would otherwise carry a gradient sharded over batch and
    sequence into the next projection's ``view``, which merges the two)."""
    if is_dtensor(q_nope):
        return shard(_mla_attend_local(p, q_nope, q_rope, c_kv, k_rope, cfg), "batch", "seq", "embed")
    k_nope = torch.einsum("btr,rhe->bthe", c_kv, p["wk_b"])  # (B,T,H,dn)
    v = torch.einsum("btr,rhe->bthe", c_kv, p["wv_b"])  # (B,T,H,dv)
    q_nope, q_rope = _shard_q(q_nope, q_rope)
    s_nope = torch.einsum("bshe,bthe->bhst", q_nope, k_nope)
    s_rope = torch.einsum("bshe,bte->bhst", q_rope, k_rope)
    probs = _mla_softmax(s_nope, s_rope, mask, cfg, v.dtype)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    out = shard(out, "batch", "seq_act", "heads", "head_dim")
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def _mla_attend_local(p: Params, q_nope, q_rope, c_kv, k_rope, cfg: ArchConfig) -> torch.Tensor:
    """:func:`_mla_attend_reconstructed` of DTensors on each rank's shards
    (``local_map``): the queries sharded over batch and, as the rules say,
    the sequence (``seq_act``) or the heads, the latent and shared key
    over the batch only, the per-head weights over the queries' heads;
    each rank attends its block of queries to every key (causal by
    absolute position) and projects it.  The output (B, S, D) keeps the
    queries' batch and sequence sharding and is a partial sum over their
    head shards.  (DTensor's own einsums here merge two sharded dims into
    one, which some releases refuse and others plan by a search too slow
    for a 3-D mesh.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    q_nope, q_rope = _shard_q(q_nope, q_rope)
    mesh = q_nope.device_mesh
    q_pl = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 1, 2) else Replicate() for pl in q_nope.placements)
    kv_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in q_pl)
    heads = lambda d: tuple(Shard(d) if pl == Shard(2) else Replicate() for pl in q_pl)  # noqa: E731
    w_pl = (heads(1), heads(1), heads(0))  # wk_b, wv_b (r, H, ·); wo (H, dv, D)
    out_pl = [Partial() if pl == Shard(2) else pl for pl in q_pl]
    # replicated inputs read by several query shards get one partial gradient from each
    kv_grad = tuple(Partial() if pl in (Shard(1), Shard(2)) else kp for pl, kp in zip(q_pl, kv_pl))
    w_grad = tuple(tuple(Partial() if pl in (Shard(0), Shard(1)) else wp for pl, wp in zip(q_pl, w)) for w in w_pl)
    s0 = compute_local_shape_and_global_offset(q_nope.shape, mesh, q_pl)[1][1]

    def body(qn, qr, ck, kr, wk, wv, wo):
        contiguous_grads(qn, qr, ck, kr, wk, wv, wo)
        qpos = torch.arange(s0, s0 + qn.shape[1], dtype=torch.int32, device=qn.device)
        kpos = torch.arange(ck.shape[1], dtype=torch.int32, device=ck.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None]
        return _mla_attend_reconstructed({"wk_b": wk, "wv_b": wv, "wo": wo}, qn, qr, ck, kr, mask, cfg)

    return local_map(body, out_placements=out_pl, in_placements=(q_pl, q_pl, kv_pl, kv_pl) + w_pl,
                     in_grad_placements=(q_pl, q_pl, kv_grad, kv_grad) + w_grad,
                     device_mesh=mesh, redistribute_inputs=True)(q_nope, q_rope, c_kv, k_rope, p["wk_b"], p["wv_b"], p["wo"])


def _causal(s: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions 0..s-1 and the (1, 1, s, s) causal mask over them."""
    pos = torch.arange(s, dtype=torch.int32, device=device)
    return pos, (pos[:, None] >= pos[None, :])[None, None]


def mla_train(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    qpos, mask = _causal(x.shape[1], x.device)
    return _mla_attend_reconstructed(p, *_mla_qkv(p, x, cfg, qpos), mask, cfg)


def init_mla_cache(cfg: ArchConfig, batch: int, context: int, dtype: torch.dtype, device: torch.device) -> Params:
    """The latent cache of the full context (not a ring: slot == position)."""
    return {
        "c_kv": torch.zeros((batch, context, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, context, cfg.rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, context), -1, dtype=torch.int32, device=device),
    }


def mla_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig, cache: Params) -> Tuple[torch.Tensor, Params]:
    """Prompt attention; writes slots 0..S-1 of ``cache`` in place and
    returns it."""
    s = x.shape[1]
    qpos, mask = _causal(s, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, qpos)
    out = _mla_attend_reconstructed(p, q_nope, q_rope, c_kv, k_rope, mask, cfg)
    _write_prefix(cache["c_kv"], c_kv)
    _write_prefix(cache["k_rope"], k_rope)
    _write_prefix(cache["pos"], qpos[None])
    return out, cache


def mla_decode(
    p: Params, x: torch.Tensor, cfg: ArchConfig, cache: Params, positions: torch.Tensor
) -> Tuple[torch.Tensor, Params]:
    """One-token step.  Writes each row's slot ``positions`` of ``cache`` in
    place; a position outside the context writes nothing, as the
    reference's one-hot write (its slot is rewritten with what it held)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions[:, None])
    ck, kr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    _write_slots(ck, positions, c_kv[:, 0], ("batch", "seq_kv", "latent"), guard=True)
    _write_slots(kr, positions, k_rope[:, 0], ("batch", "seq_kv", None), guard=True)
    _write_slots(cpos, positions, positions, ("batch", "seq_kv"), guard=True)
    mask = ((cpos >= 0) & (cpos <= positions[:, None]))[:, None, None, :]
    return _mla_attend(p, q_nope, q_rope, ck, kr, mask, cfg), cache
