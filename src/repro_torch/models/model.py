"""LM assembly for every architecture family.

Port of ``repro/models/model.py``: the dense decoder, MLA (minicpm3), MoE
(deepseek-moe, llama4-scout), SSM (mamba2), hybrid (zamba2), VLM
(internvl2) and encoder-decoder (whisper) branches:

* ``init_params(gen, cfg)``            — stacked per-layer params (leading ``L``)
* ``forward_train(params, cfg, batch)`` → (logits, aux_loss)
* ``loss_fn(params, cfg, batch)``       → (loss, metrics)
* ``init_cache(cfg, batch, context)``   — stacked decode cache
* ``prefill(params, cfg, batch, cache)`` → (last-token logits, cache)
* ``decode_step(params, cfg, tokens, positions, cache)`` → (logits, cache)

Parameters and caches keep the JAX pytree's keys and shapes, so
:mod:`repro_torch.bridge` maps one onto the other 1:1.  A Python loop over
the layers replaces ``lax.scan``; each layer reads views of the stacked
tensors, so cache writes land in the stacked cache in place (where the JAX
package donates it).  The hybrid's shared attention+MLP block runs after
every ``attn_every``-th layer (on its own slice ``idx // attn_every`` of
the stacked ``shared_attn`` cache when serving), where the reference has
``lax.cond``; so do llama4's global layers (every ``global_every``-th
attends over the full context, the others chunk-locally), in train,
prefill and decode.  A hybrid in the ``zamba2`` layout
(``zamba2-1.2b-published``, served only) runs published Zamba2's shared
block instead, before each of its ``hybrid_layer_ids`` on concat(h, x0)
(:func:`_zamba2_layers`).  A MoE layer's FFN is
:func:`repro_torch.models.moe.moe_apply`; the train path sums its aux loss
over the layers, the serving path drops it as the reference's does.  The
VLM takes its stubbed vision frontend's patch embeddings as
``batch["prefix"]`` (B, P, D), placed before the text (the loss scores
text positions only; decode positions count the prefix).  The
encoder-decoder takes its stubbed audio frontend's frame embeddings as
``batch["frames"]`` (B, encoder_seq, D) in the model's dtype: a
bidirectional encoder without RoPE, then cross-attention in every decoder
layer, whose keys and values ``prefill`` caches once a request
(``cross_kv``) for ``decode_step``.  On a
card the train forward runs every kernel through an ``autograd.Function``
(:class:`~repro_torch.models.attention.FlashAttentionFn`,
:class:`~repro_torch.models.ssm.SSDChunkFn`,
:class:`~repro_torch.models.moe.GroupedMatmulFn`).  ``remat`` maps to
``torch.utils.checkpoint`` per layer (the hybrid's shared block inside its
layer, as the reference's ``jax.checkpoint(body)``): ``"full"`` recomputes
everything, ``"dots"`` / ``"dots_no_batch"`` save the matmul outputs
(selective checkpointing, as the reference's ``checkpoint_dots``
policies).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import obs
from ..configs.base import ArchConfig, shared_layers, zamba2_layout
from ..device import resolve_device
from ..sharding.logical import contiguous_grads, is_dtensor, replicate_plain, shard
from ..tree import tree_map
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import Params, cross_entropy_loss, dense_init, embed_init, ffn_apply, ffn_init, rms_norm

__all__ = ["init_params", "forward_train", "loss_fn", "init_cache", "prefill", "decode_step", "model_dtype"]


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer_kind(cfg: ArchConfig, idx: int) -> Tuple[str, int]:
    """Decoder layer ``idx``'s attention kind and window: llama4-style,
    every ``global_every``-th chunked layer attends globally."""
    if cfg.attn_kind == "chunked" and cfg.global_every and (idx + 1) % cfg.global_every == 0:
        return "full", 0
    return cfg.attn_kind, cfg.window


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: views, not copies."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree: Any) -> Any:
    """Each stacked leaf as its ``L`` per-layer views.  Under autograd the
    views' gradients come back as one ``stack``; indexing the stacked leaf
    per layer would give each layer's gradient a zero-filled copy of the
    whole stack, summed L times."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _put(stacked: Any, tree: Any, i: int) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, i)
    else:
        stacked[i] = tree


def _init_stacked(make, n: int) -> Any:
    """``n`` trees from ``make()`` stacked on a leading dim, drawn in order
    and copied one at a time into preallocated leaves, so the peak is the
    stack plus one tree (a list of trees and their stack would hold two
    copies of the weights)."""
    first = make()
    stacked = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    _put(stacked, first, 0)
    del first
    for i in range(1, n):
        _put(stacked, make(), i)
    return stacked


# ------------------------------------------------------------------- params
def _block_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """Pre-norm attention (GQA or MLA) + FFN (``moe`` in a MoE layer): a
    dense, MLA or MoE layer, or the hybrid's shared block."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)  # noqa: E731
    mixer = attn.mla_init if cfg.attn_kind == "mla" else attn.attn_init
    p = {"ln1": ones(), "attn": mixer(gen, cfg, dtype), "ln2": ones()}
    if cfg.is_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_ffn)
    return p


def _layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    if cfg.family in ("ssm", "hybrid"):
        return {
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
            "ssm": ssm_mod.ssm_init(gen, cfg, dtype),
        }
    return _block_init(gen, cfg, dtype)


def _zamba2_block_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """The zamba2 layout's shared block: a norm over the attention input
    (concat(h, x0), 2 * d_model wide), attention from that width back to
    d_model, a norm over d_model and the gated MLP."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    a = 2 * d
    ones = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)  # noqa: E731
    return {
        "ln1": ones(a),
        "attn": {"wq": dense_init(gen, (a, h, hd), dtype), "wk": dense_init(gen, (a, kv, hd), dtype),
                 "wv": dense_init(gen, (a, kv, hd), dtype),
                 "wo": dense_init(gen, (h, hd, d), dtype, scale=1.0 / math.sqrt(h * hd))},
        "ln2": ones(d),
        "ffn": ffn_init(gen, d, cfg.d_ff, dtype, gated=True),
    }


def _zamba2_inv_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """One invocation's own weights in the zamba2 layout: the linear layer
    after the block, the gate-up adapter (``ffn_a`` then ``ffn_b``, whose
    output is [gate | up]) and the q/k/v adapters, as the flags set them."""
    d, r, f = cfg.d_model, cfg.adapter_rank, cfg.d_ff
    a = 2 * d
    p = {"linear": dense_init(gen, (d, d), dtype)}
    if cfg.use_shared_mlp_adapter:
        p["ffn_a"], p["ffn_b"] = dense_init(gen, (d, r), dtype), dense_init(gen, (r, 2 * f), dtype)
    if cfg.use_shared_attention_adapter:
        for n, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads), ("v", cfg.n_kv_heads)):
            p[f"{n}_a"] = dense_init(gen, (a, r), dtype)
            p[f"{n}_b"] = dense_init(gen, (r, heads, cfg.resolved_head_dim), dtype)
    return p


def _encoder_layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)  # noqa: E731
    return {"ln1": ones(), "attn": attn.attn_init(gen, cfg, dtype), "ln2": ones(),
            "ffn": ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_ffn)}


def _cross_layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    return {"ln": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
            "attn": attn.attn_init(gen, cfg, dtype, cross=True)}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    dtype = model_dtype(cfg)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, scale=1.0 / math.sqrt(cfg.d_model))
    p["layers"] = _init_stacked(lambda: _layer_init(gen, cfg, dtype), cfg.n_layers)
    if zamba2_layout(cfg):
        p["shared_block"] = _zamba2_block_init(gen, cfg, dtype)
        p["shared_inv"] = _init_stacked(lambda: _zamba2_inv_init(gen, cfg, dtype), len(cfg.hybrid_layer_ids))
    elif cfg.family == "hybrid":
        p["shared_block"] = _block_init(gen, cfg, dtype)
    if cfg.is_encdec:
        p["encoder"] = _init_stacked(lambda: _encoder_layer_init(gen, cfg, dtype), cfg.encoder_layers)
        p["enc_ln_f"] = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
        p["cross"] = _init_stacked(lambda: _cross_layer_init(gen, cfg, dtype), cfg.n_layers)
    return p


def _embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]
    x = _embed_local(table, tokens) if is_dtensor(table) else table[tokens]
    return shard(x, "batch", "seq", "embed")


def _embed_local(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding gather of a DTensor table on each rank's shards
    (``local_map``), the vocab-parallel lookup: a rank holding rows
    [r0, r0 + n) of the table looks up the tokens that fall there and
    zeroes the rest, and the output is a partial sum over the vocab
    shards (the reference's gather of vocab-sharded rows, an all-gather
    of slices under GSPMD).  DTensor has no working rule for the gather
    itself on every mesh (and none for its backward's ``index_put``).
    The tokens keep their batch sharding; the table's gradient is a
    partial sum over the batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tok_pl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in tokens.placements)
    t_pl = tuple(Shard(0) if pl == Shard(0) and tp != Shard(0) else Replicate()
                 for pl, tp in zip(table.placements, tok_pl))
    out_pl = [Partial() if pl == Shard(0) else tp for pl, tp in zip(t_pl, tok_pl)]
    t_grad = tuple(Partial() if tp == Shard(0) else pl for pl, tp in zip(t_pl, tok_pl))
    r0 = compute_local_shape_and_global_offset(table.shape, mesh, t_pl)[1][0]
    vocab_sharded = Shard(0) in t_pl

    def body(tl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        contiguous_grads(tl)
        if not vocab_sharded:
            return tl[idx]
        local = idx - r0
        hit = (local >= 0) & (local < tl.shape[0])
        return tl[local.clamp(0, tl.shape[0] - 1)] * hit[..., None].to(tl.dtype)

    return local_map(body, out_placements=out_pl, in_placements=(t_pl, tok_pl), in_grad_placements=(t_grad, tok_pl),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def _embed_inputs(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings, behind the VLM's ``prefix`` where the batch has one."""
    x = _embed_tokens(params, batch["tokens"])
    if cfg.frontend == "vision" and "prefix" in batch:
        x = shard(torch.cat([batch["prefix"].to(x.dtype), x], dim=1), "batch", "seq", "embed")
    return x


def _encode(params: Params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder (no RoPE) over the stubbed frontend's frame
    embeddings (B, encoder_seq, D)."""
    x = frames
    layers = _unbind(params["encoder"])
    for i in range(cfg.encoder_layers):
        lp = _index(layers, i)
        x = x + attn.attention_train(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, "bidir", rope=False)
        x = x + ffn_apply(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), gated=cfg.gated_ffn)
    return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


def _cross_attend(cp: Params, cfg: ArchConfig, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """A decoder layer's cross-attention over the encoder output, prompt
    and train path (plain: its queries and keys differ in length)."""
    return attn.attention_train(cp["attn"], rms_norm(x, cp["ln"], cfg.norm_eps), cfg, "bidir", kv_x=enc_out, rope=False)


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]  # (V, d)
    return shard(torch.einsum("bsd,vd->bsv", x, head), "batch", "seq", "vocab")


# ------------------------------------------------------------- train forward
def _mixer_train(lp: Params, h: torch.Tensor, cfg: ArchConfig, idx: int) -> torch.Tensor:
    """Sequence mixer (SSD, MLA or GQA) of layer ``idx`` on a normalized
    input, train path."""
    if "ssm" in lp:
        return ssm_mod.ssm_apply(lp["ssm"], h, cfg)[0]
    if cfg.attn_kind == "mla":
        return attn.mla_train(lp["attn"], h, cfg)
    return attn.attention_train(lp["attn"], h, cfg, *_layer_kind(cfg, idx))


def _channel_train(lp: Params, h: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel mixer, train path: the MoE FFN and its aux loss, or the
    dense FFN and a zero aux loss."""
    if "moe" in lp:
        return moe_mod.moe_apply(lp["moe"], h, cfg)
    return ffn_apply(lp["ffn"], h, gated=cfg.gated_ffn), torch.zeros((), dtype=torch.float32, device=h.device)


def _shared_block_train(sp: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The hybrid's shared attention+MLP block, train path."""
    x = x + attn.attention_train(sp["attn"], rms_norm(x, sp["ln1"], cfg.norm_eps), cfg, cfg.attn_kind, cfg.window)
    return x + ffn_apply(sp["ffn"], rms_norm(x, sp["ln2"], cfg.norm_eps), gated=cfg.gated_ffn)


REMATS = ("none", "full", "dots", "dots_no_batch")


def _dots_context(no_batch: bool) -> Callable:
    """Selective checkpointing that saves matmul outputs: ``mm`` and
    ``addmm`` always, ``bmm`` too unless ``no_batch`` (the reference's
    ``checkpoint_dots`` / ``checkpoint_dots_with_no_batch_dims``)."""
    try:
        from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
    except ImportError as exc:  # torch before selective checkpointing
        raise NotImplementedError(f"remat 'dots' needs torch.utils.checkpoint selective checkpointing: {exc}") from None
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default} | (set() if no_batch else {aten.bmm.default})

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _decoder_train(
    params: Params, cfg: ArchConfig, x: torch.Tensor, enc_out: Optional[torch.Tensor] = None, remat: str = "none"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the decoder stack (cross-attending to ``enc_out`` where the
    model has an encoder); returns (hidden, aux_loss_sum)."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    if zamba2_layout(cfg):
        raise NotImplementedError(f"{cfg.name}: the zamba2 layout is served (prefill, decode_step), not trained")

    shared = params.get("shared_block")

    def body(h: torch.Tensor, lp: Params, cp: Optional[Params], idx: int,
             enc: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = h + _mixer_train(lp, rms_norm(h, lp["ln1"], cfg.norm_eps), cfg, idx)
        h = shard(h, "batch", "seq", "embed")
        if cp is not None:
            h = h + _cross_attend(cp, cfg, h, enc)
        a_loss = None
        if "ln2" in lp:  # SSM layers have no channel mixer
            f, a_loss = _channel_train(lp, rms_norm(h, lp["ln2"], cfg.norm_eps), cfg)
            h = h + f
        if shared is not None and idx % cfg.attn_every == 0:
            h = _shared_block_train(shared, h, cfg)
        return shard(h, "batch", "seq", "embed"), a_loss

    ckpt_kw = None
    if remat != "none":
        from torch.utils.checkpoint import checkpoint

        ckpt_kw = {"use_reentrant": False}
        if remat != "full":
            ckpt_kw["context_fn"] = _dots_context(remat == "dots_no_batch")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unbind(params["layers"])
    cross = _unbind(params["cross"]) if "cross" in params else None
    for i in range(cfg.n_layers):
        lp = _index(layers, i)
        cp = None if cross is None else _index(cross, i)
        if ckpt_kw is None:
            x, a_loss = body(x, lp, cp, i, enc_out)
        else:
            x, a_loss = checkpoint(body, x, lp, cp, i, enc_out, **ckpt_kw)
        if a_loss is not None:
            aux = aux + a_loss
    return x, aux


def forward_train(
    params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], remat: str = "none"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens (B, S) [+ ``prefix`` (B, P, D) | ``frames`` (B, F, D)].
    Returns (logits (B, P + S, V), aux_loss)."""
    with replicate_plain(params):
        x = _embed_inputs(params, cfg, batch)
        enc_out = _encode(params, cfg, batch["frames"]) if cfg.is_encdec else None
        x, aux = _decoder_train(params, cfg, x, enc_out, remat=remat)
        return _logits(params, cfg, x), aux


def loss_fn(
    params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], remat: str = "none"
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over text positions whose label is
    >= 0 (a VLM's prefix gives context only), plus the router aux loss;
    returns (total, {"loss", "xent", "aux"})."""
    logits, aux = forward_train(params, cfg, batch, remat=remat)
    if cfg.frontend == "vision" and "prefix" in batch:
        logits = logits[:, batch["prefix"].shape[1]:]
    labels = batch["labels"]
    with replicate_plain(params):
        mask = (labels >= 0).float()
        xent = cross_entropy_loss(logits, torch.clamp_min(labels, 0), mask)
        total = xent + cfg.router_aux_coef * aux
    return total, {"loss": total, "xent": xent, "aux": aux}


# ------------------------------------------------------------------- caches
def _shard_cache(cache: Params) -> Params:
    """The reference's cache annotation: (L, B, S, KV, hd) rings over
    (batch, seq_kv, kv_heads), 4-dim leaves over (batch, seq_kv).  The
    reference defines it and calls it nowhere; the port keeps it for
    parity (the caches are placed by ``sharding.params.cache_specs``)."""
    def ann(a: torch.Tensor) -> torch.Tensor:
        if a.dim() == 5:  # (L,B,S,KV,hd)
            return shard(a, None, "batch", "seq_kv", "kv_heads", "head_dim")
        if a.dim() == 4:
            return shard(a, None, "batch", "seq_kv", None)
        return a

    return tree_map(ann, cache)


def _stacked(one: Params, n: int) -> Params:
    return {k: v[None].expand((n,) + v.shape).clone() for k, v in one.items()}


def init_cache(cfg: ArchConfig, batch: int, context: int, device: Union[str, torch.device, None] = "cuda") -> Params:
    """Stacked (per-layer leading dim) decode cache: zero K/V with every
    position tag -1 (``kv``: the GQA ring, or MLA's latent cache), zero SSM
    and conv state (``ssm``), for the hybrid one K/V ring per shared-block
    invocation (``shared_attn``), and for the encoder-decoder each layer's
    cross-attention K/V over the encoder's frames (``cross_kv``)."""
    dtype, dev = model_dtype(cfg), resolve_device(device)
    L = cfg.n_layers
    cache: Params = {}
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = _stacked(ssm_mod.init_ssm_cache(cfg, batch, dtype, dev), L)
        if cfg.family == "hybrid":
            n_inv = len(shared_layers(cfg))
            cache["shared_attn"] = _stacked(attn.init_kv_cache(cfg, batch, context, dtype, dev), n_inv)
        return cache
    init = attn.init_mla_cache if cfg.attn_kind == "mla" else attn.init_kv_cache
    cache["kv"] = _stacked(init(cfg, batch, context, dtype, dev), L)
    if cfg.is_encdec:
        shape = (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["cross_kv"] = {n: torch.zeros(shape, dtype=dtype, device=dev) for n in ("k", "v")}
    return cache


# ---------------------------------------------------------- prefill / decode
def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: Params) -> Tuple[torch.Tensor, Params]:
    """Process the prompt ``batch["tokens"]`` (B, S) [+ ``prefix`` |
    ``frames``]; returns (logits for the last position (B, 1, V), cache
    filled in place)."""
    _refuse_sharded_zamba2(params, cfg)
    with replicate_plain(params):
        return _prefill(params, cfg, batch, cache)


def _refuse_sharded_zamba2(params: Params, cfg: ArchConfig) -> None:
    if zamba2_layout(cfg) and is_dtensor(params["embed"]):
        raise NotImplementedError(f"{cfg.name}: the zamba2 layout runs on plain tensors, not DTensors")


def _prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: Params) -> Tuple[torch.Tensor, Params]:
    with obs.range("embed"):
        x = _embed_inputs(params, cfg, batch)
    if zamba2_layout(cfg):
        x = _zamba2_layers(params, cfg, x, cache)
        with obs.range("logits"):
            return _logits(params, cfg, x[:, -1:, :]), cache
    enc_out = None
    if cfg.is_encdec:  # the cross K/V, once a request
        enc_out = _encode(params, cfg, batch["frames"])
        ck = cache["cross_kv"]
        for i in range(cfg.n_layers):
            ca = _index(params["cross"], i)["attn"]
            ck["k"][i] = torch.einsum("bsd,dhk->bshk", enc_out, ca["wk"])
            ck["v"][i] = torch.einsum("bsd,dhk->bshk", enc_out, ca["wv"])
    for i in range(cfg.n_layers):
        lp = _index(params["layers"], i)
        with obs.range("mixer"):
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if "ssm" in lp:
                a, _ = ssm_mod.ssm_apply(lp["ssm"], hn, cfg, state=_index(cache["ssm"], i))
            elif cfg.attn_kind == "mla":
                a, _ = attn.mla_prefill(lp["attn"], hn, cfg, _index(cache["kv"], i))
            else:
                a, _ = attn.attention_prefill(lp["attn"], hn, cfg, _index(cache["kv"], i), *_layer_kind(cfg, i))
            x = shard(x + a, "batch", "seq", "embed")  # as the train path: a seq_act mixer hands back its sequence shards
        if enc_out is not None:
            with obs.range("cross"):
                x = x + _cross_attend(_index(params["cross"], i), cfg, x, enc_out)
        if "ln2" in lp:
            with obs.range("channel"):
                x = x + _channel(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
        if "shared_block" in params and i % cfg.attn_every == 0:
            with obs.range("shared_block"):
                x = _shared_block(params["shared_block"], cfg, x, _index(cache["shared_attn"], i // cfg.attn_every))
    with obs.range("logits"):
        return _logits(params, cfg, x[:, -1:, :]), cache


def _channel(lp: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """A layer's channel mixer: the MoE FFN or the dense FFN."""
    if "moe" in lp:
        return moe_mod.moe_apply(lp["moe"], h, cfg)[0]
    return ffn_apply(lp["ffn"], h, gated=cfg.gated_ffn)


def _shared_block(sp: Params, cfg: ArchConfig, x: torch.Tensor, sa: Params, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hybrid's shared attention+MLP block on its cache slice ``sa``:
    prompt attention (``positions`` None) or one decode step."""
    hn = rms_norm(x, sp["ln1"], cfg.norm_eps)
    if positions is None:
        a, _ = attn.attention_prefill(sp["attn"], hn, cfg, sa, cfg.attn_kind, cfg.window)
    else:
        a, _ = attn.attention_decode(sp["attn"], hn, cfg, sa, positions, cfg.attn_kind, cfg.window)
    x = x + a
    return x + ffn_apply(sp["ffn"], rms_norm(x, sp["ln2"], cfg.norm_eps), gated=cfg.gated_ffn)


def _zamba2_layers(params: Params, cfg: ArchConfig, x: torch.Tensor, cache: Params,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The zamba2 layout's layers on the embeddings x0 = ``x``: the prompt
    (``positions`` None) or one decode step.  Before each layer of
    ``hybrid_layer_ids`` (invocation j) the shared block reads (h, x0) and
    its output is added to that Mamba layer's input before the layer's
    norm; the layer's residual is h, without it (transformers'
    ``Zamba2HybridLayer``)."""
    x0 = x
    inv = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    for i in range(cfg.n_layers):
        lp = _index(params["layers"], i)
        u = x
        if i in inv:
            with obs.range("shared_block"):
                u = x + _zamba2_shared(params, cfg, x, x0, inv[i], _index(cache["shared_attn"], inv[i]), positions)
        with obs.range("mixer"):
            hn = rms_norm(u, lp["ln1"], cfg.norm_eps)
            st = _index(cache["ssm"], i)
            if positions is None:
                a, _ = ssm_mod.ssm_apply(lp["ssm"], hn, cfg, state=st)
            else:
                a, _ = ssm_mod.ssm_decode(lp["ssm"], hn, cfg, st)
            x = x + a
    return x


def _zamba2_shared(params: Params, cfg: ArchConfig, h: torch.Tensor, x0: torch.Tensor, j: int, sa: Params,
                   positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Invocation ``j`` of the zamba2 shared block on its cache slice ``sa``
    (transformers' ``Zamba2AttentionDecoderLayer``, then the invocation's
    linear layer): norm of concat(h, x0); attention at head dim hd with
    scores scaled by (hd / 2)^-1/2, RoPE, q/k/v
    adapters where ``use_shared_attention_adapter``; norm; GeGLU with the
    gate-up adapter where ``use_shared_mlp_adapter``; no residual inside."""
    sp, ip = params["shared_block"], _index(params["shared_inv"], j)
    obs.count("shared_block")
    with obs.range("shared.in"):
        hn = rms_norm(torch.cat([h, x0], dim=-1), sp["ln1"], cfg.norm_eps)
    kw = dict(scale=(cfg.resolved_head_dim / 2) ** -0.5, adapter=ip if cfg.use_shared_attention_adapter else None)
    if positions is None:
        a, _ = attn.attention_prefill(sp["attn"], hn, cfg, sa, cfg.attn_kind, cfg.window, **kw)
    else:
        a, _ = attn.attention_decode(sp["attn"], hn, cfg, sa, positions, cfg.attn_kind, cfg.window, **kw)
    with obs.range("shared.mlp"):
        m = rms_norm(a, sp["ln2"], cfg.norm_eps)
        fp, f = sp["ffn"], cfg.d_ff
        gate, up = m @ fp["w_gate"], m @ fp["w_up"]
        if cfg.use_shared_mlp_adapter:
            gu = (m @ ip["ffn_a"]) @ ip["ffn_b"]
            gate, up = gate + gu[..., :f], up + gu[..., f:]
        m = (F.gelu(gate) * up) @ fp["w_down"]
    with obs.range("shared.out"):
        return m @ ip["linear"]


def _cross_decode(cp: Params, cfg: ArchConfig, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention against the cached encoder K/V
    (B, encoder_seq, KV, hd)."""
    b, h, hd = x.shape[0], cfg.n_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", rms_norm(x, cp["ln"], cfg.norm_eps), cp["attn"]["wq"])
    qg = attn._group_heads(q, ck)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, ck).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, cv).reshape(b, 1, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, cp["attn"]["wo"])


# decode_step runs its batch in tiles of this many rows, the last one padded
# with copies of its first row: every op of a step then sees the same shapes
# whatever the batch, so a row's logits and cache do not depend on how many
# rows share the call.  A GEMM's, a reduction's or a batched product's
# kernel (MKL's on the CPU, cuBLAS's and PyTorch's on a card) is chosen by
# its shapes, and at M = 1 and 2 the CPU's gives rows other bits than at
# M = 4 and 8 (tests/test_torch_fleet.py).  8 is the served slot count, so
# a server of 8 slots decodes in one tile, as before.
DECODE_TILE = 8


def decode_step(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,  # (B, 1)
    positions: torch.Tensor,  # (B,) absolute position of the new token
    cache: Params,
) -> Tuple[torch.Tensor, Params]:
    """One token per row; returns (logits (B, 1, V), cache updated in place).
    The rows run in tiles of :data:`DECODE_TILE`; a partial tile is padded
    with copies of its first row on a copy of its cache rows, which are
    written back.  DTensor rows run as one tile: a tile's slice of a
    batch sharded over the mesh would gather the cache."""
    _refuse_sharded_zamba2(params, cfg)
    b = tokens.shape[0]
    if b == DECODE_TILE or is_dtensor(tokens):
        with replicate_plain(params):
            return _decode_tile(params, cfg, tokens, positions, cache), cache
    out = []
    for t0 in range(0, b, DECODE_TILE):
        r = min(DECODE_TILE, b - t0)
        rows = tree_map(lambda t: t[:, t0 : t0 + r], cache)
        tok, pos = tokens[t0 : t0 + r], positions[t0 : t0 + r]
        if r == DECODE_TILE:
            out.append(_decode_tile(params, cfg, tok, pos, rows))
            continue
        tile = tree_map(lambda t: _pad_rows(t, DECODE_TILE, dim=1), rows)
        logits = _decode_tile(params, cfg, _pad_rows(tok, DECODE_TILE), _pad_rows(pos, DECODE_TILE), tile)
        out.append(logits[:r])
        tree_map(lambda dst, src: dst.copy_(src[:, :r]), rows, tile)
    return torch.cat(out), cache


def _pad_rows(t: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """``t`` grown to ``n`` rows along ``dim`` by copies of its first row."""
    shape = list(t.shape)
    shape[dim] = n - t.shape[dim]
    return torch.cat([t, t.narrow(dim, 0, 1).expand(shape)], dim=dim)


def _decode_tile(params: Params, cfg: ArchConfig, tokens: torch.Tensor, positions: torch.Tensor, cache: Params) -> torch.Tensor:
    """:func:`decode_step` on one tile of rows; returns the logits."""
    with obs.range("embed"):
        x = _embed_tokens(params, tokens)
    if zamba2_layout(cfg):
        x = _zamba2_layers(params, cfg, x, cache, positions)
        with obs.range("logits"):
            return _logits(params, cfg, x)
    for i in range(cfg.n_layers):
        lp = _index(params["layers"], i)
        with obs.range("mixer"):
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if "ssm" in lp:
                a, _ = ssm_mod.ssm_decode(lp["ssm"], hn, cfg, _index(cache["ssm"], i))
            elif cfg.attn_kind == "mla":
                a, _ = attn.mla_decode(lp["attn"], hn, cfg, _index(cache["kv"], i), positions)
            else:
                a, _ = attn.attention_decode(lp["attn"], hn, cfg, _index(cache["kv"], i), positions, *_layer_kind(cfg, i))
            x = x + a
        if "cross" in params:
            with obs.range("cross"):
                ck = cache["cross_kv"]
                x = x + _cross_decode(_index(params["cross"], i), cfg, x, ck["k"][i], ck["v"][i])
        if "ln2" in lp:
            with obs.range("channel"):
                x = x + _channel(lp, cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
        if "shared_block" in params and i % cfg.attn_every == 0:
            with obs.range("shared_block"):
                x = _shared_block(params["shared_block"], cfg, x, _index(cache["shared_attn"], i // cfg.attn_every), positions)
    with obs.range("logits"):
        return _logits(params, cfg, x)
