"""Plain float32 reference of published Zamba2 (zamba2-1.2b).

The layer equations of transformers' Zamba2 (``modeling_zamba2.py``:
``Zamba2MambaDecoderLayer``, ``Zamba2HybridLayer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``, ``Zamba2RMSNormGated``),
written here in plain torch; imports nothing of the port.

* x0 is the embedding output; h starts as x0.
* Before each layer of ``hybrid_layer_ids`` (invocation j) the one shared
  block reads concat(h, x0) (width 2 * d_model): RMS norm; causal
  attention at head dim hd with q/k/v adapters (rank ``adapter_rank``)
  where ``use_shared_attention_adapter``, RoPE (published mem RoPE),
  scores scaled by (hd / 2)^-1/2, out to d_model; RMS norm; a GeGLU MLP
  whose gate-up product has its adapter where ``use_shared_mlp_adapter``.
  No residual inside.  Invocation j's linear layer maps the block's output,
  which is added to the Mamba layer's input before that layer's norm.
* Every layer is a Mamba2 mixer on norm(input) with h as its residual:
  in_proj to [z, x, B, C, dt], a causal depthwise conv with SiLU over
  [x, B, C], dt = softplus(dt + dt_bias), the SSD scan in plain chunked
  form (chunks of the published 256, the recurrence across chunks), the
  D skip, the grouped gated norm (y * silu(z) over groups of
  d_in / ``ssm_groups``), out_proj.
* The head is the embedding (tied) after the final norm.

The sequences run one layer at a time over every request, each layer's
weights converted to float32 once.  The parameter tree (:func:`layout`) is
the port's input format for this layout, and the products a token
(:func:`per_token_flops`, :func:`attention_calls`,
:func:`attention_score_flops`) sit beside the forward pass that reads them.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .common import layer, linear, normal, ones, rms_norm, rope, served_positions, to_f32

CHUNK = 256  # the published SSD chunk (the port scans in chunks of 64)


def _dims(cfg):
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    heads = d_in // cfg["ssm_head_dim"]
    gn = cfg["ssm_groups"] * cfg["ssm_state"]
    return d_in, heads, gn, d_in + 2 * gn


def _const(shape, value, dtype="model"):
    return (tuple(shape), dtype, ("const", value))


def layout(cfg):
    """The Mamba layers stacked on a leading L; the shared block once; each
    invocation's linear layer and adapters stacked on a leading
    ``len(hybrid_layer_ids)``.  No ``lm_head``: the head is the embedding.
    The embedding is drawn at scale 1/sqrt(d) (the tied head then gives
    logits of unit scale); A_log at scale 1/2 around 0 (A = -exp(A_log)),
    dt_bias at softplus^-1(0.01), D at 1."""
    d, L, r, f = cfg["d_model"], cfg["n_layers"], cfg["adapter_rank"], cfg["d_ff"]
    a = 2 * d
    h, kv, hd, k = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["ssm_conv"]
    d_in, heads, gn, conv_dim = _dims(cfg)
    n = len(cfg["hybrid_layer_ids"])
    ssm = {
        "in_proj": normal((L, d, d_in + conv_dim + heads), d),
        "conv_w": normal((L, k, conv_dim), k), "conv_b": _const((L, conv_dim), 0.0),
        "A_log": normal((L, heads), 4, "float32"), "D": _const((L, heads), 1.0, "float32"),
        "dt_bias": _const((L, heads), math.log(math.expm1(0.01)), "float32"),
        "norm_w": ones((L, d_in)), "out_proj": normal((L, d_in, d), d_in),
    }
    inv = {"linear": normal((n, d, d), d)}
    if cfg["use_shared_mlp_adapter"]:
        inv.update(ffn_a=normal((n, d, r), d), ffn_b=normal((n, r, 2 * f), r))
    if cfg["use_shared_attention_adapter"]:
        for name, hh in (("q", h), ("k", kv), ("v", kv)):
            inv[f"{name}_a"], inv[f"{name}_b"] = normal((n, a, r), a), normal((n, r, hh, hd), r)
    block = {
        "ln1": ones((a,)),
        "attn": {"wq": normal((a, h, hd), a), "wk": normal((a, kv, hd), a), "wv": normal((a, kv, hd), a),
                 "wo": normal((h, hd, d), h * hd)},
        "ln2": ones((d,)),
        "ffn": {"w_gate": normal((d, f), d), "w_up": normal((d, f), d), "w_down": normal((f, d), f)},
    }
    return {"embed": normal((cfg["vocab_size"], d), d), "ln_f": ones((d,)),
            "layers": {"ln1": ones((L, d)), "ssm": ssm}, "shared_block": block, "shared_inv": inv}


def _shared_flops(cfg) -> float:
    """One invocation of the shared block and its linear layer, a token."""
    d, r, f = cfg["d_model"], cfg["adapter_rank"], cfg["d_ff"]
    a = 2 * d
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    out = 2 * a * (q + 2 * kv) + 2 * q * d  # q, k, v and o projections
    if cfg["use_shared_attention_adapter"]:
        out += 2 * (3 * a * r + r * (q + 2 * kv))
    out += 2 * d * 2 * f + 2 * f * d  # gate-up and down
    if cfg["use_shared_mlp_adapter"]:
        out += 2 * (d * r + r * 2 * f)
    return out + 2 * d * d  # the invocation's linear layer


def _mamba_flops(cfg) -> float:
    """One Mamba layer, a token: in_proj, the depthwise conv, the scan in its
    recurrent form (a multiply-add an element of the state for the update,
    one for the read-out) and out_proj."""
    d = cfg["d_model"]
    d_in, heads, gn, conv_dim = _dims(cfg)
    state = heads * cfg["ssm_head_dim"] * cfg["ssm_state"]
    return 2 * d * (d_in + conv_dim + heads) + 2 * cfg["ssm_conv"] * conv_dim + 2 * 2 * state + 2 * d_in * d


def per_token_flops(cfg) -> float:
    return cfg["n_layers"] * _mamba_flops(cfg) + len(cfg["hybrid_layer_ids"]) * _shared_flops(cfg)


def attention_calls(cfg) -> int:
    return len(cfg["hybrid_layer_ids"])


def attention_score_flops(cfg, pairs: float) -> float:
    """Scores and their product with V at head dim ``head_dim`` (not d/H)."""
    return 4 * cfg["n_heads"] * cfg["head_dim"] * pairs


def _ssd(x, dt, a, b, c, state_len: int = CHUNK):
    """The SSD scan of one sequence in plain chunked form, float32: x (S,H,P),
    dt (S,H), a (H,) negative, b, c (S,H,N) per head.  Within a chunk the
    quadratic form, across chunks the recurrence of the chunk states."""
    s, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((h, p, n), device=x.device)
    ys = []
    for t0 in range(0, s, state_len):
        xc, bc, cc = x[t0:t0 + state_len], b[t0:t0 + state_len], c[t0:t0 + state_len]
        adt = (dt[t0:t0 + state_len] * a).T  # (H, Q)
        cum = torch.cumsum(adt, dim=1)
        q = adt.shape[1]
        seg = cum[:, :, None] - cum[:, None, :]  # (H, Q, Q): sum of a dt over (j, i]
        decay = torch.exp(seg.masked_fill(~torch.ones((q, q), dtype=torch.bool, device=x.device).tril(), -math.inf))
        xd = xc * dt[t0:t0 + state_len, :, None]  # (Q, H, P)
        scores = torch.einsum("ihn,jhn->hij", cc, bc) * decay
        y = torch.einsum("hij,jhp->ihp", scores, xd)
        y = y + torch.einsum("ihn,hpn->ihp", cc, state) * torch.exp(cum).T[:, :, None]
        state = state * torch.exp(cum[:, -1])[:, None, None] + torch.einsum(
            "jhp,jhn->hpn", xd * torch.exp(cum[:, -1:] - cum).T[:, :, None], bc)
        ys.append(y)
    return torch.cat(ys)


def mamba(p, u, cfg, mode: str):
    """The Mamba2 mixer on a normalised sequence u (S, D)."""
    s = u.shape[0]
    d_in, heads, gn, conv_dim = _dims(cfg)
    hp, g, n, k = cfg["ssm_head_dim"], cfg["ssm_groups"], cfg["ssm_state"], cfg["ssm_conv"]
    zxbcdt = linear(u, p["in_proj"], mode)
    z, xbc, dt = zxbcdt[:, :d_in], zxbcdt[:, d_in:d_in + conv_dim], zxbcdt[:, d_in + conv_dim:]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    xbc = F.silu(sum(padded[i:i + s] * p["conv_w"][i] for i in range(k)) + p["conv_b"])
    x = xbc[:, :d_in].view(s, heads, hp)
    b = xbc[:, d_in:d_in + gn].view(s, g, n).repeat_interleave(heads // g, dim=1)
    c = xbc[:, d_in + gn:].view(s, g, n).repeat_interleave(heads // g, dim=1)
    dt = F.softplus(dt + p["dt_bias"])
    y = _ssd(x, dt, -torch.exp(p["A_log"]), b, c) + x * p["D"][:, None]
    y = (y.reshape(s, d_in) * F.silu(z)).view(s, g, d_in // g)
    y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg["norm_eps"])).reshape(s, d_in) * p["norm_w"]
    return linear(y, p["out_proj"], mode)


def shared_attention(p, ip, x, cfg, mode: str):
    """Causal self-attention of the shared block over x (S, 2 * d_model)."""
    s, a = x.shape
    h, kv, hd, r = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["adapter_rank"]
    proj = {}
    for name, heads in (("q", h), ("k", kv), ("v", kv)):
        t = linear(x, p[f"w{name}"].reshape(a, heads * hd), mode)
        if cfg["use_shared_attention_adapter"]:
            t = t + linear(linear(x, ip[f"{name}_a"], mode), ip[f"{name}_b"].reshape(r, heads * hd), mode)
        proj[name] = t.view(s, heads, hd)
    q, k, v = proj["q"], proj["k"], proj["v"]
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    k, v = k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)
    visible = pos[None, :] <= pos[:, None]
    out = torch.empty((s, h, hd), device=x.device)
    for h0 in range(0, h, 4):  # a few heads at a time: (4, S, S) scores
        sc = torch.einsum("qhk,shk->hqs", q[:, h0:h0 + 4], k[:, h0:h0 + 4]) / math.sqrt(hd / 2)
        pr = torch.softmax(sc.masked_fill(~visible, -math.inf), dim=-1)
        out[:, h0:h0 + 4] = torch.einsum("hqs,shk->qhk", pr, v[:, h0:h0 + 4])
    return linear(out.reshape(s, h * hd), p["wo"].reshape(h * hd, cfg["d_model"]), mode)


def shared_block(sp, ip, h, x0, cfg, mode: str):
    """Invocation ``ip`` of the shared block on (h, x0), through its linear layer."""
    eps, f = cfg["norm_eps"], cfg["d_ff"]
    att = shared_attention(sp["attn"], ip, rms_norm(torch.cat([h, x0], dim=-1), sp["ln1"], eps), cfg, mode)
    m = rms_norm(att, sp["ln2"], eps)
    gate, up = linear(m, sp["ffn"]["w_gate"], mode), linear(m, sp["ffn"]["w_up"], mode)
    if cfg["use_shared_mlp_adapter"]:
        gu = linear(linear(m, ip["ffn_a"], mode), ip["ffn_b"], mode)
        gate, up = gate + gu[:, :f], up + gu[:, f:]
    m = linear(F.gelu(gate) * up, sp["ffn"]["w_down"], mode)
    return linear(m, ip["linear"], mode)


def served_logits(params, cfg, requests: Sequence[Tuple[List[int], List[int]]], mode: str = "f32") -> List[torch.Tensor]:
    """Per request (prompt, served tokens): the logits (T, V) at the
    positions that chose each served token."""
    seqs = served_positions(requests)
    emb = params["embed"]
    x0s = [emb[torch.tensor(ids, device=emb.device)].float() for ids, _, _ in seqs]
    hs = list(x0s)
    sp = to_f32(params["shared_block"])
    inv = {i: j for j, i in enumerate(cfg["hybrid_layer_ids"])}
    for i in range(cfg["n_layers"]):
        lp = layer(params["layers"], i)
        ip = layer(params["shared_inv"], inv[i]) if i in inv else None
        for j, h in enumerate(hs):
            u = h if ip is None else h + shared_block(sp, ip, h, x0s[j], cfg, mode)
            hs[j] = h + mamba(lp["ssm"], rms_norm(u, lp["ln1"], cfg["norm_eps"]), cfg, mode)
        del lp, ip
    head = emb.float()
    return [linear(rms_norm(h[pos], params["ln_f"].float(), cfg["norm_eps"]), head.T, mode)
            for h, (_, _, pos) in zip(hs, seqs)]
