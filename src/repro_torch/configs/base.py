"""Architecture + shape configuration system.

Every assigned architecture is an :class:`ArchConfig` in its own module
(``repro/configs/<id>.py``) exposing ``CONFIG`` (the exact public config)
and ``SMOKE`` (a reduced same-family config for CPU tests).  The registry
(:mod:`repro.configs.registry`) resolves ``--arch <id>`` strings.

Shapes are global (:data:`SHAPES`): each assigned architecture runs the
same four shape cells, with per-family skips resolved by
:func:`cell_is_applicable` (documented in DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "cell_is_applicable", "zamba2_layout", "shared_layers", "ssm_groups"]


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # 'dense' | 'audio' | 'ssm' | 'hybrid' | 'vlm' | 'moe'
    source: str = ""  # provenance note "[arXiv:...; tier]"

    # trunk dimensions
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 → d_model // n_heads

    # attention flavour
    attn_kind: str = "full"  # 'full' | 'swa' | 'chunked' | 'mla'
    window: int = 0  # SWA window / chunk length
    global_every: int = 0  # chunked: every k-th layer is full attention
    qkv_bias: bool = False
    rope_theta: float = 1e4

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64  # SSD chunk length
    ssm_groups: int = 1  # groups of B/C (and of the published Zamba2 mixer norm)
    attn_every: int = 0  # hybrid: shared attention block every k layers

    # hybrid shared block: "residual" is the port's pre-norm residual block
    # on h after every ``attn_every``-th layer; "zamba2" is published Zamba2
    # (arXiv:2411.15242, transformers' modeling_zamba2.py): the block reads
    # concat(h, x0), 2 * d_model wide, runs before each layer of
    # ``hybrid_layer_ids``, has LoRA adapters of ``adapter_rank`` per
    # invocation (on gate-up where ``use_shared_mlp_adapter``, on q/k/v
    # where ``use_shared_attention_adapter``), RoPE, a GeGLU MLP, and a
    # per-invocation linear whose output is added to the next Mamba layer's
    # input; its Mamba layers end in the grouped gated norm.  Every other
    # family ignores these fields.
    hybrid_layout: str = "residual"
    hybrid_layer_ids: Tuple[int, ...] = ()
    adapter_rank: int = 0
    use_shared_mlp_adapter: bool = False
    use_shared_attention_adapter: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed frame count from the (stubbed) frontend

    # modality frontend stub ('none' | 'audio' | 'vision')
    frontend: str = "none"
    n_prefix_tokens: int = 0  # vision: patch tokens prepended to the text

    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    gated_ffn: bool = True  # SwiGLU (3 mats) vs classic GELU (2 mats)
    dtype: str = "bfloat16"

    def __post_init__(self):
        # a configuration file gives the layer ids as a JSON list
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this architecture hold a 500k-token context?  True for SSM,
        hybrid (bounded attention cache), SWA, and chunked attention."""
        return self.has_ssm or self.attn_kind in ("swa", "chunked")

    def param_count(self) -> int:
        """Total parameters (embedding + trunk), for MODEL_FLOPS."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed)."""
        return _param_count(self, active_only=True)

    def variant(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# The port's functions also take the JAX package's ArchConfig (the parity
# tests hand it over), which has none of the fields the port added: read
# those through these functions.
def zamba2_layout(cfg) -> bool:
    """Whether ``cfg`` is a hybrid in published Zamba2's layout."""
    return cfg.family == "hybrid" and getattr(cfg, "hybrid_layout", "residual") == "zamba2"


def shared_layers(cfg) -> Tuple[int, ...]:
    """The layers the hybrid's shared block runs at, in order: after every
    ``attn_every``-th layer, or before each of ``hybrid_layer_ids`` in the
    zamba2 layout."""
    if cfg.family != "hybrid":
        return ()
    if zamba2_layout(cfg):
        return cfg.hybrid_layer_ids
    return tuple(range(0, cfg.n_layers, cfg.attn_every))


def ssm_groups(cfg) -> int:
    return getattr(cfg, "ssm_groups", 1)


def _attn_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        p = d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
        p += d * (cfg.kv_lora_rank + cfg.rope_head_dim)
        p += cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
        p += cfg.n_heads * cfg.v_head_dim * d
        return p
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    mats = 3 if cfg.gated_ffn else 2  # SwiGLU: gate+up+down / GELU: up+down
    return mats * cfg.d_model * d_ff


def _ssm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_heads = d_in // cfg.ssm_head_dim
    n_groups = ssm_groups(cfg)
    conv_dim = d_in + 2 * n_groups * cfg.ssm_state
    p = d * (2 * d_in + 2 * n_groups * cfg.ssm_state + n_heads)  # in_proj
    p += conv_dim * cfg.ssm_conv  # depthwise conv
    p += n_heads * 2  # A_log, D
    p += d_in * d  # out_proj
    return p


def _layer_params(cfg: ArchConfig, layer: int) -> int:
    d = cfg.d_model
    norm = 2 * d
    if cfg.family == "ssm":
        return _ssm_params(cfg) + norm
    if zamba2_layout(cfg):  # in_proj, conv weight and bias, A_log, D, dt_bias, the mixer norm, out_proj, ln1
        d_in, n_heads = cfg.ssm_expand * d, cfg.ssm_expand * d // cfg.ssm_head_dim
        conv_dim = d_in + 2 * ssm_groups(cfg) * cfg.ssm_state
        return d * (d_in + conv_dim + n_heads) + conv_dim * (cfg.ssm_conv + 1) + 3 * n_heads + d_in + d_in * d + d
    if cfg.family == "hybrid":
        # zamba2-style: mamba-only layers; attention+MLP live in the single
        # *shared* block, counted once in _param_count
        return _ssm_params(cfg) + norm
    if cfg.is_moe:
        experts = cfg.n_experts * _ffn_params(cfg, cfg.d_ff)
        shared = cfg.n_shared_experts * _ffn_params(cfg, cfg.d_ff)
        router = d * cfg.n_experts
        return _attn_params(cfg) + experts + shared + router + norm
    return _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + norm


def _zamba2_shared_params(cfg: ArchConfig) -> int:
    """The zamba2 layout's shared block (norms over 2d and d, attention
    from 2d to d, the gated MLP) and, per invocation, its adapters and
    linear layer."""
    d, r, f = cfg.d_model, cfg.adapter_rank, cfg.d_ff
    a = 2 * d
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    block = a + d + a * (h + 2 * kv) * hd + h * hd * d + _ffn_params(cfg, f)
    inv = d * d
    if cfg.use_shared_mlp_adapter:
        inv += r * (d + 2 * f)
    if cfg.use_shared_attention_adapter:
        inv += r * (3 * a + (h + 2 * kv) * hd)
    return block + len(cfg.hybrid_layer_ids) * inv


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head
    n_dec = cfg.n_layers
    for layer in range(n_dec):
        p = _layer_params(cfg, layer)
        if active_only and cfg.is_moe:
            act = (cfg.n_shared_experts + cfg.top_k) * _ffn_params(cfg, cfg.d_ff)
            p = _attn_params(cfg) + act + d * cfg.n_experts + 2 * d
        total += p
    if zamba2_layout(cfg):
        total += _zamba2_shared_params(cfg)
    elif cfg.family == "hybrid" and cfg.attn_every:
        total += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d  # shared block
    if cfg.is_encdec:
        for _ in range(cfg.encoder_layers):
            total += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d
        # decoder cross-attention
        total += cfg.n_layers * (_attn_params(cfg) + d)
    total += d  # final norm
    return total


# ---------------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason) for an (arch × shape) cell — the documented skips."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: 500k KV cache is quadratic-cost/unbounded (assignment rule)"
    return True, ""
