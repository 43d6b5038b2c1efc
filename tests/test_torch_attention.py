"""Port parity: the attention kernel's plain version and GQA attention.

* ``attention_plain`` against the JAX Pallas kernel run in interpret mode
  on the reference's ``FLASH_CASES`` (5e-5 at f32, 4e-2 at bf16), and
  against ``attention_ref`` on a ragged S the TPU kernel cannot take;
* ``_attention_core`` (the CPU q-chunked path), ``attention_prefill`` with
  its ring-cache writes, and ``attention_decode`` against the JAX module,
  on bridged inputs (float32, within 1e-5).

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ref import attention_ref
from repro.models import attention as ja
from repro_torch.configs import SMOKES
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.models import attention as ta

torch.set_num_threads(1)

FLASH_CASES = [
    # (B, S, H, KV, D, causal, window, chunk, dtype, bq, bk): tests/test_kernels.py
    (2, 256, 4, 2, 64, True, 0, 0, "float32", 128, 128),
    (1, 512, 4, 4, 128, True, 0, 0, "float32", 128, 128),
    (2, 256, 8, 2, 64, True, 64, 0, "float32", 128, 128),
    (2, 256, 4, 2, 64, True, 0, 128, "float32", 128, 128),
    (1, 256, 8, 2, 64, False, 0, 0, "float32", 128, 128),
    (1, 256, 4, 2, 128, True, 0, 0, "bfloat16", 128, 128),
    (1, 128, 2, 2, 64, True, 0, 0, "float32", 64, 64),
    (1, 384, 6, 3, 64, True, 128, 0, "float32", 128, 128),
    (2, 128, 2, 1, 32, True, 0, 0, "float32", 64, 64),
]


def _tol(dtype):
    return 5e-5 if dtype == "float32" else 4e-2


def _qkv(b, s, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, s, h, d)).astype(np.float32),
        rng.normal(size=(b, s, kv, d)).astype(np.float32),
        rng.normal(size=(b, s, kv, d)).astype(np.float32),
    )


def _torch(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_plain_matches_pallas_kernel(case):
    b, s, h, kv, d, causal, window, chunk, dtype, bq, bk = case
    q, k, v = _qkv(b, s, h, kv, d)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    j = j_flash(jq, jk, jv, causal=causal, window=window, chunk=chunk,
                block_q=bq, block_k=bk, interpret=True)
    # bf16 inputs: the same bf16 values on both sides
    tq, tk, tv = (_torch(np.asarray(a, np.float32), dtype) for a in (jq, jk, jv))
    t = attention_plain(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    assert t.dtype == tq.dtype and t.shape == (b, s, h, d)
    assert _err(j, t) < _tol(dtype), case


@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 0), (True, 48, 0), (True, 0, 64), (False, 0, 0)])
def test_attention_plain_matches_ref_on_ragged_length(causal, window, chunk):
    q, k, v = _qkv(1, 200, 4, 2, 32, seed=1)
    j = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window, chunk=chunk)
    t = attention_plain(_torch(q), _torch(k), _torch(v), causal=causal, window=window, chunk=chunk)
    assert _err(j, t) < 5e-5


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (_torch(a) for a in _qkv(1, 40, 4, 2, 16, seed=2))
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=True)
    assert torch.equal(out, attention_plain(q, k, v, causal=True))
    assert flash_attention.launches == before


# ------------------------------------------------------------ model attention
def _cfgs(name, **kw):
    return J_SMOKES[name].variant(dtype="float32", **kw), SMOKES[name].variant(dtype="float32", **kw)


def _attn_params(jcfg, seed=0):
    p = ja.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if "bq" in p:  # non-zero biases so the bias path is exercised
        rng = np.random.default_rng(seed)
        p = {k: (jnp.asarray(rng.normal(size=v.shape), jnp.float32) * 0.1 if k.startswith("b") else v) for k, v in p.items()}
    return p, {k: _torch(v) for k, v in p.items()}


@pytest.mark.parametrize(
    "kind,window,sq,q_chunk",
    [("full", 0, 24, 1024), ("full", 0, 32, 8), ("swa", 6, 32, 8), ("chunked", 8, 32, 8), ("bidir", 0, 20, 1024), ("swa", 6, 20, 1024)],
)
def test_attention_core_cpu_path_matches(kind, window, sq, q_chunk, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    q, k, v = _qkv(2, sq, 4, 2, 16, seed=3)
    pos = np.arange(sq, dtype=np.int32)
    j = ja._attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos), kind, window, q_chunk)
    t = ta._attention_core(_torch(q), _torch(k), _torch(v), torch.from_numpy(pos), torch.from_numpy(pos), kind, window, q_chunk)
    assert _err(j, t) < 1e-5


@pytest.mark.parametrize(
    "arch,sq,context",
    [("tinyllama-1.1b", 13, 32), ("tinyllama-1.1b", 40, 32), ("qwen2-7b", 13, 32), ("h2o-danube-3-4b", 21, 64)],
)
def test_attention_prefill_and_ring_cache_match(arch, sq, context):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, sq, jcfg.d_model)).astype(np.float32)
    jc = ja.init_kv_cache(jcfg, 2, context, jnp.float32)
    tc = ta.init_kv_cache(tcfg, 2, context, torch.float32, torch.device("cpu"))
    kind, window = jcfg.attn_kind, jcfg.window
    jout, jc = ja.attention_prefill(jp, jnp.asarray(x), jcfg, jc, kind, window)
    tout, tc2 = ta.attention_prefill(tp, _torch(x), tcfg, tc, kind, window)
    assert tc2 is tc  # written in place
    assert _err(jout, tout) < 1e-5
    for name in ("k", "v"):
        assert _err(jc[name], tc[name]) < 1e-5
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())


def test_cache_write_prefill_rolls_when_prompt_fills_the_ring():
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    slots, s = 8, 13
    rng = np.random.default_rng(5)
    k = rng.normal(size=(1, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, s, 2, 16)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    jc = ja._cache_write_prefill(ja.init_kv_cache(jcfg, 1, slots, jnp.float32), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tc = ta._cache_write_prefill(ta.init_kv_cache(tcfg, 1, slots, torch.float32, torch.device("cpu")), _torch(k), _torch(v), torch.from_numpy(pos))
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    assert sorted(tc["pos"][0].tolist()) == list(range(s - slots, s))
    assert all(p % slots == i for i, p in enumerate(tc["pos"][0].tolist()))  # slot = pos % slots
    assert _err(jc["k"], tc["k"]) == 0.0 and _err(jc["v"], tc["v"]) == 0.0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-7b", "h2o-danube-3-4b"])
def test_attention_decode_matches(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _attn_params(jcfg, seed=1)
    rng = np.random.default_rng(6)
    b, slots = 3, 16
    # a partly filled ring: some slots empty (-1), positions differ per row
    ck = rng.normal(size=(b, slots, jcfg.n_kv_heads, jcfg.resolved_head_dim)).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    cpos = np.full((b, slots), -1, np.int32)
    cpos[0, :5] = np.arange(5)
    cpos[1] = np.where(np.arange(16) < 4, np.arange(16) + 16, np.arange(16))  # wrapped ring
    positions = np.array([5, 20, 0], np.int32)
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    kind, window = jcfg.attn_kind, jcfg.window
    jc = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(cpos)}
    tc = {"k": _torch(ck), "v": _torch(cv), "pos": torch.from_numpy(cpos.copy())}
    jout, jc = ja.attention_decode(jp, jnp.asarray(x), jcfg, jc, jnp.asarray(positions), kind, window)
    tout, tc2 = ta.attention_decode(tp, _torch(x), tcfg, tc, torch.from_numpy(positions), kind, window)
    assert tc2 is tc
    assert _err(jout, tout) < 1e-5
    assert _err(jc["k"], tc["k"]) < 1e-6 and _err(jc["v"], tc["v"]) < 1e-6
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
