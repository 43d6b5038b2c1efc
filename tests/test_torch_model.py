"""Port parity: the dense, MoE, SSM and hybrid decoders
(``repro_torch.models``) and the bridge.

JAX-made parameters are carried across with ``params_from_jax``, so both
packages compute the same function; prefill and decode logits must agree
within 1e-4 at float32, and so must every cache leaf (position tags
exactly).  The JAX side runs with ``REPRO_KERNELS=pallas-interpret``, so a
128-token prompt goes through the Pallas flash-attention kernel (in
interpret mode) and a 13-token one through its plain path; SSM layers go
through the Pallas SSD kernel at every prompt length.  The MoE layers of
``deepseek-moe-16b`` run the reference's einsum lowering on the JAX side
and the grouped matmul's plain version on the port's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import decode_step as j_decode
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.models import decode_step, init_cache, init_params, prefill

torch.set_num_threads(1)
TOL = 1e-4
CTX = 160


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _assert_caches_match(jc, tc):
    """Every leaf of the JAX cache against the port's: position tags
    exactly, K/V and SSM/conv state within TOL."""
    assert set(jc) == set(tc)
    for key, jv in jc.items():
        if isinstance(jv, dict):
            _assert_caches_match(jv, tc[key])
        elif key == "pos":
            assert np.array_equal(np.asarray(jv), tc[key].numpy())
        else:
            assert _err(jv, tc[key]) <= TOL, key


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "qwen2-7b", "h2o-danube-3-4b", "mamba2-130m", "zamba2-1.2b",
                                                "deepseek-moe-16b"])
def model(request):
    name = request.param
    jcfg = J_SMOKES[name].variant(dtype="float32")
    tcfg = SMOKES[name].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_jax(_np_tree(jp), "cpu")


@pytest.mark.parametrize("plen", [13, 128])
def test_prefill_and_decode_logits_match(model, plen, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "pallas-interpret")
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(plen)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, plen)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, 2, CTX))
    tc = init_cache(tcfg, 2, CTX, "cpu")
    tl, tc2 = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, tc)
    assert tc2 is tc and tl.shape == (2, 1, jcfg.vocab_size)
    assert _err(jl, tl) <= TOL
    _assert_caches_match(jc, tc)
    # three greedy decode steps from the same caches
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    for step in range(3):
        pos = np.full((2,), plen + step, np.int32)
        jl, jc = j_decode(jp, jcfg, jnp.asarray(nxt[:, None]), jnp.asarray(pos), jc)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(nxt[:, None]).long(), torch.from_numpy(pos), tc)
        assert _err(jl, tl) <= TOL, step
        nxt = np.array(jnp.argmax(jl[:, 0], -1), np.int32)
        assert np.array_equal(nxt, tl[:, 0].argmax(-1).numpy())


def test_cache_from_jax_continues_decode(model):
    jcfg, tcfg, jp, tp = model
    toks = np.arange(1, 10, dtype=np.int32)[None]
    _, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, 1, CTX))
    tc = cache_from_jax(_np_tree(jc), "cpu")
    pos = np.array([9], np.int32)
    jl, _ = j_decode(jp, jcfg, jnp.asarray([[5]]), jnp.asarray(pos), jc)
    tl, _ = decode_step(tp, tcfg, torch.tensor([[5]]), torch.from_numpy(pos), tc)
    assert _err(jl, tl) <= TOL


def test_bf16_params_cross_bit_exact():
    jcfg = J_SMOKES["tinyllama-1.1b"]
    assert jcfg.dtype == "bfloat16"
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(_np_tree(jp), "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        assert np.array_equal(np.asarray(leaf, np.float32), t.float().numpy()), path


def test_init_params_keeps_the_jax_tree_layout():
    jcfg = J_SMOKES["qwen2-7b"]
    jshape = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg)))
    tp = init_params(torch.Generator().manual_seed(0), SMOKES["qwen2-7b"])
    tshape = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert tshape == jshape


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_and_hybrid_trees_keep_the_jax_layout(name):
    """bf16 smokes: every parameter and cache leaf has the JAX shape and
    dtype, the f32 leaves (A_log, D, dt_bias) included."""
    jcfg = J_SMOKES[name]
    spec = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))  # noqa: E731
    jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    tp = init_params(torch.Generator().manual_seed(0), SMOKES[name])
    assert jax.tree.map(spec, tp) == jax.tree.map(spec, jp)
    jc = jax.eval_shape(lambda: j_init_cache(jcfg, 3, CTX))
    tc = init_cache(SMOKES[name], 3, CTX, "cpu")
    assert jax.tree.map(spec, tc) == jax.tree.map(spec, jc)


def test_bf16_hybrid_params_cross_bit_exact():
    jcfg = J_SMOKES["zamba2-1.2b"]
    jp = j_init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(_np_tree(jp), "cpu")
    dtypes = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype) and tuple(t.shape) == leaf.shape, path
        assert np.array_equal(np.asarray(leaf, np.float32), t.float().numpy()), path
        dtypes.add(t.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}

