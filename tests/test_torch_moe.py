"""Port parity: the MoE family (``repro_torch.models.moe``, the grouped
matmul's plain version, and ``deepseek-moe-16b`` served end to end).

Inputs are made with numpy from a seed and handed to both packages;
JAX-made parameters cross with ``params_from_jax``.  Tolerances:

* grouped matmul: 1e-4 at f32 and 5e-2 at bf16, the reference's own
  (``tests/test_kernels.py``), against the Pallas kernel in interpret mode
  and against ``grouped_matmul_ref``;
* routing: expert ids, positions and the keep mask identical, gates and
  the aux loss within 1e-6;
* ``moe_apply``: 1e-5 at f32, both dispatch modes;
* serving: identical greedy token streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.kernels.moe_gmm import grouped_matmul as j_grouped_matmul
from repro.kernels.ref import grouped_matmul_ref
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.serve import InferenceServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.kernels import expert_ffn_matmul, grouped_matmul, grouped_matmul_plain
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import decode_step, init_cache, init_params, moe
from repro_torch.serve import InferenceServer, ServeConfig

torch.set_num_threads(1)

NAME = "deepseek-moe-16b"

# (E, C, D, F, dtype, block_c, block_f, block_d): the reference's GMM_CASES
GMM_CASES = [
    (4, 256, 512, 384, jnp.float32, 128, 128, 256),
    (2, 128, 128, 128, jnp.float32, 128, 128, 128),
    (8, 128, 256, 128, jnp.bfloat16, 128, 128, 256),
    (1, 512, 1024, 256, jnp.float32, 128, 128, 512),
]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _gmm_inputs(e, c, d, f, dtype, seed):
    """x ~ N(0,1), w ~ 0.05·N(0,1) as in the reference test, in ``dtype``
    on the JAX side and bit for bit the same values on the port's."""
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(rng.standard_normal((e, c, d), np.float32), dtype)
    jw = jnp.asarray(rng.standard_normal((e, d, f), np.float32) * 0.05, dtype)
    t = params_from_jax({"x": np.asarray(jx), "w": np.asarray(jw)}, "cpu")
    return jx, jw, t["x"], t["w"]


@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: "x".join(map(str, c[:4])) + f"-{jnp.dtype(c[4]).name}")
def test_grouped_matmul_plain_matches_the_pallas_kernel(case):
    e, c, d, f, dtype, bc, bf, bd = case
    jx, jw, tx, tw = _gmm_inputs(e, c, d, f, dtype, seed=e + c + d)
    out = grouped_matmul_plain(tx, tw)
    assert out.dtype == tx.dtype and tuple(out.shape) == (e, c, f)
    tol = 1e-4 if dtype == jnp.float32 else 5e-2
    assert _err(j_grouped_matmul(jx, jw, block_c=bc, block_f=bf, block_d=bd, interpret=True), out) < tol
    assert _err(grouped_matmul_ref(jx, jw), out) < tol
    # on a CPU tensor the wrapper and the ops entry point take the plain version
    assert torch.equal(grouped_matmul(tx, tw), out) and torch.equal(expert_ffn_matmul(tx, tw), out)


@pytest.mark.parametrize("case", [
    (3, 120, 176, 1408, jnp.float32),  # deepseek's prefill queue (C=120) and expert width
    (2, 33, 70, 45, jnp.float32),  # nothing divides the TPU's 128 x 128 x 512 blocks
    (2, 33, 70, 45, jnp.bfloat16),
])
def test_grouped_matmul_plain_takes_shapes_the_tpu_blocks_do_not_divide(case):
    e, c, d, f, dtype = case
    jx, jw, tx, tw = _gmm_inputs(e, c, d, f, dtype, seed=c + d)
    assert _err(grouped_matmul_ref(jx, jw), grouped_matmul_plain(tx, tw)) < (1e-4 if dtype == jnp.float32 else 5e-2)


# ------------------------------------------------------------------ the layer
@pytest.fixture(scope="module")
def layer():
    """The deepseek smoke's first MoE layer in f32, from JAX-made params."""
    jcfg = J_SMOKES[NAME].variant(dtype="float32")
    jp = jax.tree.map(lambda a: a[0], j_init_params(jax.random.PRNGKey(3), jcfg)["layers"]["moe"])
    return jcfg, SMOKES[NAME].variant(dtype="float32"), jp, params_from_jax(_np_tree(jp), "cpu")


def _tokens(cfg, b=2, s=64, seed=0):
    """N(0,1) tokens plus one direction they share, which crowds the
    router's choices onto a few experts, so the default capacity drops;
    scaled to unit RMS, as the layer's pre-norm hands them over."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model), np.float32) + 2.0 * rng.standard_normal(cfg.d_model, np.float32)
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_route_matches(layer, capacity_factor):
    jcfg, tcfg, jp, tp = layer
    jcfg, tcfg = jcfg.variant(capacity_factor=capacity_factor), tcfg.variant(capacity_factor=capacity_factor)
    x = _tokens(jcfg)
    je, jpos, jkeep, jg, jcap, jaux = j_moe._route(jp, jnp.asarray(x), jcfg)
    te, tpos, tkeep, tg, tcap, taux = moe._route(tp, torch.from_numpy(x), tcfg)
    assert tcap == jcap
    assert np.array_equal(np.asarray(je), te.numpy())
    assert np.array_equal(np.asarray(jpos), tpos.numpy())
    assert np.array_equal(np.asarray(jkeep), tkeep.numpy())
    assert _err(jg, tg) <= 1e-6 and abs(float(jaux) - float(taux)) <= 1e-6
    # the default capacity drops slots here; a factor of 16 drops none
    assert bool(tkeep.all()) == (capacity_factor == 16.0)


def _one_hot_positions(e_idx, e):
    """The reference's positions: a prefix sum over the one-hot of the
    slot-major ids, the earlier slots on the same expert."""
    assign = (e_idx[..., None] == torch.arange(e)).int()
    return ((torch.cumsum(assign, dim=1) - assign) * assign).sum(-1)


# (B, S, k, E, ids, capacity factor, drops); ids: "spread" top-k of random
# scores, "crowded" the same with a third of the tokens on 3 experts, "one"
# every slot on one expert
POSITION_CASES = {
    "decode-8x6": (8, 1, 6, 64, "spread", 1.25, False),
    "crowded-2x384": (2, 64, 6, 64, "crowded", 16.0, False),
    "prefill-1x9000": (1, 1500, 6, 64, "spread", 16.0, False),
    "longest-1x21504": (1, 3584, 6, 64, "crowded", 16.0, False),
    "one-expert-2x600": (2, 100, 6, 64, "one", 16.0, True),
    "drops-4x6000": (4, 1000, 6, 64, "crowded", 1.0, True),
    "wide-ids-2x300": (2, 100, 3, 300, "crowded", 1.25, True),
}


@pytest.mark.parametrize("case", POSITION_CASES.values(), ids=POSITION_CASES.keys())
def test_positions_equal_the_one_hot_prefix_sum(case):
    """``_assign``'s positions from the stable sort equal the one-hot prefix
    sum integer for integer, and the keep mask is that sum under the
    capacity."""
    b, s, k, e, ids, capacity_factor, drops = case
    cfg = SMOKES[NAME].variant(n_experts=e, top_k=k, capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(b * s + e)
    probs = torch.softmax(torch.randn((b, s, e), generator=gen), dim=-1)
    scores = probs.clone()
    if ids == "crowded":
        scores[..., :3] += (torch.rand((b, s, 1), generator=gen) < 0.35).float()
    gate_idx = torch.topk(scores, k, dim=-1).indices
    if ids == "one":
        gate_idx = torch.full_like(gate_idx, 5)
    e_idx, pos, keep, _, cap, _ = moe._assign(probs, probs.gather(-1, gate_idx), gate_idx, cfg)
    want = _one_hot_positions(e_idx, e)
    assert e_idx.shape == (b, k * s) and pos.dtype == want.dtype == torch.int64
    assert torch.equal(pos, want) and torch.equal(keep, want < cap)
    assert bool(keep.all()) != drops


@pytest.mark.parametrize("dispatch_mode", ["scatter", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_apply_matches(layer, dispatch_mode, capacity_factor):
    jcfg, tcfg, jp, tp = layer
    jcfg, tcfg = jcfg.variant(capacity_factor=capacity_factor), tcfg.variant(capacity_factor=capacity_factor)
    x = _tokens(jcfg, seed=1)
    jo, jaux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg, dispatch_mode=dispatch_mode)
    to, taux = moe.moe_apply(tp, torch.from_numpy(x), tcfg, dispatch_mode=dispatch_mode)
    assert to.shape == (2, 64, jcfg.d_model) and taux.dtype == torch.float32
    assert _err(jo, to) <= 1e-5 and abs(float(jaux) - float(taux)) <= 1e-6


def test_dispatch_modes_agree_and_unknown_mode_raises(layer):
    _, tcfg, _, tp = layer
    x = torch.from_numpy(_tokens(tcfg, seed=2))
    a, _ = moe.moe_apply(tp, x, tcfg, "scatter")
    b, _ = moe.moe_apply(tp, x, tcfg, "einsum")
    assert (a - b).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="dispatch_mode"):
        moe.moe_apply(tp, x, tcfg, "dense")


def test_expert_products_see_one_batch_of_every_row(layer, monkeypatch):
    """Three grouped products per layer, each on an (E, B·C, D) queue."""
    _, tcfg, _, tp = layer
    shapes = []
    real = moe.kops.expert_ffn_matmul
    monkeypatch.setattr(moe.kops, "expert_ffn_matmul", lambda x, w: shapes.append(tuple(x.shape)) or real(x, w))
    moe.moe_apply(tp, torch.from_numpy(_tokens(tcfg, b=3, s=1)), tcfg)
    cap = moe.expert_capacity(1, tcfg)
    assert cap == 4 and shapes == [(tcfg.n_experts, 3 * cap, tcfg.d_model)] * 2 + [(tcfg.n_experts, 3 * cap, tcfg.d_ff)]


def test_batched_rows_are_independent(layer):
    """Routing and capacity are per row: a row's output does not depend on
    the rows batched with it (what ``DecodeCore`` relies on)."""
    _, tcfg, _, tp = layer
    x = torch.from_numpy(_tokens(tcfg, b=4, s=1, seed=5))
    both, _ = moe.moe_apply(tp, x, tcfg)
    for i in range(4):
        alone, _ = moe.moe_apply(tp, x[i : i + 1], tcfg)
        assert (alone[0] - both[i]).abs().max().item() <= 1e-5
    e_all = moe._route(tp, x, tcfg)[0]
    assert all(torch.equal(moe._route(tp, x[i : i + 1], tcfg)[0][0], e_all[i]) for i in range(4))


# ---------------------------------------------------------- trees and bridge
def _spec(a):
    return tuple(a.shape), str(a.dtype).replace("torch.", "")


def test_moe_trees_keep_the_jax_layout():
    """bf16 smoke: every parameter and cache leaf has the JAX shape and
    dtype (the f32 router included)."""
    from repro.models import init_cache as j_init_cache

    jcfg = J_SMOKES[NAME]
    jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    tp = init_params(torch.Generator().manual_seed(0), SMOKES[NAME])
    assert jax.tree.map(_spec, tp) == jax.tree.map(_spec, jp)
    assert "moe" in tp["layers"] and "ffn" not in tp["layers"]
    jc = jax.eval_shape(lambda: j_init_cache(jcfg, 3, 32))
    assert jax.tree.map(_spec, init_cache(SMOKES[NAME], 3, 32, "cpu")) == jax.tree.map(_spec, jc)


def test_bf16_moe_params_cross_bit_exact():
    jp = j_init_params(jax.random.PRNGKey(2), J_SMOKES[NAME])
    tp = params_from_jax(_np_tree(jp), "cpu")
    dtypes = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = tp
        for key in path:
            t = t[key.key]
        assert _spec(t) == (leaf.shape, str(leaf.dtype)), path
        assert np.array_equal(np.asarray(leaf, np.float32), t.float().numpy()), path
        dtypes.add(t.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}
    assert tp["layers"]["moe"]["router"].dtype == torch.float32


def test_init_params_draws_the_same_weights_layer_by_layer():
    """The stacked init fills preallocated leaves one layer at a time; each
    layer holds the draws a fresh generator makes in layer order."""
    cfg = SMOKES[NAME].variant(dtype="float32")
    tp = init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import model as tmodel

    p = {"embed": tmodel.embed_init(gen, cfg.vocab_size, cfg.d_model, torch.float32)}
    tmodel.dense_init(gen, (cfg.vocab_size, cfg.d_model), torch.float32)  # lm_head
    for i in range(cfg.n_layers):
        layer = tmodel._layer_init(gen, cfg, torch.float32)
        assert torch.equal(layer["moe"]["w_gate"], tp["layers"]["moe"]["w_gate"][i])
        assert torch.equal(layer["attn"]["wq"], tp["layers"]["attn"]["wq"][i])
    assert torch.equal(p["embed"], tp["embed"])


# ------------------------------------------------------------------- serving
_rng = np.random.default_rng(11)
TRACE = [
    ([1, 2, 3], 4),
    (_rng.integers(0, 256, size=128).tolist(), 5),
    ([6, 7, 8, 9, 10, 11, 12, 13, 14], 6),
    ([2, 2], 4),
    (_rng.integers(0, 256, size=70).tolist(), 3),
    ([7, 7, 7, 7, 7, 7], 6),
]


def _serve(server):
    reqs = [server.submit(p, max_new=m) for p, m in TRACE]
    server.run_until_idle()
    assert all(r.done_event.is_set() for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def served():
    jcfg = J_SMOKES[NAME].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(4), jcfg)
    return jcfg, SMOKES[NAME].variant(dtype="float32"), jp, params_from_jax(_np_tree(jp), "cpu")


@pytest.mark.parametrize("prefill_chunk", [0, 16])
def test_moe_streams_match_the_jax_server(served, prefill_chunk):
    """6 requests through 2 slots on both transports: every slot is
    recycled, single-shot and chunked prefill."""
    jcfg, tcfg, jp, tp = served
    want = _serve(JServer(jcfg, jp, JServeConfig(slots=2, context=160, max_prefill=128, transport="inline",
                                                 prefill_chunk=prefill_chunk)))
    for transport in ("inline", "collective"):
        server = InferenceServer(tcfg, tp, ServeConfig(slots=2, context=160, max_prefill=128, transport=transport,
                                                       prefill_chunk=prefill_chunk))
        assert _serve(server) == want, transport
        assert server.core.prefill_calls == (0 if prefill_chunk else len(TRACE))


def test_decode_rows_do_not_depend_on_the_batch(served):
    """One decode step of 3 rows equals each row decoded alone."""
    _, tcfg, _, tp = served
    toks, pos = torch.tensor([[5], [9], [200]]), torch.tensor([0, 0, 0], dtype=torch.int32)
    both, _ = decode_step(tp, tcfg, toks, pos, init_cache(tcfg, 3, 16, "cpu"))
    for i in range(3):
        alone, _ = decode_step(tp, tcfg, toks[i : i + 1], pos[i : i + 1], init_cache(tcfg, 1, 16, "cpu"))
        assert (alone[0] - both[i]).abs().max().item() <= 1e-5


def test_launcher_serves_the_moe_model_on_the_cpu(capsys):
    rc = serve_main(["--arch", NAME, "--device", "cpu", "--requests", "4", "--clients", "2", "--slots", "2",
                     "--max-new", "3", "--prompt-len", "20"])
    assert rc == 0
    assert "requests=4/4" in capsys.readouterr().out
