"""Port parity: the MLA (``minicpm3-4b``), encoder-decoder
(``whisper-large-v3``), VLM (``internvl2-76b``) and chunked-local MoE with
global layers (``llama4-scout-17b-a16e``) families against the JAX package,
on their f32 smoke configs with JAX-made parameters carried across by
``repro_torch.bridge``; inputs (tokens, the vision prefix, the audio
frames) are made with numpy from a seed.

Tolerances, those of ``tests/test_torch_model.py`` and
``tests/test_torch_train.py`` (which say why):

* prefill and decode logits, and every cache leaf, within 1e-4 (position
  tags exactly); greedy tokens and served streams identical.
* ``forward_train`` logits within 1e-4 and its aux loss within 1e-6;
  ``loss_and_grads`` against ``jax.value_and_grad(loss_fn)``: loss within
  1e-5, every gradient leaf within 1e-4 of the largest |grad|.
* The reference's own self-consistency check (``tests/test_models.py``):
  prefill + one decode step against the train forward within 2e-3 of the
  logit scale (MoE at ``capacity_factor=16``, so no token drops).

The JAX side runs ``REPRO_KERNELS=pallas-interpret`` for serving (a
128-token prompt of the GQA families reaches its Pallas flash kernel,
llama4's with ``chunk=16``), ``xla`` for gradients (its Pallas kernels have
no backward).  MLA has no kernel in either package.  The card's checks are
in ``tests/test_torch_port_rules.py``, a file the card's machine (no JAX)
can import."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import attention as j_attn
from repro.models import decode_step as j_decode
from repro.models import forward_train as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.model import loss_fn as j_loss_fn
from repro.serve import InferenceServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention as attn
from repro_torch.models import decode_step, forward_train, init_cache, init_params, prefill
from repro_torch.optim import OptHParams
from repro_torch.serve import InferenceServer, ServeConfig
from repro_torch.train import TrainConfig
from repro_torch.train.step import loss_and_grads
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

torch.set_num_threads(1)
FAMILIES = ["minicpm3-4b", "whisper-large-v3", "internvl2-76b", "llama4-scout-17b-a16e"]
SERVED = ["minicpm3-4b", "internvl2-76b", "llama4-scout-17b-a16e"]
TOL = 1e-4
CTX = 160


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _spec(a):
    return tuple(a.shape), str(a.dtype).replace("torch.", "")


def _inputs(cfg, rng, b, s, vocab_only=False):
    """(JAX batch, port batch): tokens (b, s), and the family's stub inputs
    (``prefix`` or ``frames``) in f32 unless ``vocab_only``."""
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    extra = {}
    if not vocab_only and cfg.frontend == "vision":
        extra["prefix"] = rng.standard_normal((b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if not vocab_only and cfg.is_encdec:
        extra["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks).long(), **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


def _n_prefix(cfg, batch):
    return cfg.n_prefix_tokens if "prefix" in batch else 0


def _assert_caches_match(jc, tc):
    assert set(jc) == set(tc)
    for key, jv in jc.items():
        if isinstance(jv, dict):
            _assert_caches_match(jv, tc[key])
        elif key == "pos":
            assert np.array_equal(np.asarray(jv), tc[key].numpy())
        else:
            assert _err(jv, tc[key]) <= TOL, key


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    name = request.param
    jcfg = J_SMOKES[name].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, SMOKES[name].variant(dtype="float32"), jp, params_from_jax(_np_tree(jp), "cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_trees_keep_the_jax_layout_and_cross_bit_exact(name):
    """bf16 smokes: ``init_params`` and ``init_cache`` give the JAX trees'
    keys, shapes and dtypes (the encoder, cross-attention, MLA and MoE keys
    included), and JAX-made bf16 weights cross the bridge bit for bit."""
    jcfg, tcfg = J_SMOKES[name], SMOKES[name]
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    tp = init_params(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.map(_spec, tp) == jax.tree.map(_spec, jax.eval_shape(lambda: jp))
    jc = jax.eval_shape(lambda: j_init_cache(jcfg, 3, CTX))
    assert jax.tree.map(_spec, init_cache(tcfg, 3, CTX, "cpu")) == jax.tree.map(_spec, jc)
    crossed = params_from_jax(_np_tree(jp), "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = crossed
        for key in path:
            t = t[key.key]
        assert _spec(t) == (leaf.shape, str(leaf.dtype)), path
        assert np.array_equal(np.asarray(leaf, np.float32), t.float().numpy()), path


@pytest.mark.parametrize("plen", [13, 128])
def test_prefill_and_decode_match(model, plen, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "pallas-interpret")
    jcfg, tcfg, jp, tp = model
    jb, tb = _inputs(jcfg, np.random.default_rng(plen), 2, plen)
    jl, jc = j_prefill(jp, jcfg, jb, j_init_cache(jcfg, 2, CTX))
    tc = init_cache(tcfg, 2, CTX, "cpu")
    tl, tc2 = prefill(tp, tcfg, tb, tc)
    assert tc2 is tc and tl.shape == (2, 1, jcfg.vocab_size)
    assert _err(jl, tl) <= TOL
    _assert_caches_match(jc, tc)
    nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    for step in range(3):  # decode positions count the vision prefix
        pos = np.full((2,), _n_prefix(jcfg, jb) + plen + step, np.int32)
        jl, jc = j_decode(jp, jcfg, jnp.asarray(nxt[:, None]), jnp.asarray(pos), jc)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(nxt[:, None]).long(), torch.from_numpy(pos), tc)
        assert _err(jl, tl) <= TOL, step
        nxt = np.array(jnp.argmax(jl[:, 0], -1), np.int32)
        assert np.array_equal(nxt, tl[:, 0].argmax(-1).numpy())
    _assert_caches_match(jc, tc)


def test_cache_from_jax_continues_decode(model):
    jcfg, tcfg, jp, tp = model
    jb, _ = _inputs(jcfg, np.random.default_rng(5), 1, 9)
    _, jc = j_prefill(jp, jcfg, jb, j_init_cache(jcfg, 1, CTX))
    tc = cache_from_jax(_np_tree(jc), "cpu")
    pos = np.array([_n_prefix(jcfg, jb) + 9], np.int32)
    jl, _ = j_decode(jp, jcfg, jnp.asarray([[5]]), jnp.asarray(pos), jc)
    tl, _ = decode_step(tp, tcfg, torch.tensor([[5]]), torch.from_numpy(pos), tc)
    assert _err(jl, tl) <= TOL


def test_forward_train_matches(model, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    jcfg, tcfg, jp, tp = model
    jb, tb = _inputs(jcfg, np.random.default_rng(3), 2, 24)
    jl, ja = j_forward(jp, jcfg, jb)
    tl, ta = forward_train(tp, tcfg, tb)
    assert tl.shape == jl.shape == (2, _n_prefix(jcfg, jb) + 24, jcfg.vocab_size)
    assert _err(jl, tl) <= TOL
    assert abs(float(ja) - float(ta)) <= 1e-6
    assert (float(ta) > 0) == tcfg.is_moe


def test_loss_and_grads_match(model, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(4)
    jb, tb = _inputs(jcfg, rng, 2, 17)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels[:, -3:] = -1  # a padding tail is excluded from the loss
    jb["tokens"], tb["tokens"] = jb["tokens"][:, :16], tb["tokens"][:, :16]
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    (jl, jm), jg = jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jb), has_aux=True)(jp)
    (tl, tm), tg = loss_and_grads(tp, tcfg, tb)
    assert abs(float(jl) - float(tl)) <= 1e-5
    assert abs(float(jm["aux"]) - float(tm["aux"])) <= 1e-6
    gmax = max(float(np.max(np.abs(np.asarray(g)))) for g in jax.tree.leaves(jg))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], leaves(tg)):
        assert tuple(b.shape) == a.shape, path
        assert float(np.max(np.abs(b.numpy() - np.asarray(a)))) <= 1e-4 * gmax, path
    if tcfg.is_encdec:  # the encoder and the cross-attention are trained
        assert float(tg["encoder"]["attn"]["wq"].abs().max()) > 0
        assert float(tg["cross"]["attn"]["wk"].abs().max()) > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_train_forward(name):
    """The reference's own consistency check, on the port: prefill of
    t0..t_{n-2} and one decode step of t_{n-1} give the train forward's
    logits at those positions."""
    cfg = SMOKES[name].variant(dtype="float32")
    if cfg.is_moe:
        cfg = cfg.variant(capacity_factor=16.0)  # no token drops
    params = init_params(torch.Generator().manual_seed(2), cfg)
    b, s = 2, 17
    _, batch = _inputs(cfg, np.random.default_rng(6), b, s)
    full, _ = forward_train(params, cfg, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    lg_pre, cache = prefill(params, cfg, pre, init_cache(cfg, b, 64, "cpu"))
    npref = _n_prefix(cfg, batch)
    pos = torch.full((b,), s - 1 + npref, dtype=torch.int32)
    lg_dec, _ = decode_step(params, cfg, batch["tokens"][:, -1:], pos, cache)
    scale = float(full.abs().max()) + 1.0
    assert float((lg_pre[:, 0] - full[:, npref + s - 2]).abs().max()) < 2e-3 * scale
    assert float((lg_dec[:, 0] - full[:, npref + s - 1]).abs().max()) < 2e-3 * scale


def test_chunked_attention_is_local():
    """As the reference's test: one chunked layer (no global ones), and a
    token in chunk 0 does not reach position 23 in chunk 2."""
    cfg = SMOKES["llama4-scout-17b-a16e"].variant(dtype="float32", window=8, n_layers=1, global_every=0, n_experts=4)
    params = init_params(torch.Generator().manual_seed(4), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(5))
    lg1, _ = forward_train(params, cfg, {"tokens": toks})
    toks2 = toks.clone()
    toks2[0, 1] = (toks2[0, 1] + 1) % cfg.vocab_size
    lg2, _ = forward_train(params, cfg, {"tokens": toks2})
    assert float((lg1[0, -1] - lg2[0, -1]).abs().max()) < 1e-5
    assert float((lg1[0, 7] - lg2[0, 7]).abs().max()) > 0  # inside chunk 0 it does


def test_global_layers_attend_past_the_chunk():
    """llama4's layer kinds: with ``global_every=2`` layers 1 and 3 attend
    globally, so a chunk-0 token reaches the last position through them;
    the ring cache holds the full context for them."""
    from repro_torch.models.model import _layer_kind

    cfg = SMOKES["llama4-scout-17b-a16e"].variant(dtype="float32", window=8, capacity_factor=16.0)
    assert [_layer_kind(cfg, i) for i in range(4)] == [("chunked", 8), ("full", 0), ("chunked", 8), ("full", 0)]
    assert init_cache(cfg, 1, 40, "cpu")["kv"]["k"].shape[2] == 40
    params = init_params(torch.Generator().manual_seed(4), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(5))
    toks2 = toks.clone()
    toks2[0, 1] = (toks2[0, 1] + 1) % cfg.vocab_size
    lg1, _ = forward_train(params, cfg, {"tokens": toks})
    lg2, _ = forward_train(params, cfg, {"tokens": toks2})
    assert float((lg1[0, -1] - lg2[0, -1]).abs().max()) > 1e-4


def test_mla_decode_past_the_context_writes_nothing():
    """The reference writes a decode step's latent with a one-hot over
    slots, so a position at or past the context writes nothing; the port's
    indexed write does the same, and raises for none of them."""
    jcfg = J_SMOKES["minicpm3-4b"].variant(dtype="float32")
    tcfg = SMOKES["minicpm3-4b"].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = params_from_jax(_np_tree(jl), "cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    jc = j_attn.init_mla_cache(jcfg, 3, 8, jnp.float32)
    jc = {k: (v.at[:, :5].set(jnp.asarray(rng.standard_normal(v[:, :5].shape), v.dtype)) if k != "pos"
              else v.at[:, :5].set(jnp.arange(5))) for k, v in jc.items()}
    tc = cache_from_jax(_np_tree(jc), "cpu")
    pos = np.array([8, 5, 11], np.int32)  # at the context, inside it, past it
    jo, jc2 = j_attn.mla_decode(jl, jnp.asarray(x), jcfg, jc, jnp.asarray(pos))
    to, tc2 = attn.mla_decode(tl, torch.from_numpy(x), tcfg, tc, torch.from_numpy(pos))
    assert _err(jo, to) <= TOL
    _assert_caches_match(jc2, tc2)
    assert int(tc2["pos"][0].max()) == 4 and int(tc2["pos"][1, 5]) == 5 and int(tc2["pos"][2].max()) == 4


def test_cross_attention_takes_the_plain_path():
    """Cross-attention (queries and keys of different lengths) is routed to
    the plain path by a test on the shapes, on any device; on the CPU it
    equals the reference's ``_attention_core`` and launches nothing."""
    class Fake:
        def __init__(self, cuda, s):
            self.is_cuda, self.shape = cuda, (1, s, 2, 16)

    assert attn._kernel_route(Fake(True, 12), Fake(True, 12))
    assert not attn._kernel_route(Fake(True, 12), Fake(True, 32))  # cross-attention
    assert not attn._kernel_route(Fake(False, 12), Fake(False, 12))  # the CPU
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 12, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    jo = j_attn._attention_core(*(jnp.asarray(a) for a in (q, k, v)), jnp.arange(12), jnp.arange(32), "bidir", 0)
    before = flash_attention.launches
    to = attn._attention_core(*(torch.from_numpy(a) for a in (q, k, v)), torch.arange(12), torch.arange(32), "bidir", 0)
    assert flash_attention.launches == before
    assert _err(jo, to) <= 5e-5


def _serve(server, trace):
    reqs = [server.submit(p, max_new=m) for p, m in trace]
    server.run_until_idle()
    assert all(r.done_event.is_set() for r in reqs)
    return [r.out_tokens for r in reqs]


_rng = np.random.default_rng(17)
TRACE = [
    ([1, 2, 3], 4),
    (_rng.integers(0, 256, size=128).tolist(), 4),  # the Pallas route on the JAX side
    ([6, 7, 8, 9, 10, 11, 12, 13, 14], 5),
    (_rng.integers(0, 256, size=40).tolist(), 3),  # past llama4's 16-token chunk
    ([2, 2], 4),
]


@pytest.mark.parametrize("prefill_chunk", [0, 16])
@pytest.mark.parametrize("name", SERVED)
def test_served_streams_match_the_jax_server(name, prefill_chunk, monkeypatch):
    """The three servable families, text only, through 2 slots (recycled),
    on both transports, single-shot and chunked prefill."""
    monkeypatch.setenv("REPRO_KERNELS", "pallas-interpret")
    jcfg = J_SMOKES[name].variant(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(_np_tree(jp), "cpu")
    tcfg = SMOKES[name].variant(dtype="float32")
    kw = dict(slots=2, context=CTX, max_prefill=128, prefill_chunk=prefill_chunk)
    want = _serve(JServer(jcfg, jp, JServeConfig(transport="inline", **kw)), TRACE)
    for transport in ("inline", "collective"):
        server = InferenceServer(tcfg, tp, ServeConfig(transport=transport, **kw))
        assert _serve(server, TRACE) == want, transport
        assert server.core.prefill_calls == (0 if prefill_chunk else len(TRACE))


def test_the_server_refuses_an_encoder_decoder():
    """A request is tokens only, as the reference's DecodeCore builds its
    prefill batch: whisper is refused by the server and the launcher, with
    a message that says so."""
    cfg = SMOKES["whisper-large-v3"].variant(dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    for make in (lambda: InferenceServer(cfg, params, ServeConfig(transport="inline")),
                 lambda: serve_main(["--arch", "whisper-large-v3", "--device", "cpu", "--requests", "1"])):
        with pytest.raises(ValueError, match="prefill batch from the prompt tokens alone"):
            make()


def test_launcher_serves_a_new_family_on_the_cpu(capsys):
    rc = serve_main(["--arch", "llama4-scout-17b-a16e", "--device", "cpu", "--requests", "4", "--clients", "2",
                     "--slots", "2", "--max-new", "3", "--prompt-len", "20"])
    assert rc == 0
    assert "requests=4/4" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["whisper-large-v3", "internvl2-76b"])
def test_trainer_casts_the_frontend_stubs_to_the_model_dtype(name):
    """bf16 smokes: the data pipeline makes ``frames`` / ``prefix`` in f32;
    the trainer hands them to the model in its dtype (as the reference's
    trainer does) and takes 2 CPU steps with a finite loss."""
    cfg = SMOKES[name]
    assert cfg.dtype == "bfloat16"
    trainer = Trainer(cfg, OptHParams(lr_peak=1e-3, warmup_steps=1, total_steps=2),
                      TrainConfig(microbatches=1, remat="none"), TrainerConfig(batch=2, seq=16, steps=2, log_every=1),
                      device="cpu")
    batch = trainer._to_device(trainer_batch(cfg))
    key = "frames" if cfg.is_encdec else "prefix"
    assert batch[key].dtype == torch.bfloat16 and batch["tokens"].dtype == torch.long
    summary = trainer.train()
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert not any(t.is_alive() for t in trainer.executor._threads)


def trainer_batch(cfg):
    from repro_torch.data import SyntheticLM

    return SyntheticLM(cfg, 2, 16, seed=0).make_batch(0)
