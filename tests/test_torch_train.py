"""Port parity: the dense train path (``repro_torch.optim``,
``repro_torch.models.model.loss_fn``, ``repro_torch.train``) against the
JAX package, on the f32 smoke config of ``tinyllama-1.1b`` with JAX-made
parameters and states carried across by ``repro_torch.bridge``.

Tolerances, and why:

* ``warmup_cosine``, ``global_norm``, ``adamw_update``: 1e-6 — the same
  f32 formulas; only summation order and scalar rounding differ.
* ``loss_fn``: 1e-5 absolute on a loss near 5.9 (f32 sums over 128 tokens
  in another order); every gradient leaf within 1e-4 of the largest |grad|.
* 3 steps of ``make_train_step``: loss within 1e-5; parameters within
  0.2 · lr_peak.  AdamW's first steps divide each gradient by its own size
  (``m / (sqrt(v) + eps)``), so an element whose gradient is within f32
  noise of zero may take a step of another size or sign in the two
  frameworks (measured: 0.04 · lr_peak over 3 steps); moments within 2e-6.
  Under ``int8_ef`` the reference quantizes inside ``jit``, where XLA may
  rewrite the division by 127 and contract ``g32 - q*scale`` into an fma:
  a knife-edge element may land one bucket away, which moves its EF by one
  bucket (at most twice the leaf's largest |EF|) and its moment by a tenth
  of one — so EF is held per leaf to 2.5 × its max |EF| at few elements
  (``tests/test_torch_grad_sync.py`` holds the compression bit for bit
  against eager JAX).

The JAX side runs ``REPRO_KERNELS=xla`` (its Pallas kernels have no
backward).  The card's check of gradients through the flash-attention
``autograd.Function`` is in ``tests/test_torch_port_rules.py``, a file the
card's machine (no JAX) can import.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models.model import loss_fn as j_loss_fn
from repro.optim import OptHParams as JHP
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import global_norm as j_global_norm
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import TrainConfig as JTC
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.configs import SMOKES
from repro_torch.launch.train import main as train_main
from repro_torch.models import loss_fn
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import OptHParams, adamw_init, adamw_update, global_norm, warmup_cosine
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.step import loss_and_grads
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
ARCH = "tinyllama-1.1b"
LR = 1e-2


@pytest.fixture(autouse=True)
def _xla_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _max_err(j_tree, t_tree) -> float:
    jl, tl = jax.tree.leaves(j_tree), leaves(t_tree)
    assert len(jl) == len(tl)
    return max(float(np.max(np.abs(np.asarray(a, np.float32) - b.float().numpy()), initial=0.0)) for a, b in zip(jl, tl))


def _batch(seed=0, b=4, s=32, vocab=256, masked=False):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:  # a padding tail: labels < 0 are excluded from the loss
        labels[:, -5:] = -1
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(labels).long()}
    return jb, tb


@pytest.fixture(scope="module")
def cfgs():
    return J_SMOKES[ARCH].variant(dtype="float32"), SMOKES[ARCH].variant(dtype="float32")


# ---------------------------------------------------------------- optimizer


def test_warmup_cosine_matches():
    for kw in (dict(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10, total_steps=100), dict(warmup_steps=0, total_steps=10)):
        for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
            j = float(j_warmup_cosine(jnp.asarray(s), JHP(**kw)))
            t = float(warmup_cosine(torch.tensor(s), OptHParams(**kw)))
            assert abs(j - t) <= 1e-6 * max(1.0, abs(j)), (kw, s)
    hp = OptHParams(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10, total_steps=100)
    assert float(warmup_cosine(torch.tensor(0), hp)) == 0.0
    assert abs(float(warmup_cosine(torch.tensor(100), hp)) - 1e-5) < 1e-9


def test_global_norm_matches():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 3)).astype(np.float32), "b": [rng.standard_normal(5).astype(np.float32) * 100]}
    j = float(j_global_norm(jax.tree.map(jnp.asarray, tree)))
    t = float(global_norm(tree_map(_t, tree)))
    assert abs(j - t) <= 1e-6 * j
    assert abs(float(global_norm({"a": torch.ones(3) * 2, "b": torch.ones(4)})) - np.sqrt(16)) < 1e-6


@pytest.mark.parametrize("grad_scale", [1e-3, 100.0])  # under the clip, and clipped
def test_adamw_update_matches(grad_scale):
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    hp_kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    jp, jo = jax.tree.map(jnp.asarray, params), j_adamw_init(jax.tree.map(jnp.asarray, params))
    tp = tree_map(_t, params)
    to = adamw_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * grad_scale).astype(np.float32), params)
        jp, jo, jm = j_adamw_update(jax.tree.map(jnp.asarray, g), jo, jp, JHP(**hp_kw))
        tp2, to2, tm = adamw_update(tree_map(_t, g), to, tp, OptHParams(**hp_kw))
        assert tp2 is tp and to2 is to  # updated in place
        assert _max_err(jp, tp) <= 1e-6 and _max_err(jo["mu"], to["mu"]) <= 1e-6 and _max_err(jo["nu"], to["nu"]) <= 1e-6
        assert int(jo["count"]) == int(to["count"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-6 * max(1.0, abs(float(jm[k])))
    # weight decay reaches matrices only: a zero gradient moves w, not b
    hp = OptHParams(lr_peak=1e-2, warmup_steps=0, total_steps=10)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    adamw_update({"w": torch.zeros(2, 2), "b": torch.zeros(2)}, adamw_init(p), p, hp)
    assert torch.all(p["w"] < 1) and torch.equal(p["b"], torch.ones(2))


# ------------------------------------------------------------ loss and grads


def test_cross_entropy_loss_matches_with_mask():
    from repro.models.layers import cross_entropy_loss as j_xent

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        j = float(j_xent(jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m)))
        t = float(cross_entropy_loss(_t(logits), torch.from_numpy(labels), None if m is None else _t(m)))
        assert abs(j - t) <= 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match(cfgs, masked):
    jcfg, tcfg = cfgs
    jp = j_init_state(jax.random.PRNGKey(0), jcfg)["params"]
    tp = params_from_jax(_np(jp), "cpu")
    jb, tb = _batch(masked=masked, vocab=jcfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jb), has_aux=True)(jp)
    (tl, tm), tg = loss_and_grads(tp, tcfg, tb)
    assert abs(float(jl) - float(tl)) <= 1e-5
    assert set(tm) == {"loss", "xent", "aux"} and float(tm["aux"]) == 0.0
    gmax = max(float(np.max(np.abs(np.asarray(g)))) for g in jax.tree.leaves(jg))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], leaves(tg)):
        assert tuple(b.shape) == a.shape, path
        assert float(np.max(np.abs(b.numpy() - np.asarray(a)))) <= 1e-4 * gmax, path
    assert not any(p.requires_grad for p in leaves(tp))  # the leaves are let go after the backward


@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_grads_equal_across_remat_modes(cfgs, remat):
    _, tcfg = cfgs
    state = init_train_state(torch.Generator().manual_seed(0), tcfg)
    _, tb = _batch(seed=3, vocab=tcfg.vocab_size)
    (l0, _), g0 = loss_and_grads(state["params"], tcfg, tb, "none")
    (l1, _), g1 = loss_and_grads(state["params"], tcfg, tb, remat)
    assert float(l0) == float(l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_bad_remat_and_microbatch_split_raise(cfgs):
    _, tcfg = cfgs
    state = init_train_state(torch.Generator().manual_seed(0), tcfg)
    _, tb = _batch(vocab=tcfg.vocab_size)
    with pytest.raises(ValueError):
        loss_fn(state["params"], tcfg, tb, remat="some")
    with pytest.raises(ValueError):
        make_train_step(tcfg, OptHParams(), TrainConfig(microbatches=3))(state, tb)


# -------------------------------------------------------------- train steps

STEP_CASES = [
    (JTC(microbatches=1, remat="none"), TrainConfig(microbatches=1, remat="none")),
    (JTC(microbatches=2, remat="dots"), TrainConfig(microbatches=2, remat="dots")),
    (JTC(microbatches=1, remat="full", grad_sync="int8_ef"), TrainConfig(microbatches=1, remat="full", grad_sync="int8_ef")),
]


@pytest.mark.parametrize("jtc, ttc", STEP_CASES, ids=["mb1_none", "mb2_dots", "mb1_full_int8_ef"])
def test_three_train_steps_match(cfgs, jtc, ttc):
    jcfg, tcfg = cfgs
    js = j_init_state(jax.random.PRNGKey(0), jcfg, jtc)
    ts = train_state_from_jax(_np(js), "cpu")
    assert ("ef" in ts) == (ttc.grad_sync == "int8_ef")
    jb, tb = _batch(vocab=jcfg.vocab_size)
    hp = dict(lr_peak=LR, warmup_steps=2, total_steps=20)
    jstep, tstep = jax.jit(j_make_step(jcfg, JHP(**hp), jtc)), make_train_step(tcfg, OptHParams(**hp), ttc)
    losses = []
    for step in range(3):
        js, jm = jstep(js, jb)
        ts2, tm = tstep(ts, tb)
        assert ts2 is ts  # the state is updated in place
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5, step
        assert abs(float(jm["loss_mean"]) - float(tm["loss_mean"])) <= 1e-5, step
        assert _max_err(js["params"], ts["params"]) <= 0.2 * LR, step
        assert int(ts["step"]) == step + 1 and int(ts["opt"]["count"]) == step + 1
        if ttc.grad_sync == "int8_ef":
            for a, b in zip(jax.tree.leaves(js["ef"]), leaves(ts["ef"])):
                a = np.asarray(a)
                diff = np.abs(a - b.numpy())
                assert float(diff.max()) <= 2.5 * float(np.abs(a).max()) + 1e-7, step
                assert int(np.count_nonzero(diff > 1e-6)) <= 3 + a.size // 1000, step
        else:
            assert _max_err(js["opt"]["mu"], ts["opt"]["mu"]) <= 2e-6 and _max_err(js["opt"]["nu"], ts["opt"]["nu"]) <= 2e-6
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]


# ----------------------------------------------------------- entry points


def test_train_state_from_jax_carries_every_leaf(cfgs):
    jcfg, _ = cfgs
    js = j_init_state(jax.random.PRNGKey(0), jcfg, JTC(grad_sync="int8_ef"))
    ts = train_state_from_jax(_np(js), "cpu")
    assert set(ts) == {"params", "opt", "step", "ef"} and set(ts["opt"]) == {"mu", "nu", "count"}
    assert _max_err(js, ts) == 0.0
    assert ts["opt"]["count"].dtype == torch.int32 and ts["step"].shape == ()
    with pytest.raises(ValueError):
        train_state_from_jax({"params": {}}, "cpu")


def test_trainer_runs_three_steps_on_the_cpu(tmp_path):
    arch = SMOKES[ARCH]
    trainer = Trainer(arch, OptHParams(lr_peak=1e-2, warmup_steps=1, total_steps=3),
                      TrainConfig(microbatches=1, remat="none", grad_sync="int8_ef"),
                      TrainerConfig(batch=2, seq=16, steps=3, log_every=1), device="cpu")
    summary = trainer.train()
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
    assert [r["step"] for r in trainer.metrics_log] == [0, 1, 2]
    assert int(trainer.state["step"]) == 3 and "ef" in trainer.state
    assert not any(t.is_alive() for t in trainer.executor._threads)
    with_ckpt = Trainer(arch, OptHParams(), run=TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
    assert with_ckpt.ckpt.dir == tmp_path and trainer.ckpt is None  # checkpoint/restart: tests/test_torch_checkpoint.py
    with_ckpt.executor.shutdown()


def test_launcher_trains_on_the_cpu_when_asked(capsys):
    assert train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--grad-sync", "int8_ef", "--grad-pack", "device"]) == 0
    assert "summary:" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="world 256"):  # the production mesh needs its 256-rank group
        train_main(["--arch", ARCH, "--device", "cpu", "--production"])


def test_synthetic_lm_and_prefetching_loader_match_the_reference():
    from repro.core.executor import AMTExecutor as JExecutor
    from repro.data import PrefetchingLoader as JLoader
    from repro.data import SyntheticLM as JSynthetic
    from repro_torch.core.executor import AMTExecutor
    from repro_torch.data import PrefetchingLoader, SyntheticLM

    jcfg, tcfg = J_SMOKES[ARCH], SMOKES[ARCH]
    jex, tex = JExecutor(n_workers=2), AMTExecutor(n_workers=3)
    try:
        jl = JLoader(JSynthetic(jcfg, 3, 17, seed=5), jex, depth=2, start_index=4)
        tl = PrefetchingLoader(SyntheticLM(tcfg, 3, 17, seed=5), tex, depth=2, start_index=4)
        for _ in range(5):  # in order, whichever worker built each batch
            jb, tb = jl.next(), tl.next()
            assert set(jb) == set(tb) == {"tokens", "labels"}
            for k in jb:
                assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k])
    finally:
        jex.shutdown()
        tex.shutdown()
    assert not any(t.is_alive() for t in tex._threads)


def test_amt_executor_runs_tasks_and_reports_errors():
    from repro_torch.core.comm.membership import live_worker_count
    from repro_torch.core.executor import AMTExecutor

    before = live_worker_count()
    ex = AMTExecutor(n_workers=3)
    try:
        futs = [ex.submit(lambda i=i: i * i) for i in range(20)]
        assert [f.result(timeout=10) for f in futs] == [i * i for i in range(20)]
        bad = ex.submit(lambda: 1 // 0)
        with pytest.raises(ZeroDivisionError):
            bad.result(timeout=10)
        assert sum(ex.stats()["executed"]) == 21
    finally:
        ex.shutdown()
    assert live_worker_count() == before
