"""Port parity: the train paths of the SSM (``mamba2-130m``), hybrid
(``zamba2-1.2b``), MoE (``deepseek-moe-16b``), MLA (``minicpm3-4b``),
encoder-decoder (``whisper-large-v3``), VLM (``internvl2-76b``) and
chunked-local MoE (``llama4-scout-17b-a16e``) families against the JAX
package, on their f32 smoke configs with JAX-made parameters and states
carried across by ``repro_torch.bridge``; batches (tokens, and the VLM's
``prefix`` or the encoder's ``frames`` stubs) are made with numpy from a
seed.

Tolerances, those of ``tests/test_torch_train.py`` (which says why):

* ``loss_and_grads`` against ``jax.value_and_grad(loss_fn)``: loss within
  1e-5; every gradient leaf within 1e-4 of the largest |grad|.
* the MoE models: the router's aux loss within 1e-6, and every MoE layer's
  expert choices identical (recorded in both packages in layer order).
* 3 steps of ``make_train_step`` (one microbatch, no remat): loss within
  1e-5 (minicpm3: 5e-5, see ``LOSS_TOL``); parameters within 0.2 · lr_peak; moments within 2e-6, or under
  ``int8_ef`` EF per leaf within 2.5 × its max |EF| at few elements (one
  bucket's move is about twice the leaf's max |EF|).  An element counts as
  moved when it differs by more than 1% of its leaf's max |EF| (at least
  1e-6, the dense test's floor): mamba2's smoke gradients reach a norm of
  17 (tinyllama's about 1), and their f32 noise alone moves hundreds of EF
  elements past 1e-6 by the third step (measured: at most 4.2e-6, against
  bucket moves of 2.6e-3).
* Across the remat modes the port's own loss is equal and its gradients
  within 1e-6.

The JAX side runs ``REPRO_KERNELS=xla`` (its Pallas kernels have no
backward).  The card's checks of the ``autograd.Function``s around the SSD
and grouped-matmul kernels are in ``tests/test_torch_port_rules.py``, a
file the card's machine (no JAX) can import.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import moe as j_moe
from repro.models.model import loss_fn as j_loss_fn
from repro.optim import OptHParams as JHP
from repro.train import TrainConfig as JTC
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.configs import SMOKES
from repro_torch.launch.train import main as train_main
from repro_torch.models import moe
from repro_torch.optim import OptHParams
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.step import loss_and_grads
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves

torch.set_num_threads(1)
ARCHS = ["mamba2-130m", "zamba2-1.2b", "deepseek-moe-16b", "minicpm3-4b", "whisper-large-v3", "internvl2-76b",
         "llama4-scout-17b-a16e"]
LR = 1e-2
# The step loss's tolerance: 1e-5 was set for losses near 5.9 (f32 sums
# over 128 tokens in another order).  minicpm3's smoke (MLA, tied
# embeddings) starts at 45.9 and is 14.9 at the third step, where the same
# relative noise reads 2.9e-5 (measured); held at 5e-5.
LOSS_TOL = {"minicpm3-4b": 5e-5}


@pytest.fixture(autouse=True)
def _xla_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _max_err(j_tree, t_tree) -> float:
    jl, tl = jax.tree.leaves(j_tree), leaves(t_tree)
    assert len(jl) == len(tl)
    return max(float(np.max(np.abs(np.asarray(a, np.float32) - b.float().numpy()), initial=0.0)) for a, b in zip(jl, tl))


def _batch(cfg, seed=0, b=4, s=32):
    """(JAX batch, port batch): tokens and next-token labels, and the
    family's f32 stub inputs (``prefix`` or ``frames``)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(toks[:, 1:]).long()}
    stubs = {}
    if cfg.frontend == "vision":
        stubs["prefix"] = rng.standard_normal((b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        stubs["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    for k, v in stubs.items():
        jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v)
    return jb, tb


def _cfgs(arch):
    return J_SMOKES[arch].variant(dtype="float32"), SMOKES[arch].variant(dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch, monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    jp = j_init_state(jax.random.PRNGKey(0), jcfg)["params"]
    tp = params_from_jax(_np(jp), "cpu")
    jb, tb = _batch(jcfg, seed=1)
    # each MoE layer's expert choices, in layer order, in both packages
    j_choices, t_choices = [], []
    j_route, t_route = j_moe._route, moe._route

    def j_rec(p, x, cfg):
        out = j_route(p, x, cfg)
        jax.debug.callback(lambda e: j_choices.append(np.asarray(e)), out[0], ordered=True)
        return out

    def t_rec(p, x, cfg):
        out = t_route(p, x, cfg)
        t_choices.append(out[0].numpy().copy())
        return out

    monkeypatch.setattr(j_moe, "_route", j_rec)
    monkeypatch.setattr(moe, "_route", t_rec)
    (jl, jm), jg = jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jb), has_aux=True)(jp)
    jax.effects_barrier()
    (tl, tm), tg = loss_and_grads(tp, tcfg, tb)
    assert abs(float(jl) - float(tl)) <= 1e-5
    assert set(tm) == {"loss", "xent", "aux"}
    assert abs(float(jm["aux"]) - float(tm["aux"])) <= 1e-6
    if tcfg.is_moe:
        assert float(tm["aux"]) > 0 and len(t_choices) == tcfg.n_layers
        assert len(j_choices) == len(t_choices)
        for a, b in zip(j_choices, t_choices):
            assert np.array_equal(a, b)
    else:
        assert float(tm["aux"]) == 0.0 and not t_choices
    gmax = max(float(np.max(np.abs(np.asarray(g)))) for g in jax.tree.leaves(jg))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], leaves(tg)):
        assert tuple(b.shape) == a.shape, path
        assert float(np.max(np.abs(b.numpy() - np.asarray(a)))) <= 1e-4 * gmax, path
    if tcfg.family == "hybrid":  # the shared block is trained
        assert float(tg["shared_block"]["attn"]["wq"].abs().max()) > 0
    assert not any(p.requires_grad for p in leaves(tp))


STEP_CASES = [(a, "auto") for a in ARCHS] + [("mamba2-130m", "int8_ef"), ("whisper-large-v3", "int8_ef")]


@pytest.mark.parametrize("arch, grad_sync", STEP_CASES, ids=[f"{a}-{g}" for a, g in STEP_CASES])
def test_three_train_steps_match(arch, grad_sync):
    jcfg, tcfg = _cfgs(arch)
    jtc = JTC(microbatches=1, remat="none", grad_sync=grad_sync)
    ttc = TrainConfig(microbatches=1, remat="none", grad_sync=grad_sync)
    js = j_init_state(jax.random.PRNGKey(0), jcfg, jtc)
    ts = train_state_from_jax(_np(js), "cpu")
    assert ("ef" in ts) == (grad_sync == "int8_ef")
    assert _max_err(js, ts) == 0.0  # every leaf carried: SSM, MoE stacks, shared block, EF
    jb, tb = _batch(jcfg)
    hp = dict(lr_peak=LR, warmup_steps=2, total_steps=20)
    jstep, tstep = jax.jit(j_make_step(jcfg, JHP(**hp), jtc)), make_train_step(tcfg, OptHParams(**hp), ttc)
    losses = []
    for step in range(3):
        js, jm = jstep(js, jb)
        ts2, tm = tstep(ts, tb)
        assert ts2 is ts
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= LOSS_TOL.get(arch, 1e-5), step
        assert abs(float(jm["aux"]) - float(tm["aux"])) <= 1e-6, step
        assert _max_err(js["params"], ts["params"]) <= 0.2 * LR, step
        assert int(ts["step"]) == step + 1
        if grad_sync == "int8_ef":
            for a, b in zip(jax.tree.leaves(js["ef"]), leaves(ts["ef"])):
                a = np.asarray(a)
                diff = np.abs(a - b.numpy())
                assert float(diff.max()) <= 2.5 * float(np.abs(a).max()) + 1e-7, step
                moved = diff > max(1e-6, 1e-2 * float(np.abs(a).max()))
                assert int(np.count_nonzero(moved)) <= 3 + a.size // 1000, step
        else:
            assert _max_err(js["opt"]["mu"], ts["opt"]["mu"]) <= 2e-6 and _max_err(js["opt"]["nu"], ts["opt"]["nu"]) <= 2e-6
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_grads_equal_across_remat_modes(arch, remat):
    _, tcfg = _cfgs(arch)
    params = init_train_state(torch.Generator().manual_seed(0), tcfg)["params"]
    _, tb = _batch(tcfg, seed=3)
    (l0, m0), g0 = loss_and_grads(params, tcfg, tb, "none")
    (l1, m1), g1 = loss_and_grads(params, tcfg, tb, remat)
    assert float(l0) == float(l1) and float(m0["aux"]) == float(m1["aux"])
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_dropped_slots_get_no_gradient():
    """A slot past its expert's capacity writes the spare row, which is cut
    off before the experts: its token's gradient through the queues is 0,
    not the sum of the writes to that row.  At a capacity of 4 most slots
    drop: a token whose every slot dropped gets no gradient (no shared
    expert here; the gates of dropped slots multiply zeros), and dx equals
    the einsum dispatch's, which has no spare row, within 1e-5 of max |dx|
    (f32 sums in another order)."""
    cfg = SMOKES["deepseek-moe-16b"].variant(dtype="float32", n_shared_experts=0, capacity_factor=1e-6)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((1, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    grads = []
    for mode in moe.DISPATCH_MODES:
        xg = x.clone().requires_grad_()
        out, _ = moe.moe_apply(p, xg, cfg, dispatch_mode=mode)
        out.square().sum().backward()
        grads.append(xg.grad)
    assert moe.expert_capacity(32, cfg) == 4
    keep = moe._route(p, x, cfg)[2].reshape(1, cfg.top_k, 32)
    dropped = ~keep.any(dim=1)[0]  # tokens with every slot dropped
    assert 0 < int(dropped.sum()) < 32
    assert torch.all(grads[0][0, dropped] == 0) and torch.any(grads[0][0, ~dropped] != 0)
    gmax = grads[1].abs().max().item()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * gmax


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_and_launcher_train_on_the_cpu(arch, capsys):
    trainer = Trainer(SMOKES[arch], OptHParams(lr_peak=1e-2, warmup_steps=1, total_steps=3),
                      TrainConfig(microbatches=2, remat="full", grad_sync="int8_ef"),
                      TrainerConfig(batch=2, seq=16, steps=3, log_every=1), device="cpu")
    summary = trainer.train()
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
    assert int(trainer.state["step"]) == 3
    assert not any(t.is_alive() for t in trainer.executor._threads)
    assert train_main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]) == 0
    assert "summary:" in capsys.readouterr().out
