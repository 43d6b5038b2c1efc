"""The port's sharded execution on 4 gloo ranks (CPU): one spawn runs every
check and writes its readings to a temporary directory; the tests below
read them.

* The smoke tinyllama train step, f32, on a 2×2 ("data", "model") mesh
  under ``make_rules``, state placed by ``param_specs`` /
  ``opt_specs(zero=True)``, batch by ``batch_specs``, 3 steps, against the
  port's unsharded step from the same state: loss within 1e-5; every
  gradient leaf (at each step's carried state) within 1e-5; the moments
  within 1e-5; parameters within 0.2 · lr_peak — AdamW's first steps divide
  each gradient by its own size (``m / (sqrt(v) + eps)``), so an element
  whose gradient is within f32 noise of zero (|g| ≈ eps = 1e-8) turns a
  1e-8 difference of summation order into a step of another size (measured
  here: 3.9e-5 = 0.008 · lr_peak with the gradients equal within 2.5e-8),
  the train contract's own bound (tests/test_torch_train.py).  Every leaf keeps its placement;
  the loss falls.  Then the same state against the JAX package's
  unsharded step on the carried weights (loss 1e-5, parameters
  0.2 · lr_peak, the same contract).
* The same with ``n_kv_heads=1``: query heads shard, the kv head
  replicates, and the attention runs through the ``local_map`` wrapper
  around the plain version (each rank hands its heads the kv head they
  read, and the kv gradient is a partial sum over the head shards).
* The ``seq_act`` forward of the reference test's smoke qwen2 and minicpm3
  variants (``n_heads=6``) on a 2×2 mesh: within 2e-4 of the unsharded
  forward, the reference test's tolerance.
* ``gpipe`` on a 4-stage ("pod",) mesh, M=6, B=2, D=16, ``tanh(x @ w)``:
  within 1e-5 of the sequential application, and of the JAX package's.
* A checkpoint saved unsharded by the port and one saved by the JAX
  ``CheckpointManager``, restored with ``shardings`` onto the 2×2 mesh:
  ``full_tensor()`` equal to the saved arrays bit for bit; a ``Trainer``
  under the rules saves a checkpoint whose leaves are the state's
  ``full_tensor()``.

JAX is imported inside the tests only: the spawned ranks import this
module and run no JAX.
"""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import SMOKES
from repro_torch.train import TrainConfig, init_train_state

WORLD = 4
STEPS = 3
LR = 5e-3  # the reference's sharded-train test
ARCH = "tinyllama-1.1b"
SEQ_ACT_ARCHS = ("qwen2-7b", "minicpm3-4b")


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: ``full_tensor()`` of a replicated leaf is the leaf itself,
    which the next step updates in place."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _train_case(rank: int, kv: int, out: Path) -> dict:
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.optim import OptHParams
    from repro_torch.sharding.logical import use_rules
    from repro_torch.sharding.params import batch_specs, distribute_tree, opt_specs, param_specs
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    cfg = SMOKES[ARCH].variant(dtype="float32", n_kv_heads=kv)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh)
    hp = OptHParams(lr_peak=LR, warmup_steps=1, total_steps=8)
    tcfg = TrainConfig()
    plain = init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    toks = torch.randint(0, cfg.vocab_size, (8, 32), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    step = make_train_step(cfg, hp, tcfg)
    rec = {"loss": [], "loss_plain": [], "grad_err": [], "moment_err": [], "param_err": [], "placements_kept": []}
    saved = {}
    with use_rules(rules):
        spec = {"params": param_specs(plain["params"], rules),
                "opt": opt_specs(plain["opt"], plain["params"], rules, zero=True, mesh=mesh), "step": ()}
        state = distribute_tree(init_train_state(torch.Generator().manual_seed(0), cfg, tcfg), mesh, spec)
        placed = distribute_tree(batch, mesh, batch_specs(batch, rules))
        before = [tuple(t.placements) for t in leaves(state)]
        for i in range(STEPS):
            for k, t in _flatten(state):
                saved[f"pre{i}/{k}"] = _np(t.full_tensor())
            _, g_sh = loss_and_grads(state["params"], cfg, placed, tcfg.remat)
            _, g_pl = loss_and_grads(plain["params"], cfg, batch, tcfg.remat)
            rec["grad_err"].append(max(float((a.full_tensor() - b).abs().max()) for a, b in zip(leaves(g_sh), leaves(g_pl))))
            state, met = step(state, placed)
            plain, met_pl = step(plain, batch)
            rec["loss"].append(float(met["loss"]))
            rec["loss_plain"].append(float(met_pl["loss"]))
            full = {k: t.full_tensor() for k, t in _flatten(state)}
            ref = dict(_flatten(plain))
            rec["moment_err"].append(max(float((full[k] - ref[k]).abs().max()) for k in full if k.startswith("opt/")))
            rec["param_err"].append(max(float((full[k] - ref[k]).abs().max()) for k in full if k.startswith("params/")))
            rec["placements_kept"].append([tuple(t.placements) for t in leaves(state)] == before)
            for k, t in full.items():
                saved[f"post{i}/{k}"] = _np(t)
    if rank == 0:
        np.savez(out / f"train_kv{kv}.npz", tokens=toks.numpy(), **saved)
    return rec


def _seq_act_case() -> dict:
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models import forward_train, init_params
    from repro_torch.sharding.logical import use_rules
    from repro_torch.sharding.params import batch_specs, distribute_tree, param_specs

    mesh = make_test_mesh((2, 2), ("data", "model"))
    errs = {}
    for name in SEQ_ACT_ARCHS:
        cfg = SMOKES[name].variant(dtype="float32", n_heads=6, n_kv_heads=2 if name == "qwen2-7b" else 6)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
        ref, _ = forward_train(params, cfg, {"tokens": toks})  # no mesh: the default path
        rules = make_rules(mesh, overrides={"seq_act": "model", "heads": None, "kv_heads": None})
        with use_rules(rules):
            b = {"tokens": toks}
            sp, _ = forward_train(distribute_tree(params, mesh, param_specs(params, rules)), cfg,
                                  distribute_tree(b, mesh, batch_specs(b, rules)))
        errs[name] = float((sp.full_tensor() - ref).abs().max())
    return errs


def _gpipe_case(rank: int, out: Path) -> dict:
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding.pipeline import gpipe

    n_stages, m, b, d = 4, 6, 2, 16
    mesh = make_test_mesh((4,), ("pod",))
    gen = torch.Generator().manual_seed(0)
    params = torch.randn((n_stages, d, d), generator=gen) * 0.3
    micro = torch.randn((m, b, d), generator=gen)
    got = gpipe(lambda w, x: torch.tanh(x @ w), params, micro, mesh, axis="pod")
    ref = micro
    for s in range(n_stages):
        ref = torch.tanh(ref @ params[s])
    if rank == 0:
        np.savez(out / "gpipe.npz", params=params.numpy(), micro=micro.numpy(), got=got.numpy())
    return {"err": float((got - ref).abs().max())}


def _ckpt_case(rank: int, ckpt_dirs: dict, out: Path) -> dict:
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.optim import OptHParams
    from repro_torch.sharding.logical import use_rules
    from repro_torch.sharding.params import opt_specs, param_specs, tree_shardings
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = SMOKES[ARCH]
    mesh = make_test_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh)
    like = init_train_state(torch.Generator().manual_seed(0), cfg, TrainConfig())
    spec = {"params": param_specs(like["params"], rules),
            "opt": opt_specs(like["opt"], like["params"], rules, zero=True, mesh=mesh), "step": ()}
    shardings = tree_shardings(mesh, spec, like)
    rec = {}
    for who, d in ckpt_dirs.items():
        state, step = CheckpointManager(d).restore(like, shardings=shardings)
        saved = json.loads((Path(d) / f"step_{step}" / "manifest.json").read_text())["leaves"]
        same, placed = True, True
        for (key, t), (_, sh) in zip(_flatten(state), _flatten(shardings)):
            want = np.load(Path(d) / f"step_{step}" / saved[key]["file"])
            full = t.full_tensor()
            same &= np.array_equal(_bits(full).numpy(), want.view(np.int16) if saved[key]["dtype"] == "bfloat16" else want)
            placed &= tuple(t.placements) == tuple(sh.placements)
        rec[who] = {"bits_equal": bool(same), "placed": bool(placed), "step": step}
    # a Trainer under the rules: its state placed, its checkpoint the state's full tensors (rank 0 writes)
    run_dir = out / "trainer_ckpt"
    with use_rules(rules):
        tr = Trainer(cfg, OptHParams(lr_peak=LR, warmup_steps=1, total_steps=2), TrainConfig(),
                     TrainerConfig(batch=4, seq=16, steps=2, ckpt_dir=str(run_dir), ckpt_every=1, log_every=100),
                     device="cpu")
        tr.train()
    full = {k: t.full_tensor() for k, t in _flatten(tr.state)}
    man = json.loads((run_dir / "step_2" / "manifest.json").read_text())["leaves"] if rank == 0 else {}
    rec["trainer"] = {
        "all_dtensor": all(hasattr(t, "placements") for _, t in _flatten(tr.state)),
        "saved_equal": rank != 0 or all(
            np.array_equal(_bits(full[k]).numpy(), np.load(run_dir / "step_2" / e["file"]).view(np.int16)
                           if e["dtype"] == "bfloat16" else np.load(run_dir / "step_2" / e["file"]))
            for k, e in man.items()),
    }
    return rec


def _worker(rank: int, world: int, store: str, out: str, ckpt_dirs: dict) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    torch.set_num_threads(1)
    out = Path(out)
    try:
        res = {f"train_kv{kv}": _train_case(rank, kv, out) for kv in (2, 1)}
        res["seq_act"] = _seq_act_case()
        res["gpipe"] = _gpipe_case(rank, out)
        res["ckpt"] = _ckpt_case(rank, ckpt_dirs, out)
        if rank == 0:
            (out / "results.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Saves the two checkpoints, spawns the 4 ranks once, returns
    (results, output directory)."""
    import jax

    from repro.checkpoint import CheckpointManager as JManager
    from repro.configs import SMOKES as J_SMOKES
    from repro.train import TrainConfig as JTC
    from repro.train import init_train_state as j_init_state

    out = tmp_path_factory.mktemp("gloo")
    cfg = SMOKES[ARCH]
    port_state = init_train_state(torch.Generator().manual_seed(3), cfg, TrainConfig())
    CheckpointManager(str(out / "ckpt_port")).save(port_state, 5)
    j_state = j_init_state(jax.random.PRNGKey(4), J_SMOKES[ARCH], JTC())
    JManager(str(out / "ckpt_jax")).save(j_state, 7, wait=True)
    store = tempfile.mktemp(prefix="gloo_store_", dir=str(out))
    mp.spawn(_worker, args=(WORLD, store, str(out), {"port": str(out / "ckpt_port"), "jax": str(out / "ckpt_jax")}),
             nprocs=WORLD)
    return json.loads((out / "results.json").read_text()), out


@pytest.mark.parametrize("kv", [2, 1], ids=["kv_sharded", "kv_replicated"])
def test_sharded_train_matches_unsharded(run, kv):
    rec = run[0][f"train_kv{kv}"]
    for i in range(STEPS):
        assert abs(rec["loss"][i] - rec["loss_plain"][i]) < 1e-5, (i, rec)
        assert rec["grad_err"][i] < 1e-5, (i, rec)
        assert rec["moment_err"][i] < 1e-5, (i, rec)
        assert rec["param_err"][i] < 0.2 * LR, (i, rec)


@pytest.mark.parametrize("kv", [2, 1], ids=["kv_sharded", "kv_replicated"])
def test_sharded_train_keeps_placements_and_learns(run, kv):
    rec = run[0][f"train_kv{kv}"]
    assert all(rec["placements_kept"]), rec
    assert rec["loss"][-1] < rec["loss"][0], rec["loss"]


@pytest.mark.parametrize("kv", [2, 1], ids=["kv_sharded", "kv_replicated"])
def test_sharded_train_within_jax_contract(run, kv, monkeypatch):
    """Each sharded step against the JAX package's unsharded step from the
    same carried state: loss 1e-5, parameters 0.2 · lr_peak."""
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    import jax
    import jax.numpy as jnp

    from repro.configs import SMOKES as J_SMOKES
    from repro.optim import OptHParams as JHP
    from repro.train import TrainConfig as JTC
    from repro.train import init_train_state as j_init_state
    from repro.train import make_train_step as j_make_step

    rec = run[0][f"train_kv{kv}"]
    saved = np.load(run[1] / f"train_kv{kv}.npz")
    jcfg = J_SMOKES[ARCH].variant(dtype="float32", n_kv_heads=kv)
    like = j_init_state(jax.random.PRNGKey(0), jcfg, JTC())
    toks = jnp.asarray(saved["tokens"], jnp.int32)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    step = jax.jit(j_make_step(jcfg, JHP(lr_peak=LR, warmup_steps=1, total_steps=8), JTC()))

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

    for i in range(STEPS):
        state = jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(saved[f"pre{i}/{key(p)}"], a.dtype), like)
        new, met = step(state, batch)
        assert abs(float(met["loss"]) - rec["loss"][i]) < 1e-5, (i, float(met["loss"]), rec["loss"][i])
        errs = jax.tree_util.tree_map_with_path(
            lambda p, a: float(np.max(np.abs(np.asarray(a, np.float32) - saved[f"post{i}/params/{key(p)}"]))), new["params"])
        assert max(jax.tree.leaves(errs)) < 0.2 * LR, (i, errs)


@pytest.mark.parametrize("name", SEQ_ACT_ARCHS)
def test_seq_act_forward_matches_default(run, name):
    assert run[0]["seq_act"][name] < 2e-4, run[0]["seq_act"]


def test_gpipe_matches_sequential(run):
    assert run[0]["gpipe"]["err"] < 1e-5, run[0]["gpipe"]


def test_gpipe_matches_jax_sequential(run):
    import jax.numpy as jnp

    g = np.load(run[1] / "gpipe.npz")
    ref = jnp.asarray(g["micro"])
    for s in range(g["params"].shape[0]):
        ref = jnp.tanh(ref @ jnp.asarray(g["params"][s]))
    assert float(np.max(np.abs(np.asarray(ref) - g["got"]))) < 1e-5


@pytest.mark.parametrize("who", ["port", "jax"])
def test_restore_with_shardings_is_bit_for_bit(run, who):
    rec = run[0]["ckpt"][who]
    assert rec["bits_equal"] and rec["placed"], rec


def test_trainer_under_rules_places_and_saves_full_tensors(run):
    rec = run[0]["ckpt"]["trainer"]
    assert rec["all_dtensor"] and rec["saved_equal"], rec
