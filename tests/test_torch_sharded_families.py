"""Every model family's sharded execution on 4 gloo ranks (CPU), held
against the unsharded run, and the DTensor ops it dispatches held against
what the card's PyTorch can propagate.

One spawn of 4 ranks (a 2×2 ("data", "model") mesh) runs, for the smoke
configs of deepseek-moe-16b, llama4-scout-17b-a16e, mamba2-130m,
zamba2-1.2b, minicpm3-4b (under ``seq_act``: the reference's sequence-
parallel attention, heads replicated), whisper-large-v3 and internvl2-76b
(with its prefix), all in f32, the weights made by the JAX package and
carried across by ``repro_torch.bridge``:

* (a) two train steps under ``make_rules``, the state placed by
  ``param_specs`` / ``opt_specs(zero=True)`` and the batch by
  ``batch_specs``, against the port's unsharded steps from the same
  state: loss, every gradient leaf and the moments within 1e-5, the
  parameters within 0.2 · lr_peak (the train contract, see
  ``tests/test_torch_sharded_gloo.py``), the MoE families' expert ids
  equal to the unsharded run's, every leaf's placement kept;
* (b) a ``prefill`` and 3 greedy ``decode_step``s under the serving rules
  (``seq_kv`` on "model", the cache placed by ``cache_specs``; whisper
  with its frames through the model API): logits within 1e-5 of max
  |logit| of the unsharded run, greedy tokens equal;
* (c) for deepseek-moe-16b and mamba2-130m, each sharded step against
  the JAX package's unsharded step from the same carried state (loss
  1e-5, parameters 0.2 · lr_peak).

Throughout (a) and (b) :class:`DTensorOpRecorder` (a dispatch mode in this
module: nothing in the port changes) records every aten op dispatched on
a DTensor and fails the run on an op the card's PyTorch has no sharding
strategy for, one it refuses on a 2-D mesh, and a ``view`` that merges or
splits a sharded dim as that release's strict view rule refuses
(:func:`view_refusal`); the lists are ``tools/torch_dtensor_ops.json``,
written on the card by ``tools/torch_dtensor_ops.py``.  The same recorder
runs mamba2's smoke train step on meta tensors on a 1×1 mesh over a
``fake`` group, in a subprocess (the fake group is process-global).

JAX is imported inside the fixtures and tests only: the spawned ranks
import this module and run no JAX.
"""
import collections
import json
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SMOKES

ROOT = Path(__file__).resolve().parent.parent
OPS_FILE = ROOT / "tools" / "torch_dtensor_ops.json"
WORLD = 4
STEPS = 2
DECODE_STEPS = 3
LR = 5e-3
B, S = 4, 16
FAMILIES = ("deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-130m", "zamba2-1.2b", "minicpm3-4b",
            "whisper-large-v3", "internvl2-76b")
TRAIN_OVERRIDES = {"minicpm3-4b": {"seq_act": "model", "heads": None, "kv_heads": None}}
SERVE_OVERRIDES = {"seq_kv": "model"}  # the dry-run's 32k serving cells
JAX_CONTRACT = ("deepseek-moe-16b", "mamba2-130m")
VIEW_OPS = ("aten.view.default", "aten._unsafe_view.default")  # the strict views


def view_refusal(shape, placements, mesh_sizes, size):
    """Why the card's DTensor refuses ``view(size)`` of a tensor of
    ``shape`` placed by ``placements`` on a mesh of ``mesh_sizes``, or
    None.  Its strict view rule: a flattened group may be sharded on its
    first dim only (evenly), and a split dim only through its first piece,
    which the shards must divide."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split, view_groups

    size = [d if d != -1 else -1 for d in size]
    if -1 in size:
        known = int(np.prod([d for d in size if d != -1]))
        size[size.index(-1)] = int(np.prod(shape)) // max(known, 1)
    sharded = {}
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            sharded.setdefault(pl.dim, []).append(m)
    shards = lambda d: int(np.prod([mesh_sizes[m] for m in sharded.get(d, [])]))  # noqa: E731

    def first(cmd):
        if isinstance(cmd, InputDim):
            return cmd.input_dim, None
        if isinstance(cmd, Flatten):
            dims = [d.input_dim for d in cmd.input_dims]
            late = [d for d in dims[1:] if d in sharded]
            if late:
                return None, f"flattens dims {dims} with dim {late[0]} sharded"
            if dims[0] in sharded and shape[dims[0]] % shards(dims[0]):
                return None, f"flattens dims {dims} with dim {dims[0]} sharded unevenly"
            return dims[0], None
        if isinstance(cmd, Split):
            d, why = first(cmd.input_dim)
            if why or d is None:
                return None, why
            if d in sharded and cmd.split_id == 0 and cmd.group_shape[0] % shards(d):
                return None, f"splits sharded dim {d} into {cmd.group_shape}"
            return d, None
        return None, None

    for cmd in view_groups(tuple(shape), tuple(size)):
        _, why = first(cmd)
        if why:
            return why
    return None


class DTensorOpRecorder(TorchDispatchMode):
    """Records every aten op dispatched with a DTensor among its arguments
    (``ops``: name → count) and the faults the card's DTensor would raise
    (``faults``: description → count): an op outside ``allowed``, an op of
    ``refused_2d`` on a mesh of two or more dims, a strict view that
    :func:`view_refusal` refuses, an output DTensor whose placements do
    not cover its mesh."""

    def __init__(self, allowed, refused_2d):
        super().__init__()
        self.allowed, self.refused_2d = set(allowed), set(refused_2d)
        self.ops, self.faults = collections.Counter(), collections.Counter()

    def fault(self, what: str) -> None:
        """Counts ``what`` at the innermost line of the port that led to it."""
        where = next((f"{Path(f.filename).name}:{f.lineno}" for f in reversed(traceback.extract_stack())
                      if "repro_torch" in f.filename), "?")
        self.faults[f"{where}: {what}"] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        dts = [a for a in tree_leaves((args, kwargs)) if isinstance(a, DTensor)]
        if dts:
            name = str(func)
            self.ops[name] += 1
            mesh = dts[0].device_mesh
            if name not in self.allowed:
                self.fault(f"{name}: no sharding strategy")
            elif name in self.refused_2d and mesh.ndim > 1:
                self.fault(f"{name}: refused on a {mesh.ndim}-D mesh")
            if name in VIEW_OPS:
                why = view_refusal(tuple(args[0].shape), args[0].placements, tuple(mesh.shape), list(args[1]))
                if why:
                    self.fault(f"{name} {tuple(args[0].shape)} {args[0].placements} -> {tuple(args[1])}: {why}")
        out = func(*args, **kwargs)
        for o in tree_leaves(out):
            if isinstance(o, DTensor) and len(o.placements) != o.device_mesh.ndim:
                self.fault(f"{func}: output placements {o.placements} on a {o.device_mesh.ndim}-D mesh")
        return out


def make_recorder() -> DTensorOpRecorder:
    lists = json.loads(OPS_FILE.read_text())
    return DTensorOpRecorder(lists["ops"], lists["refused_on_2d_mesh"])


def batch_of(cfg, seed: int = 1) -> dict:
    """tokens (B, S) and next-token labels, and the family's f32 stub
    inputs (``prefix`` or ``frames``), from a numpy generator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()), "labels": torch.from_numpy(toks[:, 1:].copy())}
    if cfg.frontend == "vision":
        batch["prefix"] = torch.from_numpy(rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return batch


def _cfg(name):
    return SMOKES[name].variant(dtype="float32")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _max_err(a, b) -> float:
    from repro_torch.tree import leaves

    return max((float((_full(x) - y).abs().max()) for x, y in zip(leaves(a), leaves(b))), default=0.0)


def _train_case(rank: int, name: str, data: Path, rec: DTensorOpRecorder) -> dict:
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models import moe
    from repro_torch.optim import OptHParams
    from repro_torch.sharding.logical import use_rules
    from repro_torch.sharding.params import batch_specs, distribute_tree, opt_specs, param_specs
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    cfg, tcfg = _cfg(name), TrainConfig()
    mesh = make_test_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh, overrides=TRAIN_OVERRIDES.get(name))
    step = make_train_step(cfg, OptHParams(lr_peak=LR, warmup_steps=1, total_steps=8), tcfg)
    batch = batch_of(cfg)
    plain = torch.load(data / f"{name}.pt")
    ids = {"sharded": [], "plain": []}
    route = moe._route

    def recording(p, x, c):  # every MoE layer's expert ids, in layer order
        out = route(p, x, c)
        ids["sharded" if hasattr(out[0], "full_tensor") else "plain"].append(_np(_full(out[0])))
        return out

    moe._route = recording
    res = {"loss": [], "loss_plain": [], "grad_err": [], "moment_err": [], "param_err": [], "placements_kept": []}
    saved = {}
    try:
        with use_rules(rules):
            spec = {"params": param_specs(plain["params"], rules),
                    "opt": opt_specs(plain["opt"], plain["params"], rules, zero=True, mesh=mesh), "step": ()}
            state = distribute_tree(torch.load(data / f"{name}.pt"), mesh, spec)
            placed = distribute_tree(batch, mesh, batch_specs(batch, rules))
            before = [tuple(t.placements) for t in leaves(state)]
            for i in range(STEPS):
                for k, t in _flatten(state):
                    saved[f"pre{i}/{k}"] = _np(t.full_tensor())
                with rec:
                    _, g_sh = loss_and_grads(state["params"], cfg, placed, tcfg.remat)
                _, g_pl = loss_and_grads(plain["params"], cfg, batch, tcfg.remat)
                res["grad_err"].append(_max_err(g_sh, g_pl))
                with rec:
                    state, met = step(state, placed)
                plain, met_pl = step(plain, batch)
                res["loss"].append(float(met["loss"]))
                res["loss_plain"].append(float(met_pl["loss"]))
                full = {k: t.full_tensor() for k, t in _flatten(state)}
                ref = dict(_flatten(plain))
                res["moment_err"].append(max(float((full[k] - ref[k]).abs().max()) for k in full if k.startswith("opt/")))
                res["param_err"].append(max(float((full[k] - ref[k]).abs().max()) for k in full if k.startswith("params/")))
                res["placements_kept"].append([tuple(t.placements) for t in leaves(state)] == before)
                for k, t in full.items():
                    if k.startswith("params/"):
                        saved[f"post{i}/{k}"] = _np(t)
    finally:
        moe._route = route
    res["expert_ids"] = {"n": len(ids["sharded"]),
                         "equal": len(ids["sharded"]) == len(ids["plain"]) and all(
                             np.array_equal(a, b) for a, b in zip(ids["sharded"], ids["plain"]))}
    if rank == 0 and name in JAX_CONTRACT:
        np.savez(data / f"{name}_steps.npz", **saved)
    return res


def _serve_case(name: str, data: Path, rec: DTensorOpRecorder) -> dict:
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.sharding.logical import use_rules
    from repro_torch.sharding.params import batch_specs, cache_specs, distribute_tree, param_specs

    cfg = _cfg(name)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    rules = make_rules(mesh, overrides=SERVE_OVERRIDES)
    params = torch.load(data / f"{name}.pt")["params"]
    prompt = {k: v for k, v in batch_of(cfg, seed=2).items() if k != "labels"}
    start = S + (cfg.n_prefix_tokens if cfg.frontend == "vision" else 0)
    context = start + DECODE_STEPS + 1
    res = {"logit_err": [], "tokens_equal": []}
    with torch.no_grad():
        ref, ref_cache = prefill(params, cfg, prompt, init_cache(cfg, B, context, "cpu"))
        with use_rules(rules):
            sp = distribute_tree(params, mesh, param_specs(params, rules))
            cache = init_cache(cfg, B, context, "cpu")
            cache = distribute_tree(cache, mesh, cache_specs(cache, rules))
            with rec:
                got, cache = prefill(sp, cfg, distribute_tree(prompt, mesh, batch_specs(prompt, rules)), cache)
            for i in range(DECODE_STEPS + 1):
                got = got.full_tensor()
                res["logit_err"].append(float((got - ref).abs().max() / ref.abs().max()))
                tok, tok_ref = got[:, -1].argmax(-1), ref[:, -1].argmax(-1)
                res["tokens_equal"].append(bool(torch.equal(tok, tok_ref)))
                if i == DECODE_STEPS:
                    break
                pos = torch.full((B,), start + i, dtype=torch.int32)
                ref, ref_cache = decode_step(params, cfg, tok_ref[:, None], pos, ref_cache)
                step_in = {"tokens": tok[:, None], "positions": pos}
                step_in = distribute_tree(step_in, mesh, batch_specs(step_in, rules))
                with rec:
                    got, cache = decode_step(sp, cfg, step_in["tokens"], step_in["positions"], cache)
    return res


def _worker(rank: int, world: int, store: str, data: str, families) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    torch.set_num_threads(1)
    data = Path(data)
    rec = make_recorder()
    try:
        res = {name: {"train": _train_case(rank, name, data, rec), "serve": _serve_case(name, data, rec)}
               for name in families}
        res["ops"], res["faults"] = dict(rec.ops), dict(rec.faults)
        if rank == 0:
            (data / "results.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


ONE_BY_ONE = """
import json, sys
sys.path.insert(0, {tests!r})
import torch
from test_torch_sharded_families import make_recorder
from repro_torch.configs import SMOKES
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_rules, make_test_mesh
from repro_torch.launch.specs import META, abstract_params
from repro_torch.sharding.logical import use_rules
from repro_torch.sharding.params import batch_specs, distribute_tree, param_specs
from repro_torch.train.step import loss_and_grads

fake_world(1)
mesh = make_test_mesh((1, 1), ("data", "model"))
rules = make_rules(mesh)
cfg = SMOKES["mamba2-130m"]
rec = make_recorder()
with use_rules(rules):
    params = abstract_params(cfg)
    params = distribute_tree(params, mesh, param_specs(params, rules))
    batch = {{k: torch.empty((2, 16), dtype=torch.long, device=META) for k in ("tokens", "labels")}}
    batch = distribute_tree(batch, mesh, batch_specs(batch, rules))
    with rec:
        (loss, _), grads = loss_and_grads(params, cfg, batch, "dots")
print(json.dumps({{"faults": dict(rec.faults), "ops": len(rec.ops), "loss_shape": list(loss.shape)}}))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Makes each family's f32 train state in JAX, carries it across, spawns
    the 4 ranks once; returns (results, data directory)."""
    import jax

    from repro.configs import SMOKES as J_SMOKES
    from repro.train import TrainConfig as JTC
    from repro.train import init_train_state as j_init_state
    from repro_torch.bridge import train_state_from_jax

    data = tmp_path_factory.mktemp("families")
    for name in FAMILIES:
        js = j_init_state(jax.random.PRNGKey(0), J_SMOKES[name].variant(dtype="float32"), JTC())
        torch.save(train_state_from_jax(jax.tree.map(np.asarray, js), "cpu"), data / f"{name}.pt")
    store = tempfile.mktemp(prefix="gloo_store_", dir=str(data))
    mp.spawn(_worker, args=(WORLD, store, str(data), FAMILIES), nprocs=WORLD)
    return json.loads((data / "results.json").read_text()), data


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_train_matches_unsharded(run, name):
    rec = run[0][name]["train"]
    for i in range(STEPS):
        assert abs(rec["loss"][i] - rec["loss_plain"][i]) < 1e-5, (i, rec)
        assert rec["grad_err"][i] < 1e-5, (i, rec)
        assert rec["moment_err"][i] < 1e-5, (i, rec)
        assert rec["param_err"][i] < 0.2 * LR, (i, rec)


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_train_keeps_placements_and_routing(run, name):
    rec = run[0][name]["train"]
    assert all(rec["placements_kept"]), rec
    if SMOKES[name].is_moe:  # every MoE layer of the sharded forwards, each step's gradient pass and step
        assert rec["expert_ids"]["n"] >= 2 * STEPS * SMOKES[name].n_layers and rec["expert_ids"]["equal"], rec
    else:
        assert rec["expert_ids"]["n"] == 0, rec


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_prefill_and_decode_match_unsharded(run, name):
    rec = run[0][name]["serve"]
    assert len(rec["logit_err"]) == DECODE_STEPS + 1
    assert max(rec["logit_err"]) <= 1e-5, rec
    assert all(rec["tokens_equal"]), rec


def test_dtensor_ops_are_the_cards(run):
    """Every op the sharded families dispatched on DTensors is one the
    card's PyTorch propagates, no view merges or splits a sharded dim as
    it refuses, and no output is misplaced."""
    assert not run[0]["faults"], run[0]["faults"]
    assert len(run[0]["ops"]) > 50 and "aten.mm.default" in run[0]["ops"], run[0]["ops"]


def test_op_list_is_the_cards():
    lists = json.loads(OPS_FILE.read_text())
    assert lists["torch"].startswith("2.11"), lists["torch"]
    assert "aten.view.default" in lists["ops"] and "aten.index_put_.default" not in lists["ops"]


def test_one_by_one_mesh_mamba2_train_places_every_op():
    """mamba2's smoke train step on meta tensors on a 1×1 mesh over a fake
    group: every op one the card's PyTorch propagates on a 2-D mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", ONE_BY_ONE.format(tests=str(ROOT / "tests"))], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ops"] > 20 and out["loss_shape"] == [], out
    assert not out["faults"], out["faults"]


@pytest.mark.parametrize("name", JAX_CONTRACT)
def test_sharded_train_within_jax_contract(run, name, monkeypatch):
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

    rec = run[0][name]["train"]
    saved = np.load(run[1] / f"{name}_steps.npz")
    jcfg = J_SMOKES[name].variant(dtype="float32")
    like = j_init_state(jax.random.PRNGKey(0), jcfg, JTC())
    batch = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64 else v.numpy())
             for k, v in batch_of(_cfg(name)).items()}
    step = jax.jit(j_make_step(jcfg, JHP(lr_peak=LR, warmup_steps=1, total_steps=8), JTC()))

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

    for i in range(STEPS):
        state = jax.tree_util.tree_map_with_path(lambda p, a: jnp.asarray(saved[f"pre{i}/{key(p)}"], a.dtype), like)
        new, met = step(state, batch)
        assert abs(float(met["loss"]) - rec["loss"][i]) < 1e-5, (i, float(met["loss"]), rec["loss"][i])
        errs = jax.tree_util.tree_map_with_path(
            lambda p, a: float(np.max(np.abs(np.asarray(a, np.float32) - saved[f"post{i}/params/{key(p)}"]))), new["params"])
        assert max(jax.tree.leaves(errs)) < 0.2 * LR, (i, errs)
