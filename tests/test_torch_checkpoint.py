"""Port parity: checkpoint/restart (``repro_torch.checkpoint``) and the
``RSNP`` snapshot codec against the JAX package's, on smoke configs and
states made from a seed with numpy (or carried across from JAX by
``repro_torch.bridge``).

* The manager keeps the reference's contract (the cases of
  ``tests/test_checkpoint_data.py``): a synchronous round trip, an
  asynchronous save through the executor, atomic commit, keep-k, and a
  restore that rejects a mismatch; and, the port's own, an in-place
  restore and a save that is a snapshot of the state at the call even when
  the state is updated in place right after it.
* Across frameworks, bit for bit: a checkpoint the JAX package writes
  restores into the port's train state equal to ``train_state_from_jax``
  of the same state (bf16 params, f32 moments and EF, int32 step and
  count), and the port's restores into JAX; both write the same manifest
  and the same ``.npy`` bytes.
* Resume across frameworks: a JAX ``Trainer`` runs 2 steps with
  ``ckpt_dir``, the port's ``Trainer`` resumes for 2 more, and a JAX
  ``Trainer`` resumes from the port's checkpoint for 2 more; every loss
  matches an uninterrupted 6-step JAX run's within
  ``tests/test_torch_train.py``'s 1e-5 (f32 smoke config, the same
  tolerance and reason: f32 sums in another order), and the data streams
  resume at the restored step.
* The snapshot: ``pack_state`` gives the same bytes in both packages for a
  decode-cache row and its ``meta``, and ``unpack_state`` reads each
  package's bytes in the other, bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint.snapshot import pack_state as j_pack_state
from repro.checkpoint.snapshot import unpack_state as j_unpack_state
from repro.configs import SMOKES as J_SMOKES
from repro.core.executor import AMTExecutor as JExecutor
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.optim import OptHParams as JHP
from repro.train import TrainConfig as JTC
from repro.train import init_train_state as j_init_state
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.bridge import cache_from_jax, train_state_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.snapshot import pack_state, unpack_state
from repro_torch.configs import SMOKES
from repro_torch.core.executor import AMTExecutor
from repro_torch.launch.train import main as train_main
from repro_torch.optim import OptHParams
from repro_torch.train import TrainConfig, init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
ARCH = "tinyllama-1.1b"
_INT_OF = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float64: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern (floats as ints of their width), so that
    equality is bit equality (-0.0 and NaN payloads included)."""
    return t.view(_INT_OF[t.dtype]) if t.dtype in _INT_OF else t


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def small_state(seed=0):
    """The reference test's small state, made with numpy: f32 and bf16
    params, an f32 moment, int32 count and step, a list and a None."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)),
            "e": torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32)).to(torch.bfloat16),
        },
        "opt": {"mu": {"w": torch.zeros((8, 16))}, "count": torch.zeros((), dtype=torch.int32)},
        "step": torch.tensor(5, dtype=torch.int32),
        "hist": [torch.arange(3, dtype=torch.int32), None, torch.full((2, 2), -0.0)],
    }


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _assert_tree_bits(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits_equal(x, y), (x.dtype, y.dtype, x.shape)


# ------------------------------------------------------ the manager's contract


def test_save_restore_roundtrip_sync(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    state = small_state()
    cm.save(state, step=5)
    like = _zeros_like(state)
    restored, step = cm.restore(like)
    assert step == 5 and restored is like  # restored in place
    _assert_tree_bits(state, restored)
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert manifest["leaves"]["params/e"] == {"file": "params__e.npy", "dtype": "bfloat16", "shape": [32, 8]}
    assert [manifest["leaves"][k]["dtype"] for k in ("opt/count", "step", "hist/0", "hist/2")] == ["int32"] * 3 + ["float32"]
    assert np.load(tmp_path / "step_5" / "params__e.npy").dtype == np.uint16  # bf16 as its bits


def test_async_save_with_executor(tmp_path):
    ex = AMTExecutor(n_workers=2)
    try:
        cm = CheckpointManager(str(tmp_path), executor=ex)
        state = small_state()
        cm.save(state, step=1)
        cm.wait()
        assert cm.latest_step() == 1
        _assert_tree_bits(state, cm.restore(_zeros_like(state))[0])
    finally:
        ex.shutdown()


def test_async_save_is_a_snapshot_of_the_state_at_the_call(tmp_path):
    """The train step updates the state in place as soon as ``save``
    returns; the checkpoint must hold the state as it was at the call (on
    the CPU too, where a host copy is not implied by the transfer)."""
    ex = AMTExecutor(n_workers=2)
    try:
        cm = CheckpointManager(str(tmp_path), executor=ex)
        state = small_state()
        before = tree_map(torch.clone, state)
        cm.save(state, step=1)
        for t in leaves(state):
            t.add_(1)
        cm.wait()
        _assert_tree_bits(before, cm.restore(_zeros_like(state))[0])
    finally:
        ex.shutdown()


def test_atomic_commit_no_partial(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(small_state(), step=2)
    (tmp_path / "step_9.tmp").mkdir()  # a stale tmp dir must never be listed
    assert cm.available_steps() == [2]
    cm.save(small_state(seed=1), step=2)  # a re-save of one step replaces it
    _assert_tree_bits(small_state(seed=1), cm.restore(_zeros_like(small_state()))[0])


def test_keep_k_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(small_state(), step=s)
    assert cm.available_steps() == [3, 4]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(small_state())


@pytest.mark.parametrize("change", ["shape", "dtype", "missing"])
def test_restore_validates_before_it_copies(tmp_path, change):
    cm = CheckpointManager(str(tmp_path))
    cm.save(small_state(), step=1)
    bad = _zeros_like(small_state())
    if change == "shape":
        bad["params"]["w"] = torch.zeros((9, 16))
    elif change == "dtype":
        bad["params"]["e"] = torch.zeros((32, 8))
    else:
        bad["params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError if change == "missing" else ValueError, match="missing" if change == "missing" else change):
        cm.restore(bad)
    assert all(not t.any() for t in leaves(bad))  # nothing was copied


# ------------------------------------------------------------ across frameworks


@pytest.fixture(scope="module")
def jax_state():
    """A bf16 smoke train state under int8_ef (bf16 params; f32 moments
    and EF; int32 count and step), one step in so no moment is zero."""
    cfg = J_SMOKES[ARCH]
    tc = JTC(microbatches=1, remat="none", grad_sync="int8_ef")
    state = j_init_state(jax.random.PRNGKey(0), cfg, tc)
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda a: a + jnp.asarray(rng.standard_normal(a.shape), a.dtype) if a.dtype != jnp.int32 else a + 3,
                         state)
    return cfg, state


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, jax_state):
    cfg, js = jax_state
    JManager(str(tmp_path)).save(js, step=7)
    like = init_train_state(torch.Generator().manual_seed(1), SMOKES[ARCH], TrainConfig(grad_sync="int8_ef"))
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 7
    want = train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    kinds = {t.dtype for t in leaves(want)}
    assert kinds == {torch.bfloat16, torch.float32, torch.int32}
    _assert_tree_bits(want, restored)


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path, jax_state):
    cfg, js = jax_state
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    CheckpointManager(str(tmp_path / "port")).save(ts, step=7)
    JManager(str(tmp_path / "jax")).save(js, step=7)
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), js)
    restored, step = JManager(str(tmp_path / "port")).restore(abstract)
    assert step == 7
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and np.array_equal(_np_bits(a), _np_bits(b))
    # one format: the same manifest text and the same .npy bytes
    port, ref = tmp_path / "port" / "step_7", tmp_path / "jax" / "step_7"
    assert (port / "manifest.json").read_text() == (ref / "manifest.json").read_text()
    files = sorted(p.name for p in ref.iterdir())
    assert files == sorted(p.name for p in port.iterdir()) and len(files) == len(leaves(ts)) + 1
    for name in files:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name


def test_port_trainer_resumes_a_jax_run(tmp_path, monkeypatch):
    """JAX trains steps 0-1, the port steps 2-3 from JAX's checkpoint, JAX
    steps 4-5 from the port's: every loss within 1e-5 of an uninterrupted
    JAX run's."""
    monkeypatch.setenv("REPRO_KERNELS", "xla")  # the JAX Pallas kernels have no backward
    jcfg, tcfg = J_SMOKES[ARCH].variant(dtype="float32"), SMOKES[ARCH].variant(dtype="float32")
    hp = dict(lr_peak=1e-2, warmup_steps=1, total_steps=6)
    run = dict(batch=2, seq=16, ckpt_every=2, log_every=100, seed=3)

    def jax_run(steps, ckpt_dir):
        ex = JExecutor(n_workers=2)
        try:
            t = JTrainer(jcfg, JHP(**hp), JTC(microbatches=1, remat="none"),
                         JTrainerConfig(steps=steps, ckpt_dir=ckpt_dir, **run), executor=ex)
            t.train()
        finally:
            ex.shutdown()
        return [r["loss"] for r in t.metrics_log]

    whole = jax_run(6, None)
    d = str(tmp_path / "ckpt")
    first = jax_run(2, d)
    port = Trainer(tcfg, OptHParams(**hp), TrainConfig(microbatches=1, remat="none"),
                   TrainerConfig(steps=4, ckpt_dir=d, **run), device="cpu")
    port.train()
    assert port.start_step == 2 and [r["step"] for r in port.metrics_log] == [2, 3]
    assert int(port.state["step"]) == 4 and CheckpointManager(d).available_steps() == [2, 4]
    last = jax_run(6, d)
    got = first + [r["loss"] for r in port.metrics_log] + last
    assert len(got) == 6
    for step, (a, b) in enumerate(zip(whole, got)):
        assert abs(a - b) <= 1e-5, (step, a, b)
    assert whole[-1] < whole[0]


def test_launcher_saves_and_resumes_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    args = ["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "1"]
    assert train_main(args + ["--steps", "2"]) == 0
    assert CheckpointManager(d).available_steps() == [1, 2]
    assert train_main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert f"restored step 2 from {d}" in out and "'steps': 1" in out
    assert CheckpointManager(d).available_steps() == [1, 2, 3]


# -------------------------------------------------------------------- snapshot


@pytest.fixture(scope="module")
def cache_row():
    """A decode-cache row after a prefill (bf16 K/V, int32 positions) in
    both packages, and the meta a fleet hand-off carries with it."""
    cfg = J_SMOKES[ARCH]
    params = j_init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    _, jc = j_prefill(params, cfg, {"tokens": jnp.asarray(toks)}, j_init_cache(cfg, 1, 16))
    meta = {"rid": 3, "prompt": [1, 2, 3], "max_new": 5, "position": 9, "remaining": 2, "last_tok": 7,
            "prefill_queue": None, "prefill_open": False}
    return jc, cache_from_jax(jax.tree.map(np.asarray, jc), "cpu"), meta


def test_snapshot_bytes_equal_across_frameworks(cache_row):
    jc, tc, meta = cache_row
    payload = pack_state(tc, meta)
    assert payload == j_pack_state(jc, meta)
    assert payload[:4] == b"RSNP"
    extra = {"w": [np.float32(1.5), np.arange(4, dtype=np.int16)], "s": 2.0, "n": 3}  # numpy and Python leaves
    assert pack_state(extra) == j_pack_state(extra)


def test_snapshot_unpacks_both_ways(cache_row):
    jc, tc, meta = cache_row
    state, got_meta = unpack_state(j_pack_state(jc, meta), abstract=_zeros_like(tc))
    assert got_meta == meta
    _assert_tree_bits(tc, state)
    flat, _ = unpack_state(pack_state(tc, meta))  # no abstract: {tree path: CPU tensor}
    assert len(flat) == len(leaves(tc)) and _bits_equal(flat["kv/pos"], tc["kv"]["pos"])
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jc)
    jstate, jmeta = j_unpack_state(pack_state(tc, meta), abstract=abstract)
    assert jmeta == meta
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(_np_bits(a), _np_bits(b))


def test_snapshot_rejects_a_mismatch(cache_row):
    _, tc, meta = cache_row
    payload = pack_state(tc, meta)
    with pytest.raises(ValueError, match="magic"):
        unpack_state(b"XXXX" + payload[4:])
    for change, fn in (("dtype", torch.Tensor.float), ("shape", lambda t: t[..., :1])):
        bad = _zeros_like(tc)
        bad["kv"]["k"] = fn(bad["kv"]["k"])
        with pytest.raises(ValueError, match=change):
            unpack_state(payload, abstract=bad)
