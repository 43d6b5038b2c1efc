"""Port parity: logical sharding and the spec trees
(``repro_torch.sharding``, ``repro_torch.launch.mesh.make_rules``) against
the JAX package, with no tolerance: specs are compared as tuples.

* The tests of ``tests/test_sharding_roofline.py`` on the port's rules:
  dedup, sanitize, ZeRO extension, ``param_specs`` cover, ``batch_specs``.
* For every smoke config: ``param_specs``, ``opt_specs`` (ZeRO off and on,
  on a FakeMesh of {data 4, model 8} and of {pod 2, data 16, model 16}),
  ``cache_specs`` (batch 1, whose batch dim must not claim the data axes,
  and batch 8) and ``batch_specs`` equal the reference's leaf for leaf,
  under ``DEFAULT_RULES`` and ``make_rules`` on both production mesh
  shapes (with ``long_context`` too).  The port's trees come from its
  initializers on meta; the reference's from ``jax.eval_shape``.
* ``placements`` on ``DeviceMesh``es over the ``fake`` process group: a
  tuple entry shards one dim over several mesh dims; ``_shard_cache``'s
  placements; ``logical_spec`` and ``named_sharding`` as the reference's.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SMOKES as J_SMOKES
from repro.launch.mesh import make_rules as j_make_rules
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.optim import adamw_init as j_adamw_init
from repro.sharding.logical import DEFAULT_RULES as J_DEFAULT_RULES
from repro.sharding.params import batch_specs as j_batch_specs
from repro.sharding.params import cache_specs as j_cache_specs
from repro.sharding.params import opt_specs as j_opt_specs
from repro.sharding.params import param_specs as j_param_specs
from repro_torch.configs import SMOKES
from repro_torch.launch.mesh import make_rules
from repro_torch.launch.specs import META, abstract_params
from repro_torch.models import init_cache
from repro_torch.optim import adamw_init
from repro_torch.sharding.logical import DEFAULT_RULES, PartitionSpec as P, ShardingRules, placements, sanitize_spec
from repro_torch.sharding.params import _zero_extend, batch_specs, cache_specs, map_with_path, opt_specs, param_specs


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"d4m8": {"data": 4, "model": 8}, "pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


# ------------------------------------------- the reference's tests, on the port
def test_rules_dedup_axes():
    r = ShardingRules({"a": "model", "b": "model", "c": ("data", "model")})
    assert r.spec("a", "b") == P("model", None)  # one axis, one dim
    assert r.spec("c", "a") == P(("data", "model"), None)


def test_sanitize_divisibility():
    mesh = FakeMesh({"data": 4, "model": 8})
    spec = P("data", "model", None)
    assert sanitize_spec(spec, (8, 16, 3), mesh) == P("data", "model", None)
    assert sanitize_spec(spec, (6, 16, 3), mesh) == P(None, "model", None)
    assert sanitize_spec(P(("data", "model")), (32,), mesh) == P(("data", "model"))
    assert sanitize_spec(P(("data", "model")), (12,), mesh) == P(None)


def test_zero_extend_moments():
    mesh = FakeMesh({"data": 4, "model": 8})
    assert _zero_extend(P(None, "model"), (8, 16), ("data",), mesh) == P("data", "model")
    assert _zero_extend(P(None), (7,), ("data",), mesh) == P(None)
    assert _zero_extend(P("data"), (8,), ("data",), mesh) == P("data")


@pytest.mark.parametrize("name", ["qwen2-7b", "deepseek-moe-16b", "mamba2-130m", "whisper-large-v3"])
def test_param_specs_cover_tree(name):
    params = abstract_params(SMOKES[name])
    rules = ShardingRules({"vocab": "model", "heads": "model", "mlp": "model", "experts": "model", "embed": None,
                           "kv_heads": "model", "head_dim": None, "latent": None})
    specs = param_specs(params, rules)
    n_specs, n_leaves = [], []
    map_with_path(lambda _, s: n_specs.append(s), specs)
    map_with_path(lambda _, t: n_leaves.append(t), params)
    assert len(n_specs) == len(n_leaves) and all(isinstance(s, P) for s in n_specs)
    assert specs["embed"] == P("model", None)  # embedding must be vocab-sharded


def test_batch_specs():
    rules = ShardingRules({"batch": ("pod", "data"), "seq": None, "embed": None})
    batch = {"tokens": torch.empty((8, 16), device=META), "positions": torch.empty((8,), device=META),
             "frames": torch.empty((8, 10, 4), device=META)}
    specs = batch_specs(batch, rules)
    assert specs["tokens"] == P(("pod", "data"), None)
    assert specs["positions"] == P(("pod", "data"))
    assert specs["frames"] == P(("pod", "data"), None, None)


# ----------------------------------------------------- parity, leaf for leaf
def _flat_port(tree):
    out = {}
    map_with_path(lambda p, s: out.__setitem__("/".join(p), s), tree)
    return out


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, JP))
    return {"/".join(str(k.key) for k in path): tuple(s) for path, s in flat}


def _assert_same(port, ref):
    fp, fr = _flat_port(port), _flat_ref(ref)
    assert fp.keys() == fr.keys()
    bad = {k: (fp[k], fr[k]) for k in fp if fp[k] != fr[k] or not isinstance(fp[k], P)}
    assert not bad, bad


def _rules(which):
    """(port rules, reference rules) of one rule set."""
    if which == "default":
        return DEFAULT_RULES, J_DEFAULT_RULES
    mesh, long_context = which.rsplit("_long", 1)[0], which.endswith("_long")
    m = FakeMesh(MESHES[mesh])
    return make_rules(m, long_context=long_context), j_make_rules(m, long_context=long_context)


RULE_SETS = ["default", "pod1", "pod2", "pod1_long", "pod2_long"]


def _ref_params(name):
    return jax.eval_shape(lambda r: j_init_params(r, J_SMOKES[name]), jax.random.PRNGKey(0))


@pytest.mark.parametrize("which", RULE_SETS)
@pytest.mark.parametrize("name", sorted(SMOKES))
def test_param_specs_match_reference(name, which):
    pr, jr = _rules(which)
    _assert_same(param_specs(abstract_params(SMOKES[name]), pr), j_param_specs(_ref_params(name), jr))


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero"])
@pytest.mark.parametrize("mesh", ["d4m8", "pod2"])
@pytest.mark.parametrize("name", sorted(SMOKES))
def test_opt_specs_match_reference(name, mesh, zero):
    m = FakeMesh(MESHES[mesh])
    params, j_params = abstract_params(SMOKES[name]), _ref_params(name)
    for pr, jr in ((make_rules(m), j_make_rules(m)), (DEFAULT_RULES, J_DEFAULT_RULES)):
        port = opt_specs(adamw_init(params), params, pr, zero=zero, mesh=m)
        ref = j_opt_specs(jax.eval_shape(j_adamw_init, j_params), j_params, jr, zero=zero, mesh=m)
        _assert_same(port, ref)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("which", RULE_SETS)
@pytest.mark.parametrize("name", sorted(SMOKES))
def test_cache_specs_match_reference(name, which, batch):
    pr, jr = _rules(which)
    port = init_cache(SMOKES[name], batch, 64, device="meta")
    ref = jax.eval_shape(lambda: j_init_cache(J_SMOKES[name], batch, 64))
    _assert_same(cache_specs(port, pr), j_cache_specs(ref, jr))


@pytest.mark.parametrize("which", RULE_SETS)
@pytest.mark.parametrize("name", sorted(SMOKES))
def test_batch_specs_match_reference(name, which):
    cfg = SMOKES[name]
    pr, jr = _rules(which)
    shapes = {"tokens": (8, 32), "labels": (8, 32), "positions": (8,)}
    if cfg.frontend == "vision":
        shapes["prefix"] = (8, cfg.n_prefix_tokens, cfg.d_model)
    if cfg.is_encdec:
        shapes["frames"] = (8, cfg.encoder_seq, cfg.d_model)
    port = {k: torch.empty(s, device=META) for k, s in shapes.items()}
    ref = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    _assert_same(batch_specs(port, pr), j_batch_specs(ref, jr))


# ----------------------------------------------------- DTensor placements
@pytest.fixture
def fake_world():
    """A fake process group of world 8 for the test's length."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_placements_on_device_meshes(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.params import distribute_tree

    m3 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), m3) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), m3) == (Replicate(), Shard(1), Replicate())
    assert placements(P(), m3) == (Replicate(),) * 3
    m2 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    assert placements(P("model", "data"), m2) == (Shard(1), Shard(0))
    rules = make_rules(m2)
    placed = distribute_tree({"w": torch.empty((8, 6, 3), device=META)}, m2, {"w": rules.spec("batch", "heads", None)})
    assert tuple(placed["w"].placements) == (Shard(0), Shard(1))
    assert tuple(placed["w"].to_local().shape) == (2, 3, 3)
    # a dim the axis does not divide replicates (sanitize), as the reference's input shardings
    placed = distribute_tree({"w": torch.empty((6, 5), device=META)}, m2, {"w": P("data", "model")})
    assert tuple(placed["w"].placements) == (Replicate(), Replicate())


def test_logical_spec_and_named_sharding_match_reference():
    from repro.sharding.logical import logical_spec as j_logical_spec
    from repro.sharding.logical import use_rules as j_use_rules
    from repro_torch.sharding import logical_spec, named_sharding, use_rules

    names = ("batch", "seq", "heads", None, "kv_heads")
    assert logical_spec(*names) == tuple(j_logical_spec(*names)) == (None,) * 5  # outside a rules context
    m = FakeMesh(MESHES["pod2"])
    with use_rules(make_rules(m)), j_use_rules(j_make_rules(m)):
        assert logical_spec(*names) == tuple(j_logical_spec(*names))
        assert named_sharding(m, *names).spec == logical_spec(*names)
    assert named_sharding(m, "vocab", "embed").spec == DEFAULT_RULES.spec("vocab", "embed") == P("model", None)


def test_shard_cache_places_the_cache_by_its_rules(fake_world):
    """``model._shard_cache`` (defined, not called, in both packages)
    redistributes a replicated cache to (batch, seq_kv, kv_heads) rings
    and (batch, seq_kv) 4-dim leaves, 3-dim ones untouched; plain tensors
    pass through."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.model import _shard_cache
    from repro_torch.sharding import use_rules

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cache = {"k": torch.empty((2, 4, 8, 4, 16)), "k_rope": torch.empty((2, 4, 8, 16)), "pos": torch.empty((2, 4, 8))}
    assert _shard_cache(cache)["k"] is cache["k"]
    placed = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()]) for k, v in cache.items()}
    with use_rules(make_rules(mesh, overrides={"seq_kv": "model"})):
        out = _shard_cache(placed)
    assert tuple(out["k"].placements) == (Shard(1), Shard(2))  # kv_heads lose "model" to seq_kv
    assert tuple(out["k_rope"].placements) == (Shard(1), Shard(2))
    assert tuple(out["pos"].placements) == (Replicate(), Replicate())
