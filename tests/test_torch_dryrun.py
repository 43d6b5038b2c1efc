"""The port's dry-run (``repro_torch.launch.dryrun``) and production mesh
(``repro_torch.launch.mesh``), each in its own process (the fake process
group is process-global), the counterparts of the reference's
``test_dryrun_cell_small_mesh_subprocess`` and
``test_multipod_mesh_shapes_subprocess``.

* ``--cells`` on a 4×4 mesh (world 16) — the dense floor's and one cell
  each of the MoE, SSM, hybrid and MLA families — and ``tinyllama-1.1b ×
  decode_32k`` on the real 16×16 fake mesh: status ``ok``, the reference's keys, some
  collective traffic, and ``memory.argument_size_in_bytes`` equal to the
  local bytes of the placed arguments — recomputed here from the spec
  trees and the mesh's axis sizes, exactly.
* ``make_production_mesh`` over a fake world of 256 and of 512 gives the
  reference's shapes and axis names; over a world of 1 it raises and names
  the world it needs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import make_rules
from repro_torch.launch.specs import abstract_cache, abstract_params, abstract_train_state, input_specs
from repro_torch.sharding.logical import PartitionSpec, axis_size, sanitize_spec
from repro_torch.sharding.params import batch_specs, cache_specs, map_with_path, opt_specs, param_specs
from repro_torch.train import TrainConfig

SRC = str(Path(__file__).resolve().parent.parent / "src")
REF_KEYS = {"cell", "arch", "shape", "mesh", "n_devices", "kind", "rules_overrides", "tcfg", "lower_s", "compile_s",
            "cost", "memory", "collective_bytes", "dot_flops", "dot_bytes", "hbm_bytes", "while_trip_counts",
            "hlo_lines", "status"}


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, timeout=timeout)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _local_bytes(tree, specs, mesh) -> int:
    """Σ over leaves of Π ceil(dim / shards) × element size: a rank-0 shard
    of the sanitized spec (``torch.chunk``'s split: the first shard is the
    largest)."""
    total = []

    def leaf(_, t, spec):
        n = 1
        for dim, e in zip(t.shape, list(sanitize_spec(spec, t.shape, mesh)) + [None] * t.dim()):
            n *= -(-dim // axis_size(mesh, e))
        total.append(n * t.element_size())

    map_with_path(leaf, tree, specs)
    return sum(total)


def _expected_arg_bytes(arch_name, shape_name, mesh_shape) -> int:
    """The dry-run's argument bytes, from the spec trees alone."""
    arch, shape = get_config(arch_name), SHAPES[shape_name]
    mesh = FakeMesh(mesh_shape)
    overrides = {}
    if shape.kind != "train":
        overrides["seq_kv"] = "model" if shape.name != "long_500k" else ("data", "model")
    if shape.kind in ("train", "prefill") and arch.n_heads % mesh_shape["model"]:
        overrides.update(seq_act="model", heads=None, kv_heads=None)
    rules = make_rules(mesh, overrides=overrides)
    batch = input_specs(arch, shape)
    total = _local_bytes(batch, batch_specs(batch, rules), mesh)
    if shape.kind == "train":
        st = abstract_train_state(arch, TrainConfig())
        spec = {"params": param_specs(st["params"], rules),
                "opt": opt_specs(st["opt"], st["params"], rules, zero=True, mesh=mesh), "step": PartitionSpec()}
        return total + _local_bytes(st, spec, mesh)
    params = abstract_params(arch)
    cache = abstract_cache(arch, shape.global_batch, shape.seq_len)
    return total + _local_bytes(params, param_specs(params, rules), mesh) + _local_bytes(cache, cache_specs(cache, rules), mesh)


# the dense floor's, then a cell of each family whose step first failed on
# the card's PyTorch (the MoE dispatch, the SSM conv, the hybrid's decode,
# MLA's train step under seq_act)
CELLS = [("tinyllama-1.1b", "decode_32k", "4x4"), ("tinyllama-1.1b", "train_4k", "4x4"),
         ("h2o-danube-3-4b", "prefill_32k", "4x4"), ("tinyllama-1.1b", "decode_32k", None),
         ("deepseek-moe-16b", "train_4k", "4x4"), ("mamba2-130m", "prefill_32k", "4x4"),
         ("zamba2-1.2b", "decode_32k", "4x4"), ("minicpm3-4b", "train_4k", "4x4")]


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    small = ",".join(f"{a}:{s}" for a, s, m in CELLS if m)
    r1 = _run(["-m", "repro_torch.launch.dryrun", "--cells", small, "--mesh", "4x4", "--out", str(out)])
    r2 = _run(["-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--out", str(out)])
    assert r1.returncode == 0 and r2.returncode == 0, (r1.stdout[-2000:], r1.stderr[-2000:], r2.stderr[-2000:])
    return out


@pytest.mark.parametrize("arch,shape,mesh", CELLS, ids=lambda x: str(x))
def test_dryrun_cell_ok_with_the_reference_keys(dry, arch, shape, mesh):
    res = json.loads((dry / f"{arch}__{shape}__{mesh or 'pod1'}.json").read_text())
    assert res["status"] == "ok", res
    assert set(res) == REF_KEYS
    assert res["mesh"] == (mesh or "16x16") and res["n_devices"] == (16 if mesh else 256)
    assert sum(res["collective_bytes"].values()) > 0 and res["dot_flops"] > 0
    assert res["while_trip_counts"] == {}
    sizes = {"data": 4, "model": 4} if mesh else {"data": 16, "model": 16}
    assert res["memory"]["argument_size_in_bytes"] == _expected_arg_bytes(arch, shape, sizes)


def test_save_hlo_has_nothing_to_save(tmp_path):
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--save-hlo",
              "--out", str(tmp_path)], timeout=120)
    assert r.returncode != 0 and "no HLO" in r.stderr


MESH_SCRIPT = """
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
fake_world(1)
try:
    make_production_mesh()
except RuntimeError as e:
    print("RAISED", e)
fake_world(256)
m1 = make_production_mesh()
fake_world(512)
m2 = make_production_mesh(multi_pod=True)
assert tuple(m1.shape) == (16, 16) and m1.mesh_dim_names == ("data", "model"), m1
assert tuple(m2.shape) == (2, 16, 16) and m2.mesh_dim_names == ("pod", "data", "model"), m2
print("MESH_OK")
"""


def test_production_mesh_shapes_subprocess():
    r = _run(["-c", MESH_SCRIPT], timeout=300)
    assert "MESH_OK" in r.stdout, r.stderr[-2000:]
    assert "RAISED" in r.stdout and "world 256" in r.stdout and "world 1" in r.stdout, r.stdout
