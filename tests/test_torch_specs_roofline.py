"""Port parity: the abstract inputs and states (``repro_torch.launch.specs``),
the roofline arithmetic (``repro_torch.roofline.analysis``) and the
per-device op counter (``repro_torch.roofline.op_count``, the port's
counterpart of ``hlo_parse``) against the JAX package.

* ``input_specs``, ``abstract_params``, ``abstract_cache`` and
  ``abstract_train_state`` (meta tensors) equal the reference's
  ``jax.eval_shape`` results in shape and dtype, leaf for leaf, for every
  full config × shape that ``cell_is_applicable`` admits — exactly.
* ``model_flops`` and ``decode_min_bytes`` equal the reference's for every
  arch × shape — exactly (the same float arithmetic).
* ``analyze_cell`` and ``format_table`` on one synthetic record, with the
  reference's ``HW`` passed: equal fields, identical text.  The port's
  default ``HW`` is the H100's data sheet, none of the TPU's figures.
* The op counter on the reference's ``SYNTH_HLO`` program as eager torch
  (a 5-iteration loop of an 8×8 f32 all-reduce and dot on a 2-rank fake
  mesh, then an all-gather to 16×8): the reference test's three numbers,
  exactly; ``while_trip_counts`` stays empty (eager runs every trip).
* The counter's ``dot_flops`` over the smoke ``prefill`` and ``decode_step``
  (batch 8: one decode tile) of tinyllama, qwen2, mamba2 and
  deepseek-moe, with no mesh, against ``analyze_hlo(...).dot_flops`` of the
  CPU-compiled HLO of the same call: within 1%.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import SMOKES as J_SMOKES
from repro.configs import cell_is_applicable, get_config
from repro.launch.specs import abstract_cache as j_abstract_cache
from repro.launch.specs import abstract_params as j_abstract_params
from repro.launch.specs import abstract_train_state as j_abstract_train_state
from repro.launch.specs import input_specs as j_input_specs
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.roofline.analysis import HW as J_HW
from repro.roofline.analysis import analyze_cell as j_analyze_cell
from repro.roofline.analysis import decode_min_bytes as j_decode_min_bytes
from repro.roofline.analysis import format_table as j_format_table
from repro.roofline.analysis import model_flops as j_model_flops
from repro.roofline.hlo_parse import analyze_hlo
from repro.train import TrainConfig as JTC
from repro_torch.configs import SHAPES, SMOKES, list_archs
from repro_torch.launch.specs import abstract_cache, abstract_params, abstract_train_state, input_specs
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.roofline import HW, analyze_cell, count_ops, decode_min_bytes, format_table, model_flops
from repro_torch.train import TrainConfig
from repro_torch.tree import leaves

torch.set_num_threads(1)
ARCHS = list_archs()
CELLS = [(a, s) for a in ARCHS for s in SHAPES if cell_is_applicable(get_config(a), J_SHAPES[s])[0]]


def _shapes_dtypes(tree, ref):
    port = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in leaves(tree)]
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(ref)]
    return port, want


def _assert_meta(tree):
    assert all(t.device.type == "meta" for t in leaves(tree))


# ------------------------------------------------------------- abstract specs
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    port = input_specs(get_config(arch), SHAPES[shape])
    ref = j_input_specs(get_config(arch), J_SHAPES[shape])
    assert port.keys() == ref.keys()
    _assert_meta(port)
    got, want = _shapes_dtypes(port, ref)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_train_state_match_reference(arch):
    cfg = get_config(arch)
    p = abstract_params(cfg)
    _assert_meta(p)
    got, want = _shapes_dtypes(p, j_abstract_params(cfg))
    assert got == want
    st = abstract_train_state(cfg, TrainConfig())
    _assert_meta(st)
    got, want = _shapes_dtypes(st, j_abstract_train_state(cfg, JTC()))
    assert got == want


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if SHAPES[c[1]].kind != "train"])
def test_abstract_cache_matches_reference(arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    c = abstract_cache(cfg, sh.global_batch, sh.seq_len)
    _assert_meta(c)
    got, want = _shapes_dtypes(c, j_abstract_cache(cfg, sh.global_batch, sh.seq_len))
    assert got == want


# ----------------------------------------------------------- roofline arithmetic
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_decode_bytes_match_reference(arch):
    for shape in SHAPES:
        assert model_flops(arch, shape) == j_model_flops(arch, shape)
        assert decode_min_bytes(arch, shape) == j_decode_min_bytes(arch, shape)


REC = {"status": "ok", "cell": "qwen2-7b×decode_32k", "arch": "qwen2-7b", "shape": "decode_32k", "mesh": "16x16",
       "n_devices": 256, "kind": "decode", "dot_flops": 3.1e11, "dot_bytes": 2.2e10, "hbm_bytes": 7.5e10,
       "collective_bytes": {"all-gather": 1.5e9, "all-reduce": 2.0e8}}


@pytest.mark.parametrize("rec", [REC, dict(REC, shape="train_4k", kind="train", hbm_bytes=0.0),
                                 dict(REC, status="error")], ids=["decode", "train_dot_bytes", "error"])
def test_analyze_cell_and_table_match_reference(rec):
    hw = J_HW()
    port = analyze_cell(rec, HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, ici_link_bw=hw.ici_link_bw))
    ref = j_analyze_cell(rec, hw)
    if ref is None:
        assert port is None
        return
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert format_table([port]) == j_format_table([ref])


def test_hw_defaults_are_the_h100_data_sheet():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_link_bw, hw.peak_flops_f32) == (989e12, 3.35e12, 50e9, 67e12)
    assert hw.peak_flops != J_HW().peak_flops and hw.hbm_bw != J_HW().hbm_bw


# ---------------------------------------------------------------- op counter
@pytest.fixture
def fake_world_2():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    yield
    dist.destroy_process_group()


def test_op_counter_on_the_synthetic_program(fake_world_2):
    """The reference's SYNTH_HLO as eager torch: while (×5) { all-reduce;
    dot }, then an all-gather of the 8×8 input to 16×8."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("x",))
    a = torch.randn(8, 8)
    with count_ops() as c:
        x = a
        for _ in range(5):
            ar = funcol.all_reduce(x, "sum", (mesh, 0))
            x = ar @ ar
        gathered = funcol.wait_tensor(funcol.all_gather_single(a, 0, (mesh, 0)))
    assert tuple(gathered.shape) == (16, 8)
    assert c.while_trip_counts == {}
    assert c.collective_bytes["all-reduce"] == 8 * 8 * 4 * 5
    assert c.collective_bytes["all-gather"] == 16 * 8 * 4
    assert c.dot_flops == 2 * 64 * 8 * 5
    assert c.n_collectives == 6


FLOP_ARCHS = ("tinyllama-1.1b", "qwen2-7b", "mamba2-130m", "deepseek-moe-16b")


def _port_flops(arch: str, kind: str) -> float:
    cfg = SMOKES[arch]
    params = init_params(torch.Generator().manual_seed(0), cfg)
    cache = init_cache(cfg, 8, 64, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (8, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), count_ops() as c:
        if kind == "prefill":
            prefill(params, cfg, {"tokens": toks}, cache)
        else:
            decode_step(params, cfg, toks[:, :1], torch.full((8,), 5, dtype=torch.int32), cache)
    return c.dot_flops


def _ref_flops(arch: str, kind: str) -> float:
    cfg = J_SMOKES[arch]
    params = jax.eval_shape(lambda r: j_init_params(r, cfg), jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: j_init_cache(cfg, 8, 64))
    toks = jax.ShapeDtypeStruct((8, 32), jnp.int32)
    if kind == "prefill":
        lowered = jax.jit(lambda p, t, c: j_prefill(p, cfg, {"tokens": t}, c)).lower(params, toks, cache)
    else:
        tok1, pos = jax.ShapeDtypeStruct((8, 1), jnp.int32), jax.ShapeDtypeStruct((8,), jnp.int32)
        lowered = jax.jit(lambda p, t, q, c: j_decode_step(p, cfg, t, q, c)).lower(params, tok1, pos, cache)
    return analyze_hlo(lowered.compile().as_text()).dot_flops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_op_counter_dot_flops_match_the_reference_hlo(arch, kind, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    port, ref = _port_flops(arch, kind), _ref_flops(arch, kind)
    assert ref > 0 and math.isclose(port, ref, rel_tol=1e-2), (port, ref)
