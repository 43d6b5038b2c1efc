"""Port parity: the gradient wire (``repro_torch.core.comm.wire``) and
``repro_torch.train.grad_sync``, against the JAX package.

The contract is BIT parity of wire bytes: for the same tree, the port's
gradient header, ``leaf_spec``, ``pack_grads`` (``KIND_RAW``),
``pack_grads_q8`` and ``pack_grads_fused_plain`` (``KIND_Q8``) bytes equal
the JAX host reference's, and the new error-feedback leaves equal it bit for
bit, on every case of ``tests/test_grad_pack.py`` (the Fig-3 ladder, f32
and bf16 ragged trees, 10 EF steps, the edge trees).  The reference is held
to its host ``pack_grads_q8`` (or ``pack_grads_fused(mode="xla")``), never
to its ``pallas-interpret`` mode, which fails on the installed JAX.

``compress_grads_int8_ef`` equals the reference bit for bit where eager JAX
runs it (each op dispatched alone, so ``/ 127.0`` and ``g / scale`` are
IEEE divisions and nothing is contracted).  Under ``jit`` XLA may rewrite
the division by the constant 127 as a multiply by its reciprocal and fuse
``g32 - q*scale`` into an fma: an element of ``g / scale`` sitting on a
rounding knife-edge may then fall into the next bucket, so that
comparison allows one bucket at a few elements, as the reference's own
``test_fused_ef_equivalent_to_compress_grads_int8_ef`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.comm import wire as jwire
from repro.kernels.grad_pack import pack_grads_fused as j_pack_fused
from repro.train import grad_sync as jgs
from repro_torch.core.comm import CommChannel
from repro_torch.core.comm import wire
from repro_torch.kernels.grad_pack import pack_grads_fused, pack_grads_fused_plain, unpack_grads_fused
from repro_torch.train import TrainConfig
from repro_torch.train.grad_sync import (
    compress_grads_int8_ef,
    make_packer,
    pack_grads,
    pack_grads_q8,
    unpack_grads,
)
from repro_torch.tree import leaves

torch.set_num_threads(1)
FIG3_SIZES = (512, 4096, 8192, 16384, 32768, 65536)


def _t(a) -> torch.Tensor:
    """A JAX/numpy leaf as a CPU tensor, bf16 by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tt(tree):
    return jax.tree.map(_t, tree)


def _zeros_ef(tree):
    return jax.tree.map(lambda x: jnp.zeros(np.shape(x), jnp.float32), tree)


def _tree_for_size(nelems: int, seed: int = 0):
    """The reference test's ragged three-leaf tree of ``nelems`` elements."""
    rng = np.random.default_rng(seed)
    a = max(1, nelems // 2)
    b = max(1, nelems // 3)
    c = max(0, nelems - a - b)
    return {
        "w": jnp.asarray(rng.standard_normal(a), jnp.float32),
        "b": jnp.asarray(rng.standard_normal(b) * 1e-3, jnp.float32),
        "v": jnp.asarray(rng.standard_normal(c), jnp.float32),
    }


def _ragged_tree(dtype: str):
    rng = np.random.default_rng(11)
    dt = jnp.dtype(dtype)
    return {
        "attn": (jnp.asarray(rng.standard_normal((33, 17)), dt), jnp.asarray(rng.standard_normal((129,)), dt)),
        "mlp": [jnp.asarray(rng.standard_normal((7, 3, 5)), dt), jnp.asarray(rng.standard_normal((1,)), dt)],
    }


def _assert_trees_bitwise(j_tree, t_tree):
    jl, tl = jax.tree.leaves(j_tree), leaves(t_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.detach().cpu().numpy().view(np.uint32), a.astype(np.float32).view(np.uint32))


def _q8_all(tree, ef, t_ef=None):
    """(JAX host bytes, JAX new ef), and the port's host and plain-fused
    (bytes, new ef) for the same tree and EF."""
    t_ef = _tt(ef) if t_ef is None else t_ef
    want = jgs.pack_grads_q8(tree, ef)
    return want, pack_grads_q8(_tt(tree), t_ef), pack_grads_fused_plain(_tt(tree), t_ef)


# --------------------------------------------------------------- wire format


def test_grad_header_bytes_equal_the_reference():
    arrs = [np.zeros((3, 4), np.float32), np.zeros((0,), np.int8), np.zeros((), np.float32), np.zeros((2, 1, 5), np.int32)]
    want = jwire.encode_grad_header(jwire.KIND_RAW, [jwire.leaf_spec(a) for a in arrs])
    specs = [wire.leaf_spec(_t(a)) for a in arrs]
    got = wire.encode_grad_header(wire.KIND_RAW, specs)
    assert got == want and wire.grad_header_bytes(specs) == len(want)
    kind, back, off = wire.parse_grad_header(got)
    assert kind == wire.KIND_RAW and off == len(got) and back == specs
    assert [s.dtype for s in back] == [torch.float32, torch.int8, torch.float32, torch.int32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "float16", "int32", "bool"])
@pytest.mark.parametrize("quantized", [False, True])
def test_leaf_spec_equals_the_reference(dtype, quantized):
    j = jnp.zeros((5, 3), jnp.dtype(dtype))
    want = jwire.leaf_spec(j, quantized=quantized)
    got = wire.leaf_spec(_t(j), quantized=quantized)
    assert (got.code, got.shape, got.nbytes) == (want.code, want.shape, want.nbytes)
    assert wire.code_dtype(got.code) == getattr(torch, dtype)


def test_wire_helpers_and_garbage():
    specs = [wire.LeafSpec(0, (1025,), 1025), wire.LeafSpec(0, (0,), 0), wire.LeafSpec(1, (3,), 3)]
    assert [wire.padded_nelems(s.nelems) for s in specs] == [2048, 0, 1024]
    assert wire.q8_offsets(specs) == jwire.q8_offsets([jwire.LeafSpec(s.code, s.shape, s.nbytes) for s in specs])
    with pytest.raises(ValueError):
        wire.parse_grad_header(b"\x00" * 16)
    with pytest.raises(ValueError):
        wire.dtype_code(torch.complex64)
    with pytest.raises(ValueError):
        wire.code_dtype(99)


def test_pack_grads_raw_bytes_equal_the_reference_and_round_trip():
    rng = np.random.default_rng(3)
    tree = {
        "w": (jnp.asarray(rng.standard_normal((8, 8)), jnp.float32), jnp.asarray(rng.integers(-100, 100, (8,)), jnp.int8)),
        "b": jnp.asarray(rng.standard_normal((5,)).astype(np.float16)),
        "h": [jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16), jnp.zeros((0,), jnp.float32)],
    }
    tt = _tt(tree)
    data = pack_grads(tt)
    assert data == jgs.pack_grads(tree)
    back = unpack_grads(data, tt)
    for want, got in zip(leaves(tt), leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    # the reference's unpacker reads the port's bytes
    for want, got in zip(jax.tree.leaves(tree), jax.tree.leaves(jgs.unpack_grads(data, tree))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------ the q8 wire: bit parity


@pytest.mark.parametrize("size", FIG3_SIZES)
def test_q8_bytes_equal_the_reference_fig3_ladder(size):
    tree = _tree_for_size(size, seed=size)
    ef = _zeros_ef(tree)
    (want, ef_want), (host, ef_host), (plain, ef_plain) = _q8_all(tree, ef)
    assert host == want and plain == want
    _assert_trees_bitwise(ef_want, ef_host)
    _assert_trees_bitwise(ef_want, ef_plain)
    # the reference's own fused lowering agrees too (held to the host bytes)
    assert j_pack_fused(tree, ef, mode="xla")[0] == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_bytes_equal_the_reference_dtypes_ragged(dtype):
    tree = _ragged_tree(dtype)
    (want, ef_want), (host, ef_host), (plain, ef_plain) = _q8_all(tree, _zeros_ef(tree))
    assert host == want and plain == want
    _assert_trees_bitwise(ef_want, ef_host)
    _assert_trees_bitwise(ef_want, ef_plain)


def test_q8_multistep_ef_bit_parity():
    """10 steps of EF evolution, each path fed its OWN ef state: the wire
    bytes and the EF stay identical every step."""
    rng = np.random.default_rng(23)
    tree0 = {"w": jnp.asarray(rng.standard_normal((640,)), jnp.float32),
             "b": jnp.asarray(rng.standard_normal((9,)) * 1e-4, jnp.float32)}
    ef_j = _zeros_ef(tree0)
    ef_h = ef_p = _tt(ef_j)
    for step in range(10):
        g = jax.tree.map(lambda x: x * np.float32(1.0 + 0.1 * step) + np.float32(0.01 * step), tree0)
        want, ef_j = jgs.pack_grads_q8(g, ef_j)
        got_h, ef_h = pack_grads_q8(_tt(g), ef_h)
        got_p, ef_p = pack_grads_fused_plain(_tt(g), ef_p)
        assert got_h == want and got_p == want, f"step {step}"
        _assert_trees_bitwise(ef_j, ef_h)
        _assert_trees_bitwise(ef_j, ef_p)


def test_q8_edge_trees():
    # empty tree
    want, _ = jgs.pack_grads_q8({}, {})
    assert pack_grads_q8({}, {})[0] == want and pack_grads_fused_plain({}, {})[0] == want
    assert unpack_grads_fused(want, {}) == {}
    # single scalar leaf
    t = {"s": jnp.asarray(0.75, jnp.float32)}
    (want, ef_want), (host, ef_host), (plain, ef_plain) = _q8_all(t, _zeros_ef(t))
    assert host == want and plain == want
    assert tuple(ef_plain["s"].shape) == () and tuple(ef_host["s"].shape) == ()
    _assert_trees_bitwise(ef_want, ef_plain)
    assert abs(float(unpack_grads_fused(want, _tt(t))["s"]) - 0.75) < 0.01
    # empty leaf next to a real one
    t2 = {"e": jnp.zeros((0,), jnp.float32), "w": jnp.ones((3,), jnp.float32)}
    (want2, _), (host2, _), (plain2, _) = _q8_all(t2, _zeros_ef(t2))
    assert host2 == want2 and plain2 == want2
    back = unpack_grads_fused(want2, _tt(t2))
    assert tuple(back["e"].shape) == (0,)
    np.testing.assert_allclose(back["w"].numpy(), np.ones(3), atol=0.01)
    # every leaf empty: no tile, the maxabs == 0 scales
    t3 = {"e": jnp.zeros((0,), jnp.float32), "f": jnp.zeros((2, 0), jnp.bfloat16)}
    (want3, _), (host3, _), (plain3, ef3) = _q8_all(t3, _zeros_ef(t3))
    assert host3 == want3 and plain3 == want3
    assert tuple(ef3["f"].shape) == (2, 0) and ef3["f"].dtype == torch.float32


def test_q8_unpack_equals_the_reference():
    tree = _tree_for_size(2048, seed=7)
    data, _ = jgs.pack_grads_q8(tree, _zeros_ef(tree))
    want = jgs.unpack_grads(data, tree)
    like = _tt(tree)
    _assert_trees_bitwise(want, unpack_grads(data, like))
    _assert_trees_bitwise(want, unpack_grads_fused(data, like))


# ----------------------------------------------------- compress_grads_int8_ef


def test_compress_int8_ef_bitwise_equals_eager_jax_over_10_steps():
    rng = np.random.default_rng(29)
    tree = {"w": jnp.asarray(rng.standard_normal((257,)), jnp.float32),
            "m": jnp.asarray(rng.standard_normal((16, 8)) * 1e-3, jnp.bfloat16)}
    ef_j = _zeros_ef(tree)
    ef_t = _tt(ef_j)
    for _ in range(10):
        deq_j, ef_j = jgs.compress_grads_int8_ef(tree, ef_j)  # eager: every op alone
        deq_t, ef_t = compress_grads_int8_ef(_tt(tree), ef_t)
        _assert_trees_bitwise(deq_j, deq_t)
        _assert_trees_bitwise(ef_j, ef_t)


def test_compress_int8_ef_within_one_bucket_of_jitted_jax():
    """Under jit the reference may multiply by 1/127 and contract
    ``g32 - q*scale``: a knife-edge element may land one bucket away."""
    rng = np.random.default_rng(31)
    tree = {"w": jnp.asarray(rng.standard_normal((4099,)), jnp.float32)}
    ef_j = _zeros_ef(tree)
    ef_t = _tt(ef_j)
    jitted = jax.jit(jgs.compress_grads_int8_ef)
    for _ in range(10):
        g32 = np.asarray(tree["w"]) + np.asarray(ef_j["w"])
        deq_j, ef_j = jitted(tree, ef_j)
        deq_t, ef_t = compress_grads_int8_ef(_tt(tree), ef_t)
        bucket = float(np.max(np.abs(g32))) / 127
        diff = np.abs(np.asarray(deq_j["w"]) - deq_t["w"].numpy())
        assert float(np.max(diff)) <= 1.5 * bucket and int(np.count_nonzero(diff > 1e-6)) <= 3
        ef_t = _tt(ef_j)  # continue from the reference's state, so each step tests one quantization


def test_compress_keeps_tuple_containers_and_int_leaves():
    g = {"w": (jnp.linspace(-1.0, 1.0, 12).reshape(3, 4), jnp.arange(4, dtype=jnp.int32)), "b": jnp.ones((2,), jnp.float32)}
    ef = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), g)
    deq_j, ef_j = jgs.compress_grads_int8_ef(g, ef)
    deq_t, ef_t = compress_grads_int8_ef(_tt(g), _tt(ef))
    assert isinstance(deq_t["w"], tuple) and isinstance(ef_t["w"], tuple)
    _assert_trees_bitwise(deq_j, deq_t)
    _assert_trees_bitwise(ef_j, ef_t)


# ------------------------------------------------------------ packer dispatch


def test_make_packer_dispatch_and_parity():
    tree = _tt(_tree_for_size(1024, seed=5))
    ef = jax.tree.map(lambda x: torch.zeros(x.shape), tree)
    assert make_packer(TrainConfig(grad_pack="host").grad_pack) is pack_grads_q8
    assert make_packer(TrainConfig(grad_pack="device").grad_pack) is pack_grads_fused
    host_data, host_ef = make_packer("host")(tree, ef)
    dev_data, dev_ef = make_packer("device")(tree, ef)
    assert host_data == dev_data
    for a, b in zip(leaves(host_ef), leaves(dev_ef)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        make_packer("nope")
    with pytest.raises(ValueError):
        TrainConfig(grad_pack="nope")


# ------------------------------------------------------------ DP end-to-end


def _reap_recv(channel, source):
    for _ in range(8):
        rec = channel.reap(source)
        if rec is not None and rec.op == "recv":
            return rec
    raise AssertionError(f"no arrived payload on {source}")


def _exchange(wires):
    channel = CommChannel()
    channel.send_request(wires[0])  # rank 0 -> rank 1
    channel.send_response(wires[1])  # rank 1 -> rank 0
    for _ in range(4):
        channel.progress()
    return _reap_recv(channel, "request").data, _reap_recv(channel, "response").data


def _two_rank_grads(seed):
    rng = np.random.default_rng(seed)
    return [{"w": (jnp.asarray(rng.standard_normal((8, 8)), jnp.float32), jnp.asarray(rng.standard_normal((8,)), jnp.float32))}
            for _ in range(2)]


def test_grad_sync_handoff_over_the_port_channel():
    """Each rank compresses, packs (``KIND_RAW``), ships through the port's
    CommChannel and averages with its peer's: identical to the direct
    average, and to the reference's dequantized values."""
    grads = _two_rank_grads(1)
    deq_j = [jgs.compress_grads_int8_ef(g, _zeros_ef(g))[0] for g in grads]
    deq = [compress_grads_int8_ef(_tt(g), _tt(_zeros_ef(g)))[0] for g in grads]
    for a, b in zip(deq_j, deq):
        _assert_trees_bitwise(a, b)
    at_1, at_0 = _exchange([pack_grads(deq[0]), pack_grads(deq[1])])
    from_peer0, from_peer1 = unpack_grads(at_1, deq[1]), unpack_grads(at_0, deq[0])
    avg = lambda a, b: jax.tree.map(lambda x, y: (x + y) / 2, a, b)  # noqa: E731
    direct = avg(deq[0], deq[1])
    for got in (avg(deq[0], from_peer1), avg(from_peer0, deq[1])):
        for x, y in zip(leaves(got), leaves(direct)):
            assert torch.equal(x, y)


def test_dp_exchange_fused_over_the_port_channel():
    """Two ranks exchange fused-packed (``KIND_Q8``) gradients through the
    port's CommChannel and average: identical to the direct average of the
    dequantized trees, and the wires equal the reference's host bytes."""
    grads = _two_rank_grads(31)
    wires, deq = [], []
    for g in grads:
        data, _ = make_packer("device")(_tt(g), _tt(_zeros_ef(g)))
        assert data == jgs.pack_grads_q8(g, _zeros_ef(g))[0]
        wires.append(data)
        deq.append(unpack_grads_fused(data, _tt(g)))
    at_1, at_0 = _exchange(wires)
    assert at_1 == wires[0] and at_0 == wires[1]
    from_peer0, from_peer1 = unpack_grads_fused(at_1, deq[1]), unpack_grads_fused(at_0, deq[0])
    avg = lambda a, b: jax.tree.map(lambda x, y: (x + y) / 2, a, b)  # noqa: E731
    direct = avg(deq[0], deq[1])
    for got in (avg(deq[0], from_peer1), avg(from_peer0, deq[1])):
        for x, y in zip(leaves(got), leaves(direct)):
            assert torch.equal(x, y)


def test_tree_leaves_follow_jax_order():
    from repro_torch.tree import tree_map, unflatten

    tree = {"z": [1, (2, None, 3)], "a": {"y": 4, "b": 5}, "m": (6,)}
    assert leaves(tree) == jax.tree.leaves(tree)
    back = unflatten(tree, [10 * x for x in leaves(tree)])
    assert back == jax.tree.map(lambda x: 10 * x, tree) and list(back) == ["z", "a", "m"]
    assert tree_map(lambda x, y: x + y, tree, tree) == jax.tree.map(lambda x: 2 * x, tree)
    with pytest.raises(ValueError):
        unflatten({"a": 1}, [1, 2])
