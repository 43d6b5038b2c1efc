"""The port's fused gradient pack (``repro_torch.kernels.grad_pack``).

On the CPU: ``pack_grads_fused_plain`` and ``pack_grads_fused`` (whose CPU
route is the plain version) give the bytes and the new EF of the port's
host reference ``pack_grads_q8`` bit for bit, on the cases of
``tests/test_grad_pack.py`` (that host reference is held against the JAX
package's in ``tests/test_torch_grad_sync.py``); ``packed_nbytes`` is the
wire's length; ``unpack_grads_fused`` reads what ``unpack_grads`` reads.

``gpu``-marked (need a card, decided inside the test): the CUDA kernel
equals the plain version bit for bit, wire and EF, across the ladder, over
10 EF steps, and at a leaf whose max spans many blocks; what it does with
non-finite gradients is recorded.  This file imports no JAX, so those tests
run on a machine that has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.comm import wire
from repro_torch.kernels.grad_pack import (
    TILE,
    _CACHE,
    pack_grads_fused,
    pack_grads_fused_plain,
    packed_nbytes,
    quantize_pack,
    quantize_pack_plain,
    unpack_grads_fused,
)
from repro_torch.train.grad_sync import pack_grads, pack_grads_q8, unpack_grads
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)
FIG3_SIZES = (512, 4096, 8192, 16384, 32768, 65536)


def _tree_for_size(nelems: int, seed: int = 0, device="cpu"):
    rng = np.random.default_rng(seed)
    a = max(1, nelems // 2)
    b = max(1, nelems // 3)
    c = max(0, nelems - a - b)
    mk = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)  # noqa: E731
    return {"w": mk(rng.standard_normal(a)), "b": mk(rng.standard_normal(b) * 1e-3), "v": mk(rng.standard_normal(c))}


def _ragged_tree(dtype, device="cpu"):
    rng = np.random.default_rng(11)
    mk = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype).to(device)  # noqa: E731
    return {"attn": (mk((33, 17)), mk((129,))), "mlp": [mk((7, 3, 5)), mk((1,))]}


def _zeros_ef(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _assert_ef_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert tuple(x.shape) == tuple(y.shape) and y.dtype == torch.float32
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _cases():
    yield from ((f"fig3_{n}", _tree_for_size(n, seed=n)) for n in FIG3_SIZES)
    yield "ragged_f32", _ragged_tree(torch.float32)
    yield "ragged_bf16", _ragged_tree(torch.bfloat16)
    yield "scalar", {"s": torch.tensor(0.75)}
    yield "empty_leaf", {"e": torch.zeros((0,)), "w": torch.ones((3,))}
    yield "all_empty", {"e": torch.zeros((0,)), "f": torch.zeros((2, 0), dtype=torch.bfloat16)}
    yield "empty_tree", {}


CASES = dict(_cases())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("pack", [pack_grads_fused_plain, pack_grads_fused], ids=["plain", "fused_cpu"])
def test_fused_pack_equals_the_host_reference(name, pack):
    tree = CASES[name]
    want, ef_want = pack_grads_q8(tree, _zeros_ef(tree))
    got, ef_got = pack(tree, _zeros_ef(tree))
    assert got == want
    assert len(got) == packed_nbytes(tree)
    _assert_ef_bitwise(ef_want, ef_got)


def test_fused_pack_multistep_ef_equals_the_host_reference():
    rng = np.random.default_rng(23)
    tree0 = {"w": torch.from_numpy(rng.standard_normal(640).astype(np.float32)),
             "b": torch.from_numpy((rng.standard_normal(9) * 1e-4).astype(np.float32))}
    ef_h = ef_p = _zeros_ef(tree0)
    for step in range(10):
        g = tree_map(lambda x: x * np.float32(1.0 + 0.1 * step) + np.float32(0.01 * step), tree0)
        want, ef_h = pack_grads_q8(g, ef_h)
        got, ef_p = pack_grads_fused(g, ef_p)
        assert got == want, f"step {step}"
        _assert_ef_bitwise(ef_h, ef_p)


@pytest.mark.parametrize("name", ["fig3_4096", "ragged_bf16", "empty_leaf", "scalar"])
def test_unpack_fused_equals_unpack_grads(name):
    tree = CASES[name]
    data, _ = pack_grads_fused(tree, _zeros_ef(tree))
    _assert_ef_bitwise(unpack_grads(data, tree), unpack_grads_fused(data, tree))
    with pytest.raises(ValueError):
        unpack_grads_fused(pack_grads(tree), tree)


def test_fused_wire_is_4x_smaller_than_raw_f32():
    tree = CASES["fig3_65536"]
    q8, _ = pack_grads_fused(tree, _zeros_ef(tree))
    assert len(q8) * 3.5 < len(pack_grads(tree))


def test_plan_cache_keyed_by_structure_shapes_and_dtypes():
    tree = _tree_for_size(3000, seed=1)
    pack_grads_fused(tree, _zeros_ef(tree))
    n = len(_CACHE)
    pack_grads_fused(_tree_for_size(3000, seed=2), _zeros_ef(tree))  # same layout: a hit
    assert len(_CACHE) == n
    pack_grads_fused(_tree_for_size(3001, seed=1), _zeros_ef(_tree_for_size(3001)))  # other shapes
    bf = tree_map(lambda x: x.to(torch.bfloat16), tree)
    pack_grads_fused(bf, _zeros_ef(bf))  # other dtypes
    listed = [tree["w"], tree["b"], tree["v"]]
    pack_grads_fused(listed, _zeros_ef(listed))  # other structure
    assert len(_CACHE) == n + 3


def test_quantize_pack_routes_cpu_tensors_to_the_plain_version():
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.standard_normal((3, TILE)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((3, TILE)).astype(np.float32) * 1e-3)
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    b1, b2 = (torch.zeros(8 * 2 + 3 * TILE, dtype=torch.uint8) for _ in range(2))
    before = quantize_pack.launches
    e1 = quantize_pack(g, e, seg, 2, b1)
    e2 = quantize_pack_plain(g, e, seg, 2, b2)
    assert quantize_pack.launches == before  # the plain route is no launch
    assert torch.equal(b1, b2) and torch.equal(e1, e2)
    scales = b1[8:16].view(torch.float32)
    want = torch.stack([(g[:2] + e[:2]).abs().max(), (g[2] + e[2]).abs().max()]) * float(np.float32(1) / np.float32(127))
    assert torch.equal(scales, want)


def test_leaves_on_two_devices_are_refused():
    tree = {"a": torch.zeros(3), "b": torch.zeros(3, device="meta")}
    with pytest.raises(ValueError):
        pack_grads_fused(tree, _zeros_ef(tree))


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda(tree):
    return tree_map(lambda x: x.cuda(), tree)


def _assert_kernel_equals_plain(tree, ef_k, ef_p):
    before = quantize_pack.launches
    got, new_k = pack_grads_fused(tree, ef_k)
    n_tiles = sum(wire.padded_nelems(t.numel()) for t in leaves(tree)) // TILE
    assert quantize_pack.launches == before + (1 if n_tiles else 0)
    want, new_p = pack_grads_fused_plain(tree, ef_p)
    assert got == want
    _assert_ef_bitwise(new_p, new_k)
    assert all(t.is_cuda for t in leaves(new_k))
    return want, new_k, new_p


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_equals_plain_and_host(name):
    _card()
    tree = _cuda(CASES[name])
    want, new_k, _ = _assert_kernel_equals_plain(tree, _zeros_ef(tree), _zeros_ef(tree))
    host, ef_host = pack_grads_q8(tree, _zeros_ef(tree))
    assert want == host
    _assert_ef_bitwise(ef_host, new_k)


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_over_10_ef_steps():
    _card()
    rng = np.random.default_rng(23)
    tree0 = _cuda({"w": torch.from_numpy(rng.standard_normal(640 * 1024 + 77).astype(np.float32)),
                   "b": torch.from_numpy((rng.standard_normal(9) * 1e-4).astype(np.float32)),
                   "m": torch.from_numpy(rng.standard_normal((33, 1025)).astype(np.float32)).to(torch.bfloat16)})
    ef_k = ef_p = _zeros_ef(tree0)
    for step in range(10):
        g = tree_map(lambda x: x * (1.0 + 0.1 * step) + 0.01 * step, tree0)
        _, ef_k, ef_p = _assert_kernel_equals_plain(g, ef_k, ef_p)


@pytest.mark.gpu
def test_cuda_kernel_large_leaf_max_spans_many_blocks():
    """A leaf of 6.3 M elements (6,152 tiles: about 6 tiles to each of the
    kernel's 1,056 max-pass blocks, its max at the far end) between small
    leaves, so leaf boundaries fall inside a block's range."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.randn(6_300_000, generator=gen, device=dev)
    big[-5] = 40.0
    tree = {"a": torch.randn(1000, generator=gen, device=dev), "big": big,
            "c": [torch.randn(3, 1024, generator=gen, device=dev) for _ in range(40)]}
    want, new_k, _ = _assert_kernel_equals_plain(tree, _zeros_ef(tree), _zeros_ef(tree))
    _, specs, off = wire.parse_grad_header(want)
    scales = np.frombuffer(want, dtype=np.float32, count=len(specs), offset=off + 4 * len(specs))
    assert scales[1] == np.float32(np.float32(40.0) * (np.float32(1) / np.float32(127)))
    host, ef_host = pack_grads_q8(tree, _zeros_ef(tree))
    assert want == host
    _assert_ef_bitwise(ef_host, new_k)


@pytest.mark.gpu
def test_cuda_kernel_non_finite_gradients():
    """Recorded, not a parity case: the kernel's max skips a NaN (fmaxf), so
    the leaf keeps its finite scale and the NaN element quantizes to -127;
    the host's max propagates it (scale NaN).  An inf makes the scale inf
    on both routes, and every new EF element of that leaf NaN."""
    dev = _card()
    g = torch.linspace(-1, 1, 2048, device=dev)
    g[7] = float("nan")
    data, ef = pack_grads_fused({"g": g}, {"g": torch.zeros_like(g)})
    _, specs, off = wire.parse_grad_header(data)
    scale = np.frombuffer(data, dtype=np.float32, count=1, offset=off + 4)[0]
    payload = np.frombuffer(data, dtype=np.int8, count=2048, offset=off + 8)
    assert scale == np.float32(np.float32(1.0) * (np.float32(1) / np.float32(127)))
    assert payload[7] == -127 and payload[-1] == 127 and torch.isnan(ef["g"][7])
    host, _ = pack_grads_q8({"g": g}, {"g": torch.zeros_like(g)})
    assert np.isnan(np.frombuffer(host, dtype=np.float32, count=1, offset=off + 4)[0])
    g[7] = float("inf")
    data, ef = pack_grads_fused({"g": g}, {"g": torch.zeros_like(g)})
    assert np.isinf(np.frombuffer(data, dtype=np.float32, count=1, offset=off + 4)[0])
    assert torch.isnan(ef["g"]).all()


@pytest.mark.gpu
def test_cuda_kernel_refuses_autograd_and_bad_inputs():
    dev = _card()
    g = torch.randn(2, TILE, device=dev)
    seg = torch.zeros(2, dtype=torch.int32, device=dev)
    body = torch.empty(8 + 2 * TILE, dtype=torch.uint8, device=dev)
    with pytest.raises(RuntimeError, match="autograd"):
        quantize_pack(g.requires_grad_(), torch.zeros_like(g), seg, 1, body)
    with torch.no_grad():
        quantize_pack(g, torch.zeros_like(g), seg, 1, body)
    with pytest.raises(ValueError):
        quantize_pack(g.detach(), torch.zeros_like(g), seg, 1, body[:-1])
    with pytest.raises(TypeError):
        quantize_pack(g.detach().double(), torch.zeros_like(g).double(), seg, 1, body)
