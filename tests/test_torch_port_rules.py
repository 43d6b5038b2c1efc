"""Rules the PyTorch/CUDA port keeps.

* Nothing under ``src/repro_torch/``, and not ``chip_smoke.py`` or
  ``tools/torch_serve_profile.py``, imports ``jax`` or the JAX package
  ``repro`` (``repro_torch`` is the port).
* Entry points run on ``cuda`` unless the caller asks for the CPU; without
  a card they raise instead of carrying on on the CPU.
* The CUDA kernels (flash attention, the SSD chunk scan, the grouped
  matmul) agree with their plain versions (``gpu``-marked: need
  a card, decided inside the test).  This file imports no JAX, so those
  tests run on a machine that has none."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SMOKES
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import init_cache

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tools" / "torch_serve_profile.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for rel in ("src/repro_torch/models/model.py", "src/repro_torch/models/ssm.py", "src/repro_torch/models/moe.py",
                "src/repro_torch/kernels/flash_attention.py", "src/repro_torch/kernels/ssd_scan.py",
                "src/repro_torch/kernels/moe_gmm.py",
                "src/repro_torch/serve/server.py", "src/repro_torch/core/comm/collective.py", "chip_smoke.py"):
        assert rel in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = {root for root in _imported_roots(path) if root in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_the_scan_sees_a_forbidden_import():
    src = "import jax.numpy as jnp\nfrom repro.models import prefill\nfrom repro_torch import bridge\n"
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"jax", "repro", "repro_torch"}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "tinyllama-1.1b", "--requests", "1", "--clients", "1"])
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        init_cache(SMOKES["tinyllama-1.1b"], 1, 8)
    with pytest.raises(RuntimeError):
        params_from_jax({"w": np.zeros(2, np.float32)})


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    assert resolve_device("cpu").type == "cpu"
    cache = init_cache(SMOKES["tinyllama-1.1b"], 1, 8, device="cpu")
    assert cache["kv"]["pos"].device.type == "cpu"
    assert params_from_jax({"w": np.zeros(2, np.float32)}, "cpu")["w"].device.type == "cpu"
    assert serve_main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--requests", "2", "--clients", "1",
                       "--max-new", "2", "--prompt-len", "3"]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, S, H, KV, D, causal, window, chunk, dtype)
    (1, 512, 32, 4, 64, True, 0, 0, torch.bfloat16),
    (1, 200, 32, 4, 64, True, 0, 0, torch.bfloat16),
    (1, 1024, 32, 32, 64, True, 4096, 0, torch.bfloat16),  # zamba2-1.2b's shared block (swa, H == KV)
    (1, 777, 32, 32, 64, True, 4096, 0, torch.bfloat16),  # the same at a ragged S
    (1, 777, 32, 32, 64, True, 256, 0, torch.bfloat16),  # H == KV with a window that masks
    (2, 256, 8, 2, 64, True, 64, 0, torch.float32),
    (2, 256, 4, 2, 64, True, 0, 128, torch.float32),
    (1, 77, 4, 2, 128, False, 0, 0, torch.float32),
    (1, 130, 4, 2, 16, True, 0, 0, torch.float32),
])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d, causal, window, chunk, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_plain(q, k, v, causal=causal, window=window, chunk=chunk)
    tol = 5e-5 if dtype == torch.float32 else 4e-2
    assert (out.float() - ref.float()).abs().max().item() < tol
    with pytest.raises(ValueError):
        flash_attention(q[..., : d // 2 + 1], k[..., : d // 2 + 1], v[..., : d // 2 + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("case, dtype", [
    # (B, H, G, nc, Q, P, N): the reference's SSD_CASES (tests/test_kernels.py) in f32
    ((2, 4, 2, 3, 64, 64, 128), torch.float32),
    ((1, 2, 1, 2, 128, 64, 64), torch.float32),
    ((1, 8, 8, 1, 64, 32, 128), torch.float32),
    ((2, 2, 1, 4, 32, 64, 32), torch.float32),
    ((1, 24, 1, 16, 64, 64, 128), torch.bfloat16),  # mamba2-130m prefill, S=1024
    ((1, 64, 1, 16, 64, 64, 64), torch.bfloat16),  # zamba2-1.2b prefill, S=1024
    ((2, 8, 1, 3, 8, 16, 16), torch.float32),  # the smoke configs' shape
])
def test_cuda_ssd_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import _lib, smem_bytes, ssd_chunk_kernel, ssd_chunk_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, h, g, nc, q, p, n = case
    assert smem_bytes(q, p, n) == _lib().repro_ssd_chunk_smem_bytes(q, p, n)
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    a = -torch.randn((bsz, h, nc, q), generator=gen, device="cuda").abs() * 0.1
    x = torch.randn((bsz, h, nc, q, p), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(dtype)
    c = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(dtype)
    before = ssd_chunk_kernel.launches
    y, st = ssd_chunk_kernel(a, x, b, c)
    torch.cuda.synchronize()
    assert ssd_chunk_kernel.launches == before + 1
    py, ps = ssd_chunk_plain(a, x, b, c)
    assert y.dtype == dtype and st.dtype == torch.float32
    if dtype == torch.float32:  # the reference's 1e-4
        assert (y - py).abs().max().item() <= 1e-4 and (st - ps).abs().max().item() <= 1e-4
    else:  # y rounds to bf16 in both: at most 2 bf16 ulps of the largest |y|
        assert (y.float() - py.float()).abs().max().item() <= 2.0**-7 * py.float().abs().max().item()
        assert (st - ps).abs().max().item() <= 1e-4 * max(1.0, ps.abs().max().item())
    # a strided view (the model's layout) reads the same as a contiguous input
    xs = x.permute(0, 2, 3, 1, 4).contiguous().permute(0, 3, 1, 2, 4)
    ys, ss = ssd_chunk_kernel(a, xs, b, c)
    assert torch.equal(ys, y) and torch.equal(ss, st)
    with pytest.raises(ValueError):
        ssd_chunk_kernel(a, x.transpose(-1, -2).contiguous().transpose(-1, -2), b, c)


@pytest.mark.gpu
@pytest.mark.parametrize("case, dtype, w_scale", [
    # (E, C, D, F): the reference's GMM_CASES (tests/test_kernels.py), at its scale
    ((4, 256, 512, 384), torch.float32, 0.05),
    ((2, 128, 128, 128), torch.float32, 0.05),
    ((8, 128, 256, 128), torch.bfloat16, 0.05),
    ((1, 512, 1024, 256), torch.float32, 0.05),
    # deepseek-moe-16b at its init's scale 1/sqrt(E): a 1024-token prefill's
    # gate/up and down, and a decode step of 8 slots laid out (E, 8·4, D)
    ((64, 120, 2048, 1408), torch.bfloat16, 0.125),
    ((64, 120, 1408, 2048), torch.bfloat16, 0.125),
    ((64, 32, 2048, 1408), torch.bfloat16, 0.125),
    ((3, 33, 70, 45), torch.float32, 0.05),  # ragged C, D and F
    ((2, 3, 5, 7), torch.bfloat16, 0.05),
])
def test_cuda_grouped_matmul_matches_plain(case, dtype, w_scale):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.moe_gmm import grouped_matmul, grouped_matmul_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    e, c, d, f = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    x = torch.randn((e, c, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((e, d, f), generator=gen, device="cuda") * w_scale).to(dtype)
    before = grouped_matmul.launches
    out = grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    ref = grouped_matmul_plain(x, w)
    assert out.dtype == dtype and out.shape == (e, c, f)
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:  # the reference's 1e-4
        assert err <= 1e-4
    else:  # both round an f32 sum to bf16 once: at most 2 bf16 ulps of the largest |out|
        assert err <= 2.0**-7 * ref.float().abs().max().item()
    # strided views read the same as contiguous inputs, bit for bit
    xs = x.transpose(1, 2).contiguous().transpose(1, 2)  # D-major queues
    ws = w.transpose(1, 2).contiguous().transpose(1, 2)  # D-major weights
    assert not xs.is_contiguous() and not ws.is_contiguous()
    assert torch.equal(grouped_matmul(xs, ws), out)
    assert grouped_matmul.launches == before + 2
    with pytest.raises(ValueError):
        grouped_matmul(x, w[:, :-1])
    with pytest.raises(TypeError):
        grouped_matmul(x, w.to(torch.float16))


@pytest.mark.gpu
def test_cuda_grouped_matmul_rows_do_not_depend_on_the_batch():
    """The decode layout (E, B·C, D): each row's result equals the same row
    run alone, bit for bit (the kernel sums every row over D in order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.moe_gmm import grouped_matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((64, 8, 4, 256), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((64, 256, 96), generator=gen, device="cuda") / 8).to(torch.bfloat16)
    both = grouped_matmul(q.view(64, 32, 256), w).view(64, 8, 4, 96)
    for b in (0, 5):
        assert torch.equal(grouped_matmul(q[:, b], w), both[:, b])
