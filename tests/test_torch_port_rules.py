"""Rules the PyTorch/CUDA port keeps.

* Nothing under ``src/repro_torch/``, and not ``chip_smoke.py`` or
  ``tools/torch_serve_profile.py``, imports ``jax`` or the JAX package
  ``repro`` (``repro_torch`` is the port).
* Entry points run on ``cuda`` unless the caller asks for the CPU; without
  a card they raise instead of carrying on on the CPU.
* The CUDA kernel agrees with its plain version (``gpu``-marked: needs a
  card, decided inside the test)."""
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
    for rel in ("src/repro_torch/models/model.py", "src/repro_torch/kernels/flash_attention.py",
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
