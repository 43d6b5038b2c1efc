"""Rules the PyTorch/CUDA port keeps.

* Nothing under ``src/repro_torch/``, and not ``chip_smoke.py`` or a
  port tool (``tools/torch_*.py``: the profilers, the SSD bench, the
  decode-row and profiler-session checks, the analyzer's launcher),
  imports ``jax``, ``ml_dtypes`` or the JAX package ``repro``
  (``repro_torch`` is the port).
* Entry points run on ``cuda`` unless the caller asks for the CPU; without
  a card they raise instead of carrying on on the CPU.
* The CUDA kernels (flash attention, the SSD chunk scan, the grouped
  matmul) agree with their plain versions (``gpu``-marked: need
  a card, decided inside the test); the bf16 routes of flash attention,
  the grouped matmul and the SSD chunk scan run on the tensor cores
  (``HMMA`` in their SASS), and the SSD kernel's slice of heads a block
  changes no bit.  This file imports no JAX, so those tests run on a
  machine that has none.
* A library is named by a hash of its source and of the shared headers,
  so an edited header rebuilds every kernel.
* A kernel wrapper refuses inputs that require grad under grad mode (its
  output would be silently detached); the train path goes through the
  kernels by ``autograd.Function``s (``FlashAttentionFn``, ``SSDChunkFn``,
  ``GroupedMatmulFn``), whose input gradients equal autograd through the
  kernels' plain versions bit for bit (on CPU tensors here; on the card,
  ``gpu``-marked, with the model's gradients against the plain path's and
  the launches each Function makes).
* Cross-attention (queries and keys of different lengths) takes the plain
  path and launches nothing; the MLA, encoder-decoder, VLM and llama4
  smokes launch each kernel exactly as often as their layers say, prefill
  and decode, and in a train step under each remat mode, with the
  gradients of ``remat="none"`` (``gpu``-marked)."""
import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.configs import SMOKES
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import init_cache
from repro_torch.optim import OptHParams
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "torch_serve_profile.py", REPO / "tools" / "torch_train_profile.py",
    REPO / "tools" / "torch_ssd_bench.py", REPO / "tools" / "torch_decode_rows.py",
    REPO / "tools" / "torch_profiler_sessions.py", REPO / "tools" / "torch_analyze.py"]


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
                "src/repro_torch/kernels/moe_gmm.py", "src/repro_torch/kernels/grad_pack.py",
                "src/repro_torch/serve/server.py", "src/repro_torch/core/comm/collective.py",
                "src/repro_torch/core/comm/wire.py", "src/repro_torch/core/comm/membership.py",
                "src/repro_torch/core/executor.py", "src/repro_torch/core/worker.py",
                "src/repro_torch/data/pipeline.py", "src/repro_torch/optim/adamw.py",
                "src/repro_torch/train/grad_sync.py", "src/repro_torch/train/step.py",
                "src/repro_torch/train/trainer.py", "src/repro_torch/launch/train.py",
                "src/repro_torch/checkpoint/manager.py", "src/repro_torch/checkpoint/snapshot.py", "chip_smoke.py",
                "src/repro_torch/serve/fleet.py", "src/repro_torch/core/comm/shmem.py",
                "src/repro_torch/analysis/sanitizer.py", "src/repro_torch/core/completion.py",
                "src/repro_torch/core/device.py", "src/repro_torch/core/fabric.py", "src/repro_torch/core/harness.py",
                "src/repro_torch/core/lci_parcelport.py", "src/repro_torch/core/mpi_parcelport.py",
                "src/repro_torch/core/mpi_sim.py", "src/repro_torch/core/parcel.py",
                "src/repro_torch/core/parcelport.py", "src/repro_torch/core/variants.py",
                "src/repro_torch/core/comm/registry.py", "src/repro_torch/amtsim/costs.py",
                "src/repro_torch/amtsim/des.py", "src/repro_torch/amtsim/parcelport_sim.py",
                "src/repro_torch/amtsim/workloads.py", "src/repro_torch/analysis/facts.py",
                "src/repro_torch/analysis/callgraph.py", "src/repro_torch/analysis/registry.py",
                "src/repro_torch/analysis/passes.py", "src/repro_torch/analysis/gates.py",
                "src/repro_torch/analysis/cli.py", "tools/torch_analyze.py"):
        assert rel in names
    assert "src/repro_torch/core/comm/completion.py" not in names  # the queues live at the reference's path
    for test in ("test_torch_train.py", "test_torch_train_families.py", "test_torch_checkpoint.py",
                 "test_torch_fleet.py", "test_torch_membership.py", "test_torch_shmem.py",
                 "test_torch_fabric_device.py", "test_torch_parcel.py", "test_torch_completion.py",
                 "test_torch_parcelports.py", "test_torch_protocol_engine.py", "test_torch_amtsim.py",
                 "test_torch_progress_engine.py", "test_torch_analysis.py",
                 "test_torch_sanitize_session.py"):  # CPU parity with JAX
        assert (REPO / "tests" / test).is_file()
    for cu in ("flash_attention", "ssd_scan", "moe_gmm", "grad_pack"):
        assert (REPO / "src" / "repro_torch" / "kernels" / "csrc" / f"{cu}.cu").is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = {root for root in _imported_roots(path) if root in ("jax", "jaxlib", "ml_dtypes", "repro")}
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
        init_cache(SMOKES["whisper-large-v3"], 1, 8)
    with pytest.raises(RuntimeError):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--arch", "tinyllama-1.1b", "--steps", "1"])
    with pytest.raises(RuntimeError):
        Trainer(SMOKES["tinyllama-1.1b"], OptHParams())
    with pytest.raises(RuntimeError):
        train_state_from_jax({"params": {}, "opt": {"mu": {}, "nu": {}, "count": 0}, "step": 0})


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    assert resolve_device("cpu").type == "cpu"
    cache = init_cache(SMOKES["tinyllama-1.1b"], 1, 8, device="cpu")
    assert cache["kv"]["pos"].device.type == "cpu"
    cache = init_cache(SMOKES["whisper-large-v3"], 1, 8, device="cpu")
    assert {t.device.type for c in cache.values() for t in c.values()} == {"cpu"}
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
    # the bf16 tensor-core route: every head dim, every mask, B = 2, tails
    # below one tile, and the train shape
    (1, 130, 4, 2, 16, True, 0, 0, torch.bfloat16),
    (2, 200, 8, 2, 32, True, 0, 0, torch.bfloat16),
    (1, 777, 16, 16, 128, True, 0, 0, torch.bfloat16),  # deepseek-moe-16b's attention
    (1, 77, 4, 2, 128, False, 0, 0, torch.bfloat16),
    (2, 256, 4, 2, 64, True, 0, 128, torch.bfloat16),
    (2, 256, 8, 2, 64, True, 64, 0, torch.bfloat16),
    (1, 1, 4, 2, 64, True, 0, 0, torch.bfloat16),
    (1, 15, 4, 2, 64, True, 0, 0, torch.bfloat16),
    (2, 65, 4, 2, 32, False, 0, 0, torch.bfloat16),
    (4, 1024, 32, 4, 64, True, 0, 0, torch.bfloat16),  # tinyllama-1.1b's train step
    (1, 1500, 20, 20, 64, False, 0, 0, torch.bfloat16),  # whisper-large-v3's encoder: bidir, ragged S
    (1, 1280, 64, 8, 128, True, 0, 0, torch.bfloat16),  # internvl2-76b: 256 prefix + 1024 tokens
    (1, 2304, 40, 8, 128, True, 0, 1024, torch.bfloat16),  # llama4-scout's chunked layers, boundaries inside S
    (1, 2304, 40, 8, 128, True, 0, 0, torch.bfloat16),  # and its global layers
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
def test_cuda_flash_refuses_a_layout_the_copies_cannot_take():
    """The bf16 route copies 16 bytes at a time: a q, k or v whose start or
    (B, S, H) strides do not sit on 16 bytes is refused (ValueError, no
    launch), never copied; the same values laid out well run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randn((1, 64, 2 * 64 + 4), generator=gen, device="cuda").to(torch.bfloat16)
    odd_rows = buf.as_strided((1, 64, 2, 64), (64 * 132, 132, 64, 1))  # S stride 132
    odd_start = buf.view(-1)[1:1 + 64 * 2 * 64].view(1, 64, 2, 64)  # starts 2 bytes off
    good = odd_rows.contiguous()
    before = flash_attention.launches
    for bad in (odd_rows, odd_start):
        for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
            with pytest.raises(ValueError, match="16 bytes"):
                flash_attention(*args)
    assert flash_attention.launches == before
    out = flash_attention(good, good, good)
    torch.cuda.synchronize()
    assert (out.float() - attention_plain(good, good, good).float()).abs().max().item() < 4e-2


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
    # the bf16 tensor-core route: Q of 2 and 8 tiles and a ragged Q (not a
    # multiple of 16), P = 32, N = 64 and 128, groups, one chunk, and
    # ragged P and N (zero-filled pieces of 8 bytes)
    ((1, 4, 1, 2, 32, 64, 128), torch.bfloat16),
    ((1, 2, 1, 2, 128, 64, 64), torch.bfloat16),
    ((2, 4, 2, 3, 20, 64, 64), torch.bfloat16),
    ((1, 8, 8, 1, 64, 32, 128), torch.bfloat16),
    ((2, 4, 2, 3, 64, 32, 64), torch.bfloat16),
    ((1, 6, 2, 3, 64, 64, 128), torch.bfloat16),
    ((1, 4, 1, 1, 64, 64, 128), torch.bfloat16),
    ((2, 8, 1, 3, 8, 16, 16), torch.bfloat16),
    ((1, 3, 1, 2, 36, 20, 44), torch.bfloat16),
])
def test_cuda_ssd_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import DTYPES, _lib, smem_bytes, ssd_chunk_kernel, ssd_chunk_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, h, g, nc, q, p, n = case
    assert smem_bytes(q, p, n, dtype) == _lib().repro_ssd_chunk_smem_bytes(DTYPES[dtype], q, p, n)
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
    # rows off 16 bytes (x and b: row strides of P + 2 and N + 2 elements)
    # and a start off 16 bytes (c) give the same bits as aligned ones
    xo = torch.nn.functional.pad(x, (0, 2))[..., :p]
    bo = torch.nn.functional.pad(b, (0, 2))[..., :n]
    co = torch.empty(c.numel() + 1, dtype=dtype, device="cuda")[1:].view_as(c).copy_(c)
    yo, so = ssd_chunk_kernel(a, xo, bo, co)
    assert torch.equal(yo, y) and torch.equal(so, st)
    with pytest.raises(ValueError):
        ssd_chunk_kernel(a, x.transpose(-1, -2).contiguous().transpose(-1, -2), b, c)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (B, H, G, nc, Q, P, N): 6 heads over 2 groups (slices of 2 leave 2 + 1
    # heads a group), and mamba2-130m's prefill
    (1, 6, 2, 3, 64, 64, 128),
    (1, 24, 1, 16, 64, 64, 128),
])
def test_cuda_ssd_heads_per_block_gives_the_same_bits(case):
    """The bf16 route computes S = C·Bᵀ once a block for a slice of a
    group's heads: every slice size, one that does not divide the group's
    heads included, gives the same bits as one head a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import DTYPES, _lib, _opt_in, smem_bytes, ssd_chunk_kernel, ssd_chunk_plain

    bsz, h, g, nc, q, p, n = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    a = -torch.randn((bsz, h, nc, q), generator=gen, device="cuda").abs() * 0.1
    x = torch.randn((bsz, h, nc, q, p), generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    c = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    y, st = ssd_chunk_kernel(a, x, b, c)
    _opt_in(x.device, DTYPES[torch.bfloat16], smem_bytes(q, p, n, torch.bfloat16))
    for hpb in range(1, h // g + 1):
        yk, sk = torch.empty_like(y), torch.empty_like(st)
        rc = _lib().repro_ssd_chunk_fwd(
            a.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), yk.data_ptr(), sk.data_ptr(),
            DTYPES[torch.bfloat16], bsz, h, g, nc, q, p, n, hpb,
            *a.stride(), *x.stride()[:4], *b.stride()[:4], *c.stride()[:4],
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.equal(yk, y) and torch.equal(sk, st), f"{hpb} heads a block"
    py, ps = ssd_chunk_plain(a, x, b, c)
    assert (y.float() - py.float()).abs().max().item() <= 2.0**-7 * py.float().abs().max().item()
    assert (st - ps).abs().max().item() <= 1e-4 * max(1.0, ps.abs().max().item())


def test_ssd_heads_per_block_fills_one_wave():
    """The bf16 route's slice of heads: the fewest that fit the cells into
    one wave of the card's block slots, within [1, the group's heads]."""
    from repro_torch.kernels.ssd_scan import heads_per_block

    assert heads_per_block(384, 24, 396) == 1  # mamba2-130m at S=1024: 384 cells, 132 SMs x 3
    assert heads_per_block(1024, 64, 528) == 2  # zamba2-1.2b at S=1024: 1024 cells, 132 SMs x 4
    assert heads_per_block(1024, 64, 396) == 3
    assert heads_per_block(10**6, 24, 396) == 24  # never past the group
    assert heads_per_block(1, 1, 396) == 1


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
    # ragged bf16 on the tensor-core route: C below, at and past one
    # 128-row tile; D and F off every tile and off 16 bytes
    ((2, 1, 70, 45), torch.bfloat16, 0.05),
    ((2, 127, 70, 45), torch.bfloat16, 0.05),
    ((2, 129, 70, 45), torch.bfloat16, 0.05),
    # llama4-scout at its init's scale 1/sqrt(E): a 1024-token prefill's
    # gate/up and down (top-1, capacity 80), and a decode step of 8 slots
    ((16, 80, 5120, 8192), torch.bfloat16, 0.25),
    ((16, 80, 8192, 5120), torch.bfloat16, 0.25),
    ((16, 32, 5120, 8192), torch.bfloat16, 0.25),
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
    assert (c == 1 or not xs.is_contiguous()) and not ws.is_contiguous()  # (E, 1, D) has no D-major layout
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
    # deepseek-moe-16b's gate/up: rows 0-31 of a prefill's C = 120 queues
    # equal the same rows run as a decode step's C = 32
    x = torch.randn((64, 120, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((64, 2048, 1408), generator=gen, device="cuda") / 8).to(torch.bfloat16)
    assert torch.equal(grouped_matmul(x, w)[:, :32], grouped_matmul(x[:, :32].contiguous(), w))


@pytest.mark.gpu
def test_cuda_grouped_matmul_reads_padded_rows_as_packed_ones():
    """Rows that start on 16 bytes inside wider buffers (the route of
    16-byte copies, with pieces cut short at D and F) and the same values
    packed (rows off 16 bytes: scalar loads) give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.moe_gmm import grouped_matmul, grouped_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    xbuf = torch.randn((2, 129, 80), generator=gen, device="cuda").to(torch.bfloat16)
    wbuf = (torch.randn((2, 70, 48), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    x, w = xbuf[:, :, :70], wbuf[:, :, :45]
    out = grouped_matmul(x, w)
    torch.cuda.synchronize()
    ref = grouped_matmul_plain(x, w)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-7 * ref.float().abs().max().item()
    assert torch.equal(grouped_matmul(x.contiguous(), w.contiguous()), out)


@pytest.mark.gpu
def test_cuda_bf16_routes_run_on_the_tensor_cores():
    """The built flash-attention, grouped-matmul and SSD libraries hold
    tensor-core products (``HMMA``, or Hopper's ``HGMMA``) in their SASS, read by
    ``cuobjdump`` from the toolkit of ``nvcc``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess

    from repro_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    for name, lib in build.build(["flash_attention", "moe_gmm", "ssd_scan"]).items():
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        assert "HMMA" in sass or "HGMMA" in sass, f"{name}: no tensor-core instruction in {lib.name}"


def test_an_edited_header_rebuilds_every_kernel(tmp_path, monkeypatch):
    """Libraries are named by the source, every ``csrc/*.cuh`` and the
    flags: an edit to a shared header gives every kernel a new name, an
    untouched tree the same one."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("flash_attention", "moe_gmm", "ssd_scan", "grad_pack")
    before = {n: build._target(n) for n in names}
    assert before == {n: build._target(n) for n in names}
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["tensor_core.cuh"]
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: build._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "new_helpers.cuh").write_text("#pragma once\n")
    assert all(build._target(n) != after[n] for n in names)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_to_detach_under_autograd():
    """Each wrapper hands raw pointers to its kernel: under grad mode, an
    input that requires grad is refused (RuntimeError) rather than given a
    result with no ``grad_fn``; under ``no_grad`` the same call runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    calls = [
        (flash_attention, (rnd(1, 64, 4, 64), rnd(1, 64, 2, 64), rnd(1, 64, 2, 64))),
        (ssd_chunk_kernel, (-rnd(1, 2, 2, 16).abs() * 0.1, rnd(1, 2, 2, 16, 16), rnd(1, 1, 2, 16, 16), rnd(1, 1, 2, 16, 16))),
        (grouped_matmul, (rnd(2, 8, 16), rnd(2, 16, 8))),
    ]
    for fn, args in calls:
        for i in range(len(args)):
            grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
            before = fn.launches
            with pytest.raises(RuntimeError, match="detached"):
                fn(*grad_args)
            assert fn.launches == before
            with torch.no_grad():
                fn(*grad_args)
            assert fn.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_function_grads_match_the_plain_path(dtype, monkeypatch):
    """Gradients through ``FlashAttentionFn`` (forward: the kernel; backward:
    the reference lowering's gradient from the saved q, k, v) against the
    plain path.  At the op, dq/dk/dv equal autograd through the lowering
    bit for bit (the backward recomputes exactly that), and the outputs
    agree within the kernel's own tolerance (5e-5 f32, 4e-2 bf16).  Through
    the smoke model's loss, every gradient leaf is within 1e-4 (f32) or
    5e-2 (bf16: the kernel rounds p to bf16 before PV, and the difference
    reaches the weights' gradients) of the largest |grad| of the run with
    the plain attention swapped in; the kernel launches once per layer per
    forward, and again in each recompute under remat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.models.attention import FlashAttentionFn, _attention_core_plain
    from repro_torch.train import init_train_state
    from repro_torch.train.step import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 96, h, 64), generator=gen, device="cuda").to(dtype) for h in (8, 2, 2))
    dout = torch.randn((2, 96, 8, 64), generator=gen, device="cuda").to(dtype)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = FlashAttentionFn.apply(qa, ka, va, "full", 0)
    out.backward(dout)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    pos = torch.arange(96, dtype=torch.int32, device="cuda")
    ref = _attention_core_plain(qb, kb, vb, pos, pos, "full", 0)
    ref.backward(dout)
    assert (out.float() - ref.float()).abs().max().item() < (5e-5 if dtype == torch.float32 else 4e-2)
    for a, b in ((qa, qb), (ka, kb), (va, vb)):
        assert torch.equal(a.grad, b.grad)

    cfg = SMOKES["tinyllama-1.1b"].variant(dtype="float32" if dtype == torch.float32 else "bfloat16")
    params = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg)["params"]
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for remat, per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        before = flash_attention.launches
        (lk, _), gk = loss_and_grads(params, cfg, batch, remat)
        assert flash_attention.launches - before == per_layer * cfg.n_layers, remat
    with monkeypatch.context() as m:
        m.setattr(ops, "attention", lambda q, k, v, **kw: attention_plain(q, k, v, **kw))
        (lp, _), gp = loss_and_grads(params, cfg, batch, "none")
    from repro_torch.tree import leaves

    gmax = max(g.float().abs().max().item() for g in leaves(gp))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert abs(lk.item() - lp.item()) <= tol * max(1.0, abs(lp.item()))
    for a, b in zip(leaves(gk), leaves(gp)):
        assert (a.float() - b.float()).abs().max().item() <= tol * gmax


def _ssd_fn_inputs(bsz, h, g, nc, q, p, n, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = -torch.randn((bsz, h, nc, q), generator=gen, device=device).abs() * 0.1
    x = torch.randn((bsz, h, nc, q, p), generator=gen, device=device).to(dtype)
    b = (torch.randn((bsz, g, nc, q, n), generator=gen, device=device) * 0.3).to(dtype)
    c = (torch.randn((bsz, g, nc, q, n), generator=gen, device=device) * 0.3).to(dtype)
    dy = torch.randn((bsz, h, nc, q, p), generator=gen, device=device).to(dtype)
    dst = torch.randn((bsz, h, nc, p, n), generator=gen, device=device)
    return (a, x, b, c), (dy, dst)


def _grads_through(fn, ins, douts):
    ins = [t.clone().requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, douts)
    return outs, [t.grad for t in ins]


@pytest.mark.parametrize("case", [(2, 4, 1, 3, 8, 16, 16), (1, 6, 2, 2, 16, 8, 8)], ids=["G1", "G2"])
def test_ssd_function_grads_equal_the_plain_path_on_the_cpu(case):
    """On CPU tensors ``SSDChunkFn`` (forward: the wrapper, which takes the
    plain version there) gives the outputs and input gradients of autograd
    through ``ssd_chunk_plain``, bit for bit; db and dc are summed over the
    heads of each group.  Under ``inference_mode`` (serving) it runs with no
    graph."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_plain
    from repro_torch.models.ssm import SSDChunkFn

    ins, douts = _ssd_fn_inputs(*case, torch.float32, "cpu", sum(case))
    outs, grads = _grads_through(SSDChunkFn.apply, ins, douts)
    ref_outs, ref_grads = _grads_through(ssd_chunk_plain, ins, douts)
    for a, b in zip(outs + tuple(grads), ref_outs + tuple(ref_grads)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    bsz, h, g = case[:3]
    assert grads[2].shape == (bsz, g) + case[3:5] + (case[6],)  # db per group, not per head
    # the group sum: db equals the per-head gradients (b repeated to H groups) summed
    a, x, b, c = ins
    rep = h // g
    _, per_head = _grads_through(ssd_chunk_plain, (a, x, b.repeat_interleave(rep, 1), c.repeat_interleave(rep, 1)), douts)
    for got, heads in ((grads[2], per_head[2]), (grads[3], per_head[3])):
        summed = heads.reshape((bsz, g, rep) + heads.shape[2:]).sum(2)
        assert torch.allclose(got, summed, rtol=1e-5, atol=1e-6)
    with torch.inference_mode():
        y, st = SSDChunkFn.apply(*ins)
    assert torch.equal(y, outs[0]) and torch.equal(st, outs[1]) and y.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_function_grads_equal_the_plain_path_on_the_cpu(dtype):
    """On CPU tensors ``GroupedMatmulFn`` gives the output and the input
    gradients (dX = dY·Wᵀ, dW = Xᵀ·dY, in f32, cast back) of autograd
    through ``grouped_matmul_plain``, bit for bit."""
    from repro_torch.kernels.moe_gmm import grouped_matmul_plain
    from repro_torch.models.moe import GroupedMatmulFn

    gen = torch.Generator().manual_seed(7)
    x = torch.randn((3, 10, 24), generator=gen).to(dtype)
    w = (torch.randn((3, 24, 12), generator=gen) * 0.2).to(dtype)
    dy = torch.randn((3, 10, 12), generator=gen).to(dtype)
    outs, grads = _grads_through(GroupedMatmulFn.apply, (x, w), (dy,))
    ref_outs, ref_grads = _grads_through(grouped_matmul_plain, (x, w), (dy,))
    for a, b in zip(outs + tuple(grads), ref_outs + tuple(ref_grads)):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_function_grads_match_the_plain_path(dtype):
    """``SSDChunkFn`` on the card: the forward is the kernel (one launch),
    within its own tolerance of the plain version (1e-4 at f32; at bf16 2
    bf16 ulps of max |y| and 1e-4 of max(1, max |state|)), and the input
    gradients equal autograd through ``ssd_chunk_plain`` bit for bit (the
    backward recomputes exactly that), db and dc summed over a group's
    heads (G=1, H=4), at the smoke configs' and mamba2's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel, ssd_chunk_plain
    from repro_torch.models.ssm import SSDChunkFn

    torch.backends.cuda.matmul.allow_tf32 = False
    for case in ((2, 4, 1, 3, 8, 16, 16), (2, 24, 1, 4, 64, 64, 128)):
        ins, douts = _ssd_fn_inputs(*case, dtype, "cuda", sum(case))
        before = ssd_chunk_kernel.launches
        outs, grads = _grads_through(SSDChunkFn.apply, ins, douts)
        torch.cuda.synchronize()
        assert ssd_chunk_kernel.launches == before + 1
        ref_outs, ref_grads = _grads_through(ssd_chunk_plain, ins, douts)
        (y, st), (py, ps) = outs, ref_outs
        if dtype == torch.float32:
            assert (y - py).abs().max().item() <= 1e-4 and (st - ps).abs().max().item() <= 1e-4
        else:
            assert (y.float() - py.float()).abs().max().item() <= 2.0**-7 * py.float().abs().max().item()
            assert (st - ps).abs().max().item() <= 1e-4 * max(1.0, ps.abs().max().item())
        for a, b in zip(grads, ref_grads):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_matmul_function_grads_match_the_plain_path(dtype):
    """``GroupedMatmulFn`` on the card: the forward is the kernel (one
    launch, no copy), within its own tolerance of the plain version (1e-4
    at f32, 2 bf16 ulps of max |out| at bf16), and dX, dW equal autograd
    through ``grouped_matmul_plain`` bit for bit, at a ragged shape and at
    deepseek-moe-16b's gate/up shape of a B=4, S=1024 train step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.moe_gmm import grouped_matmul, grouped_matmul_plain
    from repro_torch.models.moe import GroupedMatmulFn

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    for e, c, d, f in ((3, 33, 70, 45), (64, 480, 2048, 1408)):
        x = torch.randn((e, c, d), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((e, d, f), generator=gen, device="cuda") / math.sqrt(e)).to(dtype)
        dy = torch.randn((e, c, f), generator=gen, device="cuda").to(dtype)
        before, copies = grouped_matmul.launches, grouped_matmul.copies
        (out,), grads = _grads_through(GroupedMatmulFn.apply, (x, w), (dy,))
        torch.cuda.synchronize()
        assert grouped_matmul.launches == before + 1 and grouped_matmul.copies == copies
        (ref,), ref_grads = _grads_through(grouped_matmul_plain, (x, w), (dy,))
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= (1e-4 if dtype == torch.float32 else 2.0**-7 * ref.float().abs().max().item())
        for a, b in zip(grads, ref_grads):
            assert a.dtype == dtype and torch.equal(a, b)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only), for its ``plain_kernels`` and ``routes`` helpers."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b", "deepseek-moe-16b"])
def test_cuda_family_trains_run_their_kernels(arch, dtype):
    """Through a smoke model's loss on the card: the SSD kernel launches
    once an SSM layer a forward, flash once an attention layer (zamba2's
    shared block every ``attn_every``-th layer), the grouped matmul three
    times a MoE layer, each twice under ``remat="full"`` (the recompute);
    no operand is copied; and the loss and every gradient leaf are within
    1e-4 (f32) or 5e-2 (bf16, as flash's test) of the largest |grad| of
    the run with every kernel's plain version swapped in (deepseek's plain
    run on the kernel run's expert choices, its gates and aux loss from its
    own router: ``chip_smoke.routes(regate=True)``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel
    from repro_torch.train import init_train_state
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKES[arch].variant(dtype="float32" if dtype == torch.float32 else "bfloat16")
    params = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg)["params"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    attn = -(-cfg.n_layers // cfg.attn_every) if cfg.family == "hybrid" else (cfg.n_layers if ssm == 0 else 0)
    per_forward = {"ssd": ssm, "flash": attn, "gmm": 3 * cfg.n_layers if cfg.is_moe else 0}
    kernels = {"ssd": ssd_chunk_kernel, "flash": flash_attention, "gmm": grouped_matmul}
    smoke = _chip_smoke()
    copies = grouped_matmul.copies
    for remat, times in (("none", 1), ("full", 2)):
        before = {k: fn.launches for k, fn in kernels.items()}
        with smoke.routes() as rk:
            (lk, _), gk = loss_and_grads(params, cfg, batch, remat)
        torch.cuda.synchronize()
        got = {k: fn.launches - before[k] for k, fn in kernels.items()}
        assert got == {k: times * n for k, n in per_forward.items()}, remat
        if remat == "none":
            choices, loss_k, grads_k = rk.routes, lk, gk
    assert grouped_matmul.copies == copies
    with smoke.plain_kernels(ops), smoke.routes(choices if cfg.is_moe else None, regate=True):
        (lp, _), gp = loss_and_grads(params, cfg, batch, "none")
    gmax = max(g.float().abs().max().item() for g in leaves(gp))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert abs(loss_k.item() - lp.item()) <= tol * max(1.0, abs(lp.item()))
    for a, b in zip(leaves(grads_k), leaves(gp)):
        assert torch.isfinite(a).all() and (a.float() - b.float()).abs().max().item() <= tol * gmax


@pytest.mark.gpu
def test_cuda_cross_attention_takes_the_plain_path():
    """On the card, queries and keys of different lengths (a decoder's
    cross-attention over the encoder's frames) take the plain path by the
    shape test and launch nothing, prompt and train path alike; one length
    launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 24, 4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((2, 40, 4, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    qpos, kpos = torch.arange(24, device="cuda"), torch.arange(40, device="cuda")
    before = flash_attention.launches
    out = attn._attention_core(q, k, v, qpos, kpos, "bidir", 0)
    assert flash_attention.launches == before
    assert torch.equal(out, attn._attention_core_plain(q, k, v, qpos, kpos, "bidir", 0))
    cfg = SMOKES["whisper-large-v3"]
    p = attn.attn_init(torch.Generator(device="cuda").manual_seed(1), cfg, torch.bfloat16, cross=True)
    x = torch.randn((2, 24, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    enc = torch.randn((2, 40, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        attn.attention_train(p, x, cfg, "bidir", kv_x=enc, rope=False)
        assert flash_attention.launches == before
        attn.attention_train(p, enc, cfg, "bidir", rope=False)  # the encoder's self-attention
    assert flash_attention.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-large-v3", "internvl2-76b", "llama4-scout-17b-a16e"])
def test_cuda_new_families_launch_their_kernels(arch):
    """A bf16 smoke model's prefill and decode step on the card: flash once
    an attention layer a prefill (whisper's encoder and decoder
    self-attention; none for MLA, none for cross-attention), the grouped
    matmul three times a MoE layer a model call, nothing else; the logits
    finite and within 5% of max |logit| of the same calls with every
    kernel's plain version swapped in (llama4's on the kernel run's
    routing: ``chip_smoke.routes``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.models import decode_step, init_params, prefill

    cfg = SMOKES[arch]
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device="cuda")}
    if cfg.frontend == "vision":
        batch["prefix"] = torch.randn((2, cfg.n_prefix_tokens, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.full((2,), 40 + (cfg.n_prefix_tokens if "prefix" in batch else 0), dtype=torch.int32, device="cuda")
    nxt = torch.zeros((2, 1), dtype=torch.long, device="cuda")
    flash = 0 if cfg.attn_kind == "mla" else cfg.n_layers + cfg.encoder_layers
    gmm = 3 * cfg.n_layers if cfg.is_moe else 0
    smoke = _chip_smoke()

    def run():
        with torch.inference_mode():
            lp, _ = prefill(params, cfg, batch, init_cache(cfg, 2, 64, "cuda"))
            c = init_cache(cfg, 2, 64, "cuda")
            prefill(params, cfg, batch, c)
            ld, _ = decode_step(params, cfg, nxt, pos, c)
        return lp, ld

    before = (flash_attention.launches, grouped_matmul.launches)
    with smoke.routes() as rk:
        lk = run()
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0], grouped_matmul.launches - before[1]) == (2 * flash, 3 * gmm)
    with smoke.plain_kernels(ops), smoke.routes(rk.routes if cfg.is_moe else None):
        lpl = run()
    for a, b in zip(lk, lpl):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= 5e-2 * b.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-large-v3", "internvl2-76b", "llama4-scout-17b-a16e"])
def test_cuda_remat_modes_relaunch_the_kernels_and_keep_the_gradients(arch):
    """A bf16 smoke train step of the MLA, encoder-decoder, VLM and llama4
    families on the card under ``remat="full"`` and ``"dots"``: every
    decoder layer's kernels launch twice (the forward and the recompute: flash once a self-attention
    layer, the grouped matmul three times a MoE layer; MLA none), the
    encoder's once (it is not rematerialised, as in the reference); the
    loss and every gradient leaf within the bf16 tolerance (5e-2 of the
    largest |grad|, as flash's test) of ``remat="none"``'s.  The chip
    smoke's one remat train (minicpm3) launches no kernel, so this test
    pins remat on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.train import init_train_state
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    cfg = SMOKES[arch]
    params = init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg)["params"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        batch["prefix"] = torch.randn((2, cfg.n_prefix_tokens, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    if cfg.is_encdec:
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    dec_flash = 0 if cfg.attn_kind == "mla" else cfg.n_layers
    gmm = 3 * cfg.n_layers if cfg.is_moe else 0
    runs = {}
    for remat, times in (("none", 1), ("full", 2), ("dots", 2)):
        before = (flash_attention.launches, grouped_matmul.launches)
        runs[remat] = loss_and_grads(params, cfg, batch, remat)
        torch.cuda.synchronize()
        got = (flash_attention.launches - before[0], grouped_matmul.launches - before[1])
        assert got == (times * dec_flash + cfg.encoder_layers, times * gmm), remat
    (l0, _), g0 = runs["none"]
    gmax = max(g.float().abs().max().item() for g in leaves(g0))
    for remat in ("full", "dots"):
        (l1, _), g1 = runs[remat]
        assert abs(l1.item() - l0.item()) <= 5e-2 * max(1.0, abs(l0.item())), remat
        for a, b in zip(leaves(g1), leaves(g0)):
            assert torch.isfinite(a).all() and (a.float() - b.float()).abs().max().item() <= 5e-2 * gmax, remat
