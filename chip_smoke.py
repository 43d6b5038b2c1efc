#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's serving path (``src/repro_torch``) and nothing of the
JAX package.  In order, it:

1. prints the card's name and power limit and builds the CUDA kernels from
   the sources in the checkout;
2. holds every kernel against its plain PyTorch version on the card, at
   the reference's test shapes and at the shapes the serving path gives it;
3. builds ``tinyllama-1.1b`` at full width (bf16, random weights from a
   fixed seed) and holds its prefill logits through the kernel against the
   same prefill with attention forced through the plain version;
4. serves 16 requests from 2 client threads through ``InferenceServer``
   over the collective comm hand-off, with every kernel's launch count set
   to 0 just before and read just after;
5. times each kernel, its plain version and the library call computing the
   same function, with CUDA events;
6. prints one JSON line of the kernels and, last, the device line.

It exits non-zero, printing no result, without a card or outside a
checkout, and on any failed check.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3 bandwidth.  The bound is taken against these at any power limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# (B, S, H, KV, D, causal, window, chunk, dtype): the reference's FLASH_CASES
# (tests/test_kernels.py), then the serving path's own shape and a ragged S
FLASH_CASES = [
    (2, 256, 4, 2, 64, True, 0, 0, "float32"),
    (1, 512, 4, 4, 128, True, 0, 0, "float32"),
    (2, 256, 8, 2, 64, True, 64, 0, "float32"),
    (2, 256, 4, 2, 64, True, 0, 128, "float32"),
    (1, 256, 8, 2, 64, False, 0, 0, "float32"),
    (1, 256, 4, 2, 128, True, 0, 0, "bfloat16"),
    (1, 128, 2, 2, 64, True, 0, 0, "float32"),
    (1, 384, 6, 3, 64, True, 128, 0, "float32"),
    (2, 128, 2, 1, 32, True, 0, 0, "float32"),
]
SLICE_CASE = (1, 512, 32, 4, 64, True, 0, 0, "bfloat16")
RAGGED_CASE = (1, 200, 32, 4, 64, True, 0, 0, "bfloat16")
# 5e-5 at f32 (full-f32 products, only the summation order differs);
# 4e-2 at bf16 (the kernel rounds p to bf16 before PV, the plain version
# keeps f32 to the end): the reference's own tolerances
TOL = {"float32": 5e-5, "bfloat16": 4e-2}
# Full-width prefill logits, kernel vs plain attention, both in bf16 through
# 22 layers: each layer's attention output differs by bf16 roundings
# (relative 2^-8), which the residual stream carries to the logits.  Held
# to 5% of the largest logit.
LOGIT_REL_TOL = 5e-2

PROMPT_LENS = [128, 200, 256, 333, 384, 512, 640, 700, 768, 896, 1000, 1024, 129, 455, 960, 777]
N_CLIENTS = 2
MAX_NEW = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(case, gen):
    import torch

    b, s, h, kv, d, _, _, _, dtype = case
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
    return q, k, v


def check_attention(flash_attention, attention_plain, gen) -> dict:
    """Phase 2: kernel vs plain on every case; returns {case: max_abs_err}."""
    import torch

    errs = {}
    for case in FLASH_CASES + [SLICE_CASE, RAGGED_CASE]:
        _, _, _, _, _, causal, window, chunk, dtype = case
        q, k, v = attention_inputs(case, gen)
        out = flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, causal=causal, window=window, chunk=chunk)
        err = (out.float() - ref.float()).abs().max().item()
        ok = math.isfinite(err) and err < TOL[dtype]
        print(f"flash_attention {case}: max_abs_err={err} tol={TOL[dtype]} {'ok' if ok else 'MISS'}")
        if not ok:
            fail(f"flash_attention disagrees with attention_plain at {case}: {err}")
        errs[case] = err
    return errs


def attention_bound_ms(case) -> tuple:
    """Least time for the work this case needs: q, k, v, out moved once;
    2 products of 2 operations per visible (query, key) pair per head dim."""
    b, s, h, kv, d, causal, window, chunk, dtype = case
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * b * s * d * (2 * h + 2 * kv)
    pairs = s * (s + 1) // 2 if causal and not window and not chunk else s * s
    flops = 4 * b * h * d * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as exc:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {exc}")
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        fail(f"repro_torch was imported from {repro_torch.__file__}, not from this checkout")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.serve import InferenceServer, ServeConfig

    # full-f32 products for the f32 comparisons, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card and the build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.monotonic()
    build.build(["flash_attention"])
    print(f"kernel build: {time.monotonic() - t0} s")

    # 2. every kernel against its plain version ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_attention(flash_attention, attention_plain, gen)

    # 3. full-width tinyllama-1.1b prefill, kernel vs plain attention ---------
    arch = get_config("tinyllama-1.1b")
    t0 = time.monotonic()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"tinyllama-1.1b: {n_params} params ({arch.dtype}) built in {time.monotonic() - t0} s")
    prompt = torch.randint(0, arch.vocab_size, (1, 777), generator=gen, device="cuda")
    with torch.inference_mode():
        logits_k, _ = prefill(params, arch, {"tokens": prompt}, init_cache(arch, 1, 2048))
        kernel_attention = ops.attention
        ops.attention = lambda q, k, v, **kw: attention_plain(q, k, v, **kw)
        try:
            logits_p, _ = prefill(params, arch, {"tokens": prompt}, init_cache(arch, 1, 2048))
        finally:
            ops.attention = kernel_attention
    if logits_k.shape != (1, 1, arch.vocab_size) or not torch.isfinite(logits_k).all():
        fail(f"prefill logits malformed: shape {tuple(logits_k.shape)}")
    scale = logits_p.float().abs().max().item()
    lerr = (logits_k.float() - logits_p.float()).abs().max().item()
    print(f"prefill logits (S=777) kernel vs plain attention: max_abs_err={lerr} max|logit|={scale} "
          f"rel={lerr / scale} tol={LOGIT_REL_TOL}")
    if not lerr <= LOGIT_REL_TOL * scale:
        fail(f"full-width prefill through the kernel disagrees with plain attention: {lerr} vs {scale}")
    first_tok = int(torch.argmax(logits_k[0, -1]))

    # 4. serve through the comm hand-off --------------------------------------
    server = InferenceServer(
        arch, params, ServeConfig(slots=8, context=2048, max_prefill=1024, transport="collective")
    )
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=rng).tolist() for n in PROMPT_LENS]
    prompts[-1] = prompt[0].tolist()  # the phase-3 prompt: its first token is known
    reqs, lock = [None] * len(prompts), threading.Lock()

    def client(idx):
        for i in idx:
            r = server.submit(prompts[i], max_new=MAX_NEW)
            with lock:
                reqs[i] = r
            time.sleep(0.001)

    flash_attention.launches = 0
    torch.cuda.synchronize()
    threads = [threading.Thread(target=client, args=(range(c, len(prompts), N_CLIENTS),)) for c in range(N_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads) or not server.idle():
        if not server.step():
            time.sleep(1e-3)
    for t in threads:
        t.join(timeout=60)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = flash_attention.launches
    done = [r for r in reqs if r is not None and r.done_event.is_set()]
    ttft = sorted(r.first_token_at - r.submitted_at for r in done)
    print(
        f"serve: requests={len(done)}/{len(prompts)} engine_steps={server.steps} tokens={server.tokens_out} "
        f"throughput={server.tokens_out / dt} tok/s ttft_p50={ttft[len(ttft) // 2] * 1e3 if ttft else float('nan')} ms "
        f"wall={dt} s prefill={server.core.prefill_seconds} s decode={server.core.decode_seconds} s "
        f"flash_attention.launches={launches} transport=collective"
    )
    if len(done) != len(prompts):
        fail(f"served {len(done)} of {len(prompts)} requests")
    bad = [r.rid for r in done if len(r.out_tokens) != MAX_NEW or not all(0 <= t < arch.vocab_size for t in r.out_tokens)]
    if bad:
        fail(f"requests {bad} came back with a wrong number of tokens or out-of-vocab tokens")
    if reqs[-1].out_tokens[0] != first_tok:
        fail(f"served first token {reqs[-1].out_tokens[0]} != the phase-3 prefill's argmax {first_tok}")
    if launches != arch.n_layers * len(prompts):
        fail(f"flash_attention launched {launches} times, want one per layer per prefill ({arch.n_layers * len(prompts)})")

    # 5. times at the serving path's shape ------------------------------------
    q, k, v = attention_inputs(SLICE_CASE, gen)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's (B,H,S,D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms_kernel = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    ms_plain = cuda_ms(lambda: attention_plain(q, k, v, causal=True))
    ms_lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    ms_kernel2 = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    bound, bound_by = attention_bound_ms(SLICE_CASE)
    print(f"flash_attention {SLICE_CASE}: kernel={ms_kernel} ms (again {ms_kernel2} ms) plain={ms_plain} ms "
          f"sdpa={ms_lib} ms bound={bound} ms ({bound_by})")

    # 6. the record ---------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:38",
        "launches": launches,
        "max_abs_err": errs[SLICE_CASE],
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": ms_lib,
        "check": "pass",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
