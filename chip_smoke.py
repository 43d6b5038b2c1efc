#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's serving paths (``src/repro_torch``) and nothing of
the JAX package.  In order, it:

1. prints the card's name and power limit and builds the CUDA kernels from
   the sources in the checkout (one ``nvcc`` per source, all at once);
2. holds every kernel against its plain PyTorch version on the card, at
   the reference's test shapes and at the shapes the serving paths give
   it, and the SSD kernel's route through ``ssd_chunked`` at a ragged S;
3. for each served model, ``tinyllama-1.1b`` (dense), ``mamba2-130m``
   (SSM) and ``zamba2-1.2b`` (hybrid), at full width (bf16, random weights
   from a fixed seed): holds its prefill logits through the kernels
   against the same prefill with every kernel's plain version swapped in,
   and both against the same weights in f32 through the plain versions;
4. then serves 16 requests from 2 client threads through
   ``InferenceServer`` over the collective comm hand-off, with every
   kernel's launch count set to 0 just before and read just after, and
   checks each kernel's launches on that path;
5. times each kernel, its plain version and the library yardstick for the
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
# zamba2-1.2b's shared block: H == KV (no GQA), kind swa with its 4096
# window, at the longest prompt it serves and at a ragged one
ZAMBA2_CASES = [(1, 1024, 32, 32, 64, True, 4096, 0, "bfloat16"), (1, 777, 32, 32, 64, True, 4096, 0, "bfloat16")]
# 5e-5 at f32 (full-f32 products, only the summation order differs);
# 4e-2 at bf16 (the kernel rounds p to bf16 before PV, the plain version
# keeps f32 to the end): the reference's own tolerances
TOL = {"float32": 5e-5, "bfloat16": 4e-2}
# Full-width prefill logits, kernels vs their plain versions, both in bf16
# through every layer: each layer's kernel output differs by bf16 roundings
# (relative 2^-8), which the residual stream carries to the logits.  Held
# to 5% of the largest logit, for every served model.
LOGIT_REL_TOL = 5e-2
# The gate that tells a wrong kernel from rounding: both bf16 runs against
# the same weights in f32 through the plain versions, as shares of that
# run's max |logit|.  The kernel run may be no farther from f32 than the
# plain run by more than F32_MARGIN (a wrong kernel adds its error on top of
# bf16's), and no farther than the model's cap in PATHS (about twice the
# plain run's own bf16 distance, measured on the card).
F32_MARGIN = 1e-2

# (B, H, G, nc, Q, P, N, dtype): the reference's SSD_CASES
# (tests/test_kernels.py), then the serving paths' own shapes at S=1024
SSD_CASES = [
    (2, 4, 2, 3, 64, 64, 128, "float32"),
    (1, 2, 1, 2, 128, 64, 64, "float32"),
    (1, 8, 8, 1, 64, 32, 128, "float32"),
    (2, 2, 1, 4, 32, 64, 32, "float32"),
]
SSD_MAMBA2 = (1, 24, 1, 16, 64, 64, 128, "bfloat16")  # mamba2-130m: d_inner 1536 / P 64
SSD_ZAMBA2 = (1, 64, 1, 16, 64, 64, 64, "bfloat16")  # zamba2-1.2b: d_inner 4096 / P 64
SSD_RAGGED_S = 1000  # ssd_chunked pads it to 16 chunks of 64
# f32: 1e-4, the reference's own tolerance.  bf16: both versions compute in
# f32 from the same bf16 inputs and round y to bf16 once, so y may differ by
# rounding at the boundary: 2 bf16 ulps (2^-7) of max |y|; the f32 states
# only by summation order: 1e-4 of max(1, max |state|).  Through
# ssd_chunked (ragged S) the bf16 inter-chunk recurrence adds roundings:
# 2^-6 of the largest magnitude.
SSD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-7}
SSD_STATE_REL_TOL = 1e-4
SSD_CHUNKED_REL_TOL = 2.0**-6

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
    for case in FLASH_CASES + [SLICE_CASE, RAGGED_CASE] + ZAMBA2_CASES:
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


def ssd_inputs(case, gen):
    """The reference test's scales: a_dt = -|N|*0.1, x ~ N, b/c ~ 0.3*N."""
    import torch

    bsz, h, g, nc, q, p, n, dtype = case
    dt = getattr(torch, dtype)
    a = -torch.randn((bsz, h, nc, q), generator=gen, device="cuda").abs() * 0.1
    x = torch.randn((bsz, h, nc, q, p), generator=gen, device="cuda").to(dt)
    b = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(dt)
    c = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(dt)
    return a, x, b, c


def check_ssd(ssd_chunk_kernel, ssd_chunk_plain, gen) -> dict:
    """Phase 2: the SSD kernel vs its plain version; returns {case: max_abs_err of y}."""
    import torch

    errs = {}
    for case in SSD_CASES + [SSD_MAMBA2, SSD_ZAMBA2]:
        dtype = case[-1]
        a, x, b, c = ssd_inputs(case, gen)
        y, st = ssd_chunk_kernel(a, x, b, c)
        torch.cuda.synchronize()
        py, ps = ssd_chunk_plain(a, x, b, c)
        err = (y.float() - py.float()).abs().max().item()
        serr = (st - ps).abs().max().item()
        if dtype == "float32":
            tol, stol = SSD_TOL[dtype], SSD_TOL[dtype]
        else:
            tol = SSD_TOL[dtype] * py.float().abs().max().item()
            stol = SSD_STATE_REL_TOL * max(1.0, ps.abs().max().item())
        ok = y.dtype == x.dtype and st.dtype == torch.float32 and math.isfinite(err + serr) and err <= tol and serr <= stol
        print(f"ssd_chunk_kernel {case}: y max_abs_err={err} tol={tol}; states max_abs_err={serr} tol={stol} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            fail(f"ssd_chunk_kernel disagrees with ssd_chunk_plain at {case}: y {err}, states {serr}")
        errs[case] = err
    return errs


def check_ssd_chunked_ragged(ops, ssd_chunk_plain, gen) -> None:
    """Phase 2: ``ssd_chunked`` at a ragged S through the kernel vs the same
    call with the plain version swapped in (mamba2-130m's widths, bf16)."""
    import torch

    from repro_torch.models.ssm import ssd_chunked

    _, h, g, _, q, p, n, dtype = SSD_MAMBA2
    dt, s = getattr(torch, dtype), SSD_RAGGED_S
    x = torch.randn((1, s, h, p), generator=gen, device="cuda").to(dt)
    a_dt = -torch.randn((1, s, h), generator=gen, device="cuda").abs() * 0.1
    b = (torch.randn((1, s, g, n), generator=gen, device="cuda") * 0.3).to(dt)
    c = (torch.randn((1, s, g, n), generator=gen, device="cuda") * 0.3).to(dt)
    with torch.inference_mode():
        yk, sk = ssd_chunked(x, a_dt, b, c, q)
        with plain_kernels(ops):
            yp, sp = ssd_chunked(x, a_dt, b, c, q)
    torch.cuda.synchronize()
    for name, k, pl in (("y", yk, yp), ("final_state", sk, sp)):
        err = (k.float() - pl.float()).abs().max().item()
        tol = SSD_CHUNKED_REL_TOL * pl.float().abs().max().item()
        ok = k.shape == pl.shape and math.isfinite(err) and err <= tol
        print(f"ssd_chunked S={s} (ragged, Q={q}) {name}: max_abs_err={err} tol={tol} {'ok' if ok else 'MISS'}")
        if not ok:
            fail(f"ssd_chunked through the kernel disagrees with the plain version at S={s}: {name} {err}")


class plain_kernels:
    """Within the block, the kernel entry points of ``ops`` run their plain
    PyTorch versions."""

    def __init__(self, ops):
        self.ops = ops

    def __enter__(self):
        from repro_torch.kernels.flash_attention import attention_plain
        from repro_torch.kernels.ssd_scan import ssd_chunk_plain

        self.saved = self.ops.attention, self.ops.ssd_chunk
        self.ops.attention = lambda q, k, v, **kw: attention_plain(q, k, v, **kw)
        self.ops.ssd_chunk = ssd_chunk_plain
        return self

    def __exit__(self, *exc):
        self.ops.attention, self.ops.ssd_chunk = self.saved
        return False


def ssd_yardstick(a, x, b, c):
    """The library yardstick, as a function of the kernel's inputs: the
    model's plain branch of steps 1 and 2 (``ssm._chunk_blocks_plain``, the
    reference's xla einsum chain in the model dtype), on the model-layout
    views that ``_chunk_blocks_kernel`` hands the kernel, with the a_dt
    cumsum and the C broadcast it needs.  No single library call computes
    this function."""
    import torch

    from repro_torch.models.ssm import _chunk_blocks_plain

    bsz, h, nc, q = a.shape
    g, n = b.shape[1], b.shape[-1]
    xc, ac = x.permute(0, 2, 3, 1, 4), a.permute(0, 2, 3, 1)  # (B,nc,Q,H,P), (B,nc,Q,H)
    bm, cm = b.permute(0, 2, 3, 1, 4), c.permute(0, 2, 3, 1, 4)  # (B,nc,Q,G,N)

    def run():
        a_cum = torch.cumsum(ac, dim=2)
        cc = cm.repeat_interleave(h // g, dim=3)
        return _chunk_blocks_plain(xc, ac, a_cum, bm, cc, bsz, nc, q, g, n, h // g)

    return run


def ssd_bound_ms(case) -> tuple:
    """Least time for the work this case needs: a_dt, x, b, c read once, y
    and the f32 states written once; operations counted on the causal half
    (j <= i) that the data needs: C.B^T (2N per pair), the decay (1 per
    pair), the product with X (2P per pair), the decay-weighted B (Q*N) and
    the state product (2QPN), per (batch, head, chunk)."""
    bsz, h, g, nc, q, p, n, dtype = case
    item = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * bsz * h * nc * q + item * bsz * nc * q * (2 * h * p + 2 * g * n) + 4 * bsz * h * nc * p * n
    pairs = q * (q + 1) // 2
    flops = bsz * h * nc * (pairs * (2 * n + 1 + 2 * p) + q * n + 2 * q * p * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def prefill_logits(arch, params, prompt):
    import torch

    from repro_torch.models import init_cache, prefill

    with torch.inference_mode():
        logits, _ = prefill(params, arch, {"tokens": prompt}, init_cache(arch, 1, 2048))
    return logits


def prefill_check(arch, params, prompt, ops, f32_cap) -> int:
    """Phase 3: full-width prefill logits through the kernels against the
    same prefill with every kernel's plain version swapped in, and both
    against the same weights in f32 through the plain versions (see
    F32_MARGIN); returns the kernel prefill's argmax (the first token the
    server must emit)."""
    import torch

    logits_k = prefill_logits(arch, params, prompt)
    with plain_kernels(ops):
        logits_p = prefill_logits(arch, params, prompt)
        logits_32 = prefill_logits(arch.variant(dtype="float32"), _map(params, lambda t: t.float()), prompt)
    torch.cuda.empty_cache()
    if logits_k.shape != (1, 1, arch.vocab_size) or not torch.isfinite(logits_k).all():
        fail(f"{arch.name}: prefill logits malformed: shape {tuple(logits_k.shape)}")
    scale = logits_p.float().abs().max().item()
    lerr = (logits_k.float() - logits_p.float()).abs().max().item()
    print(f"{arch.name}: prefill logits (S={prompt.shape[1]}) kernels vs plain: max_abs_err={lerr} "
          f"max|logit|={scale} rel={lerr / scale} tol={LOGIT_REL_TOL}")
    if not lerr <= LOGIT_REL_TOL * scale:
        fail(f"{arch.name}: full-width prefill through the kernels disagrees with the plain versions: {lerr} vs {scale}")
    scale32 = logits_32.abs().max().item()
    rel_k = (logits_k.float() - logits_32).abs().max().item() / scale32
    rel_p = (logits_p.float() - logits_32).abs().max().item() / scale32
    print(f"{arch.name}: prefill logits vs f32 (plain versions, max|logit|={scale32}): kernels rel={rel_k} "
          f"plain rel={rel_p} tol=min(plain + {F32_MARGIN}, {f32_cap})")
    if not (math.isfinite(rel_k) and rel_k <= rel_p + F32_MARGIN and rel_k <= f32_cap):
        fail(f"{arch.name}: the kernel prefill is {rel_k} of max|logit| from f32, the plain one {rel_p}")
    return int(torch.argmax(logits_k[0, -1]))


def serve_path(arch, params, prompt, first_tok, kernels, want) -> dict:
    """Phase 4: 16 requests from 2 client threads through the collective
    hand-off, 8 slots (so slots are recycled); every kernel's count is set
    to 0 just before and read just after.  ``want`` maps a kernel's name to
    the launches this path must make.  Returns the launches."""
    import torch

    from repro_torch.serve import InferenceServer, ServeConfig

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

    for fn in kernels.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in kernels.items()}
    done = [r for r in reqs if r is not None and r.done_event.is_set()]
    ttft = sorted(r.first_token_at - r.submitted_at for r in done)
    print(
        f"{arch.name} serve: requests={len(done)}/{len(prompts)} engine_steps={server.steps} tokens={server.tokens_out} "
        f"throughput={server.tokens_out / dt} tok/s ttft_p50={ttft[len(ttft) // 2] * 1e3 if ttft else float('nan')} ms "
        f"wall={dt} s prefill={server.core.prefill_seconds} s decode={server.core.decode_seconds} s "
        + " ".join(f"{name}.launches={n}" for name, n in launches.items()) + " transport=collective"
    )
    if len(done) != len(prompts):
        fail(f"{arch.name}: served {len(done)} of {len(prompts)} requests")
    bad = [r.rid for r in done if len(r.out_tokens) != MAX_NEW or not all(0 <= t < arch.vocab_size for t in r.out_tokens)]
    if bad:
        fail(f"{arch.name}: requests {bad} came back with a wrong number of tokens or out-of-vocab tokens")
    if reqs[-1].out_tokens[0] != first_tok:
        fail(f"{arch.name}: served first token {reqs[-1].out_tokens[0]} != the phase-3 prefill's argmax {first_tok}")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{arch.name}: {name} launched {launches[name]} times, want {n} on this path")
    return launches


# The served models, in order; the launches each kernel must make per
# prefill on its path: one flash attention per attention layer (zamba2's
# shared block runs at layers 0, 6, ..., 36: 7), one SSD chunk scan per SSM
# layer; and the cap on the kernel prefill's distance from f32 (the plain
# bf16 run measured 1.46%, 1.83% and 4.23% of max |logit| on an H100).
PATHS = [
    ("tinyllama-1.1b", {"flash_attention": 22, "ssd_chunk_kernel": 0}, 3e-2),
    ("mamba2-130m", {"flash_attention": 0, "ssd_chunk_kernel": 24}, 4e-2),
    ("zamba2-1.2b", {"flash_attention": 7, "ssd_chunk_kernel": 38}, 8e-2),
]


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
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel, ssd_chunk_plain
    from repro_torch.models import init_params

    # full-f32 products for the f32 comparisons, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"flash_attention": flash_attention, "ssd_chunk_kernel": ssd_chunk_kernel}

    # 1. the card and the build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.monotonic()
    build.build(["flash_attention", "ssd_scan"])
    print(f"kernel build: {time.monotonic() - t0} s")

    # 2. every kernel against its plain version ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_attention(flash_attention, attention_plain, gen)
    ssd_errs = check_ssd(ssd_chunk_kernel, ssd_chunk_plain, gen)
    check_ssd_chunked_ragged(ops, ssd_chunk_plain, gen)

    # 3./4. each model: full-width prefill check, then serving ----------------
    by_path = {}
    for name, per_prefill, f32_cap in PATHS:
        arch = get_config(name)
        t0 = time.monotonic()
        params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"{name}: {n_params} params ({arch.dtype}) built in {time.monotonic() - t0} s")
        prompt = torch.randint(0, arch.vocab_size, (1, 777), generator=gen, device="cuda")
        first_tok = prefill_check(arch, params, prompt, ops, f32_cap)
        want = {k: n * len(PROMPT_LENS) for k, n in per_prefill.items()}
        by_path[name] = serve_path(arch, params, prompt, first_tok, kernels, want)
        del params
        torch.cuda.empty_cache()

    # 5. times at the serving paths' shapes -----------------------------------
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
    ssd_ms = {}
    for case in (SSD_MAMBA2, SSD_ZAMBA2):
        a, x, b, c = ssd_inputs(case, gen)
        t_kernel = cuda_ms(lambda: ssd_chunk_kernel(a, x, b, c))
        t_plain = cuda_ms(lambda: ssd_chunk_plain(a, x, b, c))
        t_lib = cuda_ms(ssd_yardstick(a, x, b, c))
        t_kernel2 = cuda_ms(lambda: ssd_chunk_kernel(a, x, b, c))
        sbound, sbound_by = ssd_bound_ms(case)
        ssd_ms[case] = (t_kernel, t_plain, t_lib, sbound, sbound_by)
        print(f"ssd_chunk_kernel {case}: kernel={t_kernel} ms (again {t_kernel2} ms) plain={t_plain} ms "
              f"einsum_chain (model plain branch)={t_lib} ms bound={sbound} ms ({sbound_by})")

    # 6. the record ---------------------------------------------------------------
    t_kernel, t_plain, t_lib, sbound, sbound_by = ssd_ms[SSD_MAMBA2]
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:38",
        "launches": sum(p["flash_attention"] for p in by_path.values()),
        "launches_by_path": {n: p["flash_attention"] for n, p in by_path.items()},
        "max_abs_err": errs[SLICE_CASE],
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": ms_lib,
        "check": "pass",
    }, {
        "name": "ssd_chunk_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:34",
        "launches": sum(p["ssd_chunk_kernel"] for p in by_path.values()),
        "launches_by_path": {n: p["ssd_chunk_kernel"] for n, p in by_path.items()},
        "max_abs_err": ssd_errs[SSD_MAMBA2],
        "ms": t_kernel,
        "plain_ms": t_plain,
        "bound_ms": sbound,
        "bound_by": sbound_by,
        "library_ms": t_lib,
        "check": "pass",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
