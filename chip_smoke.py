#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's serving and training paths (``src/repro_torch``) and
nothing of the JAX package.  In order, it:

1. prints the card's name and power limit and builds the CUDA kernels from
   the sources in the checkout (one ``nvcc`` per source, all at once);
2. holds every kernel against its plain PyTorch version on the card, at
   the reference's test shapes and at the shapes the serving paths give
   it (the later families' too: whisper's bidirectional encoder at
   S=1500, internvl2's and llama4's attention, llama4's chunked layers at
   S=9216 with a chunk boundary inside, its expert products), and the SSD
   kernel's route through ``ssd_chunked`` at a ragged S;
   the gradient-pack kernel's wire bytes and new error feedback against
   its plain version and the host reference ``pack_grads_q8``, bit for
   bit, on the reference test's cases and over 10 EF steps;
3. for each served model, ``tinyllama-1.1b`` (dense), ``mamba2-130m``
   (SSM), ``zamba2-1.2b`` (hybrid) and ``deepseek-moe-16b`` (MoE), at full
   width (bf16, random weights from a fixed seed): holds its prefill
   logits through the kernels against the same prefill with every
   kernel's plain version swapped in, and both against the same weights
   in f32 through the plain versions (for deepseek, whose 16.9 B
   parameters have no room for an f32 copy, on its first 4 layers; its
   routing amplifies last-bit differences, so the gated comparisons
   replay one run's routing into the others, see ``prefill_check``);
4. then serves 16 requests from 2 client threads through
   ``InferenceServer`` over the collective comm hand-off, with every
   kernel's launch count set to 0 just before and read just after, and
   checks each kernel's launches on that path, prefill and decode;
3b/4b. the same for the other families, at full width: ``minicpm3-4b``
   (MLA, all 62 layers; no kernel on its path, so every count must read
   0), ``whisper-large-v3`` (encoder-decoder, 32 + 32 layers; its prefill
   check and serving on 8 rows of 1500-frame stubs and 128-token prompts,
   through ``prefill`` and ``decode_step``, since a request to the server
   carries tokens only), ``internvl2-76b`` (VLM, its first 8 of 80 layers;
   its prefill check with a 256-token stub prefix, served text only, and
   one prefix prefill with 3 decode steps through the model API) and
   ``llama4-scout-17b-a16e`` (chunked-local MoE with global layers, its
   first 4 of 48 layers so that layer 3 is global; prefill checks at
   S=1024 and S=9216); the f32 comparison of every model but deepseek
   converts its weights in place, one leaf at a time, and back (bf16 ->
   f32 -> bf16 is exact): llama4's f32 copy has no room beside them;
4c. the fleet: for ``tinyllama-1.1b`` (over the collective transport) and
   ``mamba2-130m`` (over the shared-memory transport, responses by
   one-sided puts), rows of ``decode_step`` at batch 1, 2, 4 and 8 must be
   bit-identical; then phase 4's 16 requests go through a single-host
   ``InferenceServer`` of 8 slots, a ``Fleet`` of 2 workers × 4 slots, and
   the same fleet with worker 0 leaving mid-decode (its slots handed off
   as snapshot bytes) and a worker joining: every stream must equal the
   single host's, and the kernels must launch once a prefill of 16; it
   also times a 4-row ``decode_step`` (one padded tile) against an 8-row
   one;
   (after phase 5's exchange) the same two-rank DP exchange over
   ``CommChannel(stage="device")``, the wires bit for bit;
5. trains ``tinyllama-1.1b``: first the train step's loss and gradients
   through the kernels against the plain path (full width, its first
   layers, f32 and bf16); then the full model in bf16 with int8 error
   feedback, 8 steps on one fixed batch (the loss must fall, flash must
   launch once a layer a step); then two data-parallel ranks pack their
   gradients with ``make_packer("device")``, exchange the wires over the
   port's ``CommChannel`` and average (bit for bit the direct average),
   with every kernel's count set to 0 before the steps and read after the
   exchange; then the pack kernel on that full-width gradient tree over 2
   EF steps, bit for bit against its plain version and the host reference;
5b. trains the other families, the SSD and grouped-matmul kernels inside
   their ``autograd.Function``s: for each of ``mamba2-130m``,
   ``zamba2-1.2b`` (its shared block at layer 0 included),
   ``deepseek-moe-16b``, ``minicpm3-4b``, ``whisper-large-v3``,
   ``internvl2-76b`` and ``llama4-scout-17b-a16e``, first the train
   step's loss and gradients through the kernels against the plain path
   (full width, first 2 layers, internvl2's and llama4's first 1, f32 with
   the weights converted in place and bf16; the MoE models' runs on one
   run's expert choices, their gates and aux loss from their own router,
   see ``routes``); then 8 bf16 steps on one fixed batch, each model at
   its own depth, sequence length, remat mode and grad sync (see
   FAMILY_TRAINS: mamba2, zamba2 and whisper at full depth with int8
   error feedback, whisper at S=448 over 1500 frames; minicpm3 at all 62
   layers under ``remat="full"``; deepseek cut to 4 layers, internvl2 to
   2 behind a 256-token prefix, llama4 to 1): the loss must fall, and each
   kernel must launch exactly its count a step;
5c. checkpoint/restart: ``Trainer`` trains ``mamba2-130m`` (full depth,
   int8 error feedback) 3 steps with a checkpoint directory (asynchronous
   saves through its executor), a second ``Trainer`` resumes on it to
   step 6, a third runs 6 steps uninterrupted; the restored state must be
   bit for bit the saved one and the resumed losses the uninterrupted
   run's (see ``restart_path``); the save and restore walls and the bytes
   written are printed;
6. times each kernel, its plain version and the library yardstick for the
   same function, with CUDA events (wall a call, the wrapper's host time
   included), and the kernel and the yardstick by the profiler's device
   time a call (taken in a fresh process of this script, from two whole
   sessions, never below the bound: ``device_times``); flash attention at the serving, deepseek and train shapes
   and at whisper's, internvl2's and llama4's; the grouped matmul at
   deepseek's and llama4's;
   the SSD kernel at mamba2's and zamba2's, with its share of the bound
   and the heads a block takes; and the host time a call of the SSD and
   grouped-matmul wrappers and of their ``autograd.Function``s under
   ``inference_mode`` (the serving route);
7. drives the port's parcelport stack (``repro_torch.core``) on the
   card's machine: (a) the reference's protocol gate over the port — every
   variant of ``variant_names()`` delivers ``benchmarks/run.py``'s smoke
   payloads bit for bit, quiesces and closes, a bounded ``lci`` and a
   bounded ``collective`` world backpressure and deliver, ``lci_eager``
   takes fewer messages than ``lci_noeager``, and the ``collective``
   decision trace equals ``sendrecv_queue``'s; (b) bytes made on the card
   in earlier phases — 64 MiB of phase 5's ``KIND_Q8`` wire and one
   mamba2 ``RSNP`` hand-off snapshot of phase 4c — as zero-copy chunks
   through ``lci``, ``mpi``, ``shmem_putq`` and a ``collective`` world
   whose group stages every drain through a buffer on the card: bit for
   bit, with the staged bytes every message's payload; (c) the
   ``lci_eprg0_2`` elastic pool with real threads, within its bounds and
   closed clean; the walls printed are host walls;
8. runs the port's discrete-event simulator (``repro_torch.amtsim``, host
   code: it launches no kernel) against the same stack: (a) for ``lci``,
   ``mpi`` and ``shmem_putq``, the DES decision trace at the sizes of
   phase 7(b)'s two card-made payloads equals the decision trace of a
   functional world carrying those bytes (sent one at a time, no
   zero-copy chunk, a drain after each, as the reference's engine-parity
   test runs it); (b) the paper's verdicts over the DES, at the sizes the
   reference's tests use and at ``octotiger``'s defaults: flood ``lci`` >
   ``mpi_a`` > ``mpi`` at 8 B, aggregation's large-message gain under half
   its small-message gain, ``chains`` latency ``lci`` < ``mpi``, ``lci`` >=
   ``try_progress`` >= ``block``, ``lci_d4`` > 1.5 x ``lci_d1``,
   Octo-Tiger ``lci`` < ``mpi``, Delta below Expanse; the rates printed
   are simulated values of the paper's clusters (the ``expanse`` and
   ``delta`` cost models), never times on this card;
9. shards: (a) ``tinyllama-1.1b``'s train step (full width, bf16, B=4,
   S=1024, remat "dots", 2 steps from phase 5's initial parameters) with
   its state and batch placed as DTensors by the spec trees on a 1×1
   ("data", "model") mesh over a one-rank NCCL group, under
   ``make_rules``: the losses and every state leaf bit for bit the
   unsharded step's (one device runs the same local ops), the flash
   kernel (through ``local_map`` inside ``FlashAttentionFn``'s route)
   launching as often as unsharded; the same for ``mamba2-130m`` (24
   layers), ``zamba2-1.2b`` (38) and ``deepseek-moe-16b`` (4 of 28) at
   their phase-5b B, S and remat (the unsharded state kept on the host),
   and a sharded prefill and 3 decode steps of deepseek (4 layers) and
   zamba2 under the serving rules, logits bit for bit; then the
   ``seq_act`` forward of ``qwen2-7b`` and ``minicpm3-4b`` (first 2
   layers, full width, f32) within 2e-4 of max |logit| of the default
   forward; (b) the dry-run (``repro_torch.launch.dryrun``, host work in
   subprocesses started before (a)): every cell of every model on the
   16×16 and 2×16×16 fake meshes and the one-card view, a line a cell
   (argument and temp bytes, whether they fit this card, FLOPs,
   collective bytes, the roofline's terms on the H100's data-sheet
   peaks); every applicable cell must be ``ok`` (102), the other 18
   ``skipped``; (c) the bytes that
   ``launch/specs.py`` predicts on meta for tinyllama's parameters, its
   phase-4 cache and train state against the card's tensors, and the
   FLOPs of the products no kernel replaces over a prefill and a train
   step, counted on meta and on the card: equal, exactly;
10. prints one JSON line of the kernels and, last, the device line.

It exits non-zero, printing no result, without a card or outside a
checkout, and on any failed check.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent


def peaks() -> tuple:
    """(ops/s by dtype, bytes/s): the H100 SXM's data-sheet peaks (dense:
    bf16 tensor cores, f32 outside them, HBM3 bandwidth), from their one
    copy, ``repro_torch.roofline.HW``, which the dry-run's roofline reads
    too.  The bound is taken against these at any power limit."""
    from repro_torch.roofline import HW

    hw = HW()
    return {"bfloat16": hw.peak_flops, "float32": hw.peak_flops_f32}, hw.hbm_bw


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
# tinyllama-1.1b's train step (phase 5): B=4, S=1024, 32 heads, 4 kv heads
TRAIN_FLASH_CASE = (4, 1024, 32, 4, 64, True, 0, 0, "bfloat16")
RAGGED_CASE = (1, 200, 32, 4, 64, True, 0, 0, "bfloat16")
# zamba2-1.2b's shared block: H == KV (no GQA), kind swa with its 4096
# window, at the longest prompt it serves and at a ragged one
ZAMBA2_CASES = [(1, 1024, 32, 32, 64, True, 4096, 0, "bfloat16"), (1, 777, 32, 32, 64, True, 4096, 0, "bfloat16")]
# deepseek-moe-16b: H == KV = 16 heads of 128, full causal attention
DEEPSEEK_CASES = [(1, 1024, 16, 16, 128, True, 0, 0, "bfloat16"), (1, 777, 16, 16, 128, True, 0, 0, "bfloat16")]
# The later families: whisper-large-v3's encoder (bidirectional, H == KV =
# 20 heads of 64, 1500 frames: a ragged tail of keys); internvl2-76b's
# attention over a 256-token prefix and 1024 tokens of text (64 heads, 8 kv
# heads of 128); llama4-scout's chunked-local layers at S = 9216 (40 heads,
# 8 kv heads of 128, chunks of 8192: the boundary inside the sequence) and
# its global layers
WHISPER_ENC_CASE = (1, 1500, 20, 20, 64, False, 0, 0, "bfloat16")
INTERNVL2_CASE = (1, 1280, 64, 8, 128, True, 0, 0, "bfloat16")
LLAMA4_CHUNK_CASE = (1, 9216, 40, 8, 128, True, 0, 8192, "bfloat16")
LLAMA4_GLOBAL_CASE = (1, 9216, 40, 8, 128, True, 0, 0, "bfloat16")
FAMILY_FLASH_CASES = [WHISPER_ENC_CASE, INTERNVL2_CASE, LLAMA4_CHUNK_CASE, LLAMA4_GLOBAL_CASE]
# The plain attention takes queries this many at a time: at S = 9216 the
# whole f32 score matrix of 40 heads would be 13.6 GB (and its softmax as
# much again), a block of 2048 queries 3.0 GB.  Each query row is its own
# softmax, so the blocks compute the same function.
PLAIN_Q_BLOCK = 2048
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

# (E, C, D, F, dtype): the reference's GMM_CASES (tests/test_kernels.py),
# then deepseek-moe-16b's expert products: a 1024-token prefill (capacity
# ceil(1024 * 6 / 64 * 1.25) = 120) through gate/up and down, and a decode
# step of 8 slots (capacity 4 a row, laid out as E x 32 rows)
GMM_CASES = [
    (4, 256, 512, 384, "float32"),
    (2, 128, 128, 128, "float32"),
    (8, 128, 256, 128, "bfloat16"),
    (1, 512, 1024, 256, "float32"),
]
GMM_PREFILL_UP = (64, 120, 2048, 1408, "bfloat16")
GMM_PREFILL_DOWN = (64, 120, 1408, 2048, "bfloat16")
GMM_DECODE = (64, 32, 2048, 1408, "bfloat16")
# llama4-scout's expert products: top-1 of 16 experts, so a 1024-token
# prefill's capacity is ceil(1024 / 16 * 1.25) = 80, through gate/up (D =
# 5120, F = 8192) and down; a decode step of 8 slots (capacity 4 a row)
LLAMA4_GMM_UP = (16, 80, 5120, 8192, "bfloat16")
LLAMA4_GMM_DOWN = (16, 80, 8192, 5120, "bfloat16")
LLAMA4_GMM_DECODE = (16, 32, 5120, 8192, "bfloat16")
# f32: 1e-4, the reference's own.  bf16: both versions sum in f32 and round
# to bf16 once, so an output may differ by rounding at the boundary: 2 bf16
# ulps (2^-7) of max |out| (the reference's absolute 5e-2 means nothing at
# these magnitudes: with the 1/sqrt(E) init, expert outputs reach hundreds)
GMM_TOL = {"float32": 1e-4, "bfloat16": 2.0**-7}
# deepseek's f32 gate runs on its first layers only (see prefill_check)
DEEPSEEK_F32_LAYERS = 4

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


def device_ms(fn, iters: int = 20, warmup: int = 3, bound_ms: float = 0.0) -> float:
    """Mean device milliseconds per call: the summed time of the kernels
    that ``iters`` calls ran on the card, from ``torch.profiler`` (a 20-40
    µs kernel's event-timed wall reads its wrapper's host time).

    A session counts only when it recorded every launch of its calls: its
    kernel records are a whole multiple of ``iters`` and as many as in
    another session of the same calls, and its time is no less than
    ``bound_ms`` (the least time the card could take).  Now and then, for
    a spell of up to about 0.4 s, the card's sessions come back with no
    kernel records, or with part of them
    (tools/torch_profiler_sessions.py): a session that does not count is
    traced again after PROFILE_PAUSE_S, which outlasts such a spell, up to
    PROFILE_TRIES sessions; then the reading fails.  A session of a whole
    model call (thousands of kernels) loses a few records every time, so
    this times kernels, not models."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    counted, seen = [], []
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        # the warm-up calls run traced but unrecorded (the profiler's own
        # warm-up step), so the kernels that tracing misses as it starts are
        # not timed ones; the counts below catch any it misses later
        traced = []
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.extend(p.key_averages())) as prof:
            for calls in (warmup, iters):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in traced if e.device_type == DeviceType.CUDA]
        records = sum(e.count for e in kernels)
        ms = sum(e.device_time_total for e in kernels) / 1e3 / iters
        seen.append((records, ms))
        if records and records % iters == 0 and ms >= bound_ms:
            if records in counted:
                if attempt > 2:
                    print(f"torch.profiler: a whole session on attempt {attempt}; sessions (records, ms a call): {seen}")
                return ms
            counted.append(records)
            continue
        time.sleep(PROFILE_PAUSE_S)
    fail(f"torch.profiler recorded no two whole sessions of {iters} calls in {PROFILE_TRIES} (bound {bound_ms} ms); "
         f"sessions (kernel records, ms a call): {seen}: device times not measured")


PROFILE_TRIES, PROFILE_PAUSE_S = 6, 1.0


def host_us(fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean host microseconds to issue one call: ``iters`` calls timed on
    the host clock with no synchronization inside the window (the launch
    queue does not fill at these counts), synchronized after it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def sdpa_yardstick(case, q, k, v):
    """SDPA on q, k, v (B, S, H|KV, D) with ``case``'s mask, as a call to
    time: the inputs laid out as its (B, H, S, D) beforehand; a window or
    chunk goes as a boolean mask, with the kv heads repeated to the query
    heads (made beforehand too)."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    _, s, h, kvh, _, causal, window, chunk, _ = case
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not (window or chunk):
        return lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=h != kvh)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    if chunk:
        mask &= pos[None, :] // chunk == pos[:, None] // chunk
    kt, vt = (t.repeat_interleave(h // kvh, dim=1) for t in (kt, vt))
    return lambda: sdpa(qt, kt, vt, attn_mask=mask)


def time_attention(flash_attention, attention_plain, case, gen, dev) -> dict:
    """Phase 6: the kernel, its plain version and SDPA on one case, its mask
    included: event-timed walls, beside the kernel's and SDPA's device
    times ``dev`` (:func:`device_times`)."""
    _, s, _, _, _, causal, window, chunk, _ = case
    kw = dict(causal=causal, window=window, chunk=chunk)
    q, k, v = attention_inputs(case, gen)
    kernel = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
    lib = sdpa_yardstick(case, q, k, v)
    plain_iters = 50 if s <= PLAIN_Q_BLOCK else 5
    bound, bound_by = attention_bound_ms(case)
    t = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(lambda: attention_plain(q, k, v, **kw), iters=plain_iters, warmup=1),
         "library_ms": cuda_ms(lib), "again_ms": cuda_ms(kernel),
         "device_ms": dev["kernel"], "library_device_ms": dev["library"],
         "bound_ms": bound, "bound_by": bound_by}
    print(f"flash_attention {case}: kernel={t['ms']} ms (again {t['again_ms']} ms) device={t['device_ms']} ms "
          f"plain={t['plain_ms']} ms sdpa={t['library_ms']} ms (device {t['library_device_ms']} ms) "
          f"bound={t['bound_ms']} ms ({t['bound_by']})")
    return t


def attention_inputs(case, gen):
    import torch

    b, s, h, kv, d, _, _, _, dtype = case
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
    return q, k, v


def attention_plain_blocked(q, k, v, causal=True, window=0, chunk=0):
    """``attention_plain`` a block of PLAIN_Q_BLOCK queries at a time (a
    causal block against the keys up to its last query): the same function
    in a bounded working set.  Up to PLAIN_Q_BLOCK queries it is one call
    of ``attention_plain``."""
    import torch

    from repro_torch.kernels.flash_attention import attention_plain

    s = q.shape[1]
    if s <= PLAIN_Q_BLOCK:
        return attention_plain(q, k, v, causal=causal, window=window, chunk=chunk)
    outs = []
    for i in range(0, s, PLAIN_Q_BLOCK):
        end = min(s, i + PLAIN_Q_BLOCK)
        kend = end if causal else k.shape[1]
        outs.append(attention_plain(q[:, i:end], k[:, :kend], v[:, :kend], causal=causal, window=window,
                                    chunk=chunk, q_start=i))
    return torch.cat(outs, dim=1)


def mask_label(case) -> str:
    """'' for a causal case with no window or chunk, else its mask."""
    _, _, _, _, _, causal, window, chunk, _ = case
    return "".join([" bidir" if not causal else "", f" window={window}" if window else "", f" chunk={chunk}" if chunk else ""])


def check_attention(flash_attention, attention_plain, gen, cases) -> dict:
    """Phase 2: kernel vs plain on every case; returns {case: max_abs_err}."""
    import torch

    errs = {}
    for case in cases:
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


def visible_pairs(s: int, causal: bool, window: int, chunk: int) -> int:
    """The (query, key) pairs the mask lets through: query i sees keys from
    max(0, i - window + 1, its chunk's start) (only where the flags are set)
    to i, or every key when not causal."""
    if not causal:
        return s * s
    total = 0
    for i in range(s):
        lo = 0
        if window:
            lo = max(lo, i - window + 1)
        if chunk:
            lo = max(lo, i // chunk * chunk)
        total += i - lo + 1
    return total


def attention_bound_ms(case) -> tuple:
    """Least time for the work this case needs: q, k, v, out moved once;
    2 products of 2 operations per visible (query, key) pair per head dim."""
    b, s, h, kv, d, causal, window, chunk, dtype = case
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * b * s * d * (2 * h + 2 * kv)
    pairs = visible_pairs(s, causal, window, chunk)
    flops = 4 * b * h * d * pairs
    peak_flops, peak_bytes = peaks()
    t_bytes, t_ops = nbytes / peak_bytes, flops / peak_flops[dtype]
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


def gmm_inputs(case, gen):
    """x ~ N(0,1); w ~ 0.05·N(0,1) at the reference's cases (its test's
    scale), N(0,1)/sqrt(E) at deepseek's (the model's init)."""
    import torch

    e, c, d, f, dtype = case
    dt = getattr(torch, dtype)
    w_scale = 0.05 if case in GMM_CASES else 1.0 / math.sqrt(e)
    x = torch.randn((e, c, d), generator=gen, device="cuda").to(dt)
    w = (torch.randn((e, d, f), generator=gen, device="cuda") * w_scale).to(dt)
    return x, w


def check_gmm(grouped_matmul, grouped_matmul_plain, gen, cases) -> dict:
    """Phase 2: the grouped matmul vs its plain version; returns {case: max_abs_err}."""
    import torch

    errs = {}
    for case in cases:
        dtype = case[-1]
        x, w = gmm_inputs(case, gen)
        out = grouped_matmul(x, w)
        torch.cuda.synchronize()
        ref = grouped_matmul_plain(x, w)
        err = (out.float() - ref.float()).abs().max().item()
        tol = GMM_TOL[dtype] * (1.0 if dtype == "float32" else ref.float().abs().max().item())
        ok = out.dtype == x.dtype and out.shape == ref.shape and math.isfinite(err) and err <= tol
        print(f"grouped_matmul {case}: max_abs_err={err} tol={tol} {'ok' if ok else 'MISS'}")
        if not ok:
            fail(f"grouped_matmul disagrees with grouped_matmul_plain at {case}: {err}")
        errs[case] = err
    return errs


def gmm_bound_ms(case) -> tuple:
    """Least time for the work: x and w read once and out written once;
    2 operations per multiply-add, E·C·D·F of them."""
    e, c, d, f, dtype = case
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * e * (c * d + d * f + c * f)
    flops = 2 * e * c * d * f
    peak_flops, peak_bytes = peaks()
    t_bytes, t_ops = nbytes / peak_bytes, flops / peak_flops[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
        from repro_torch.kernels.moe_gmm import grouped_matmul_plain
        from repro_torch.kernels.ssd_scan import ssd_chunk_plain

        self.saved = self.ops.attention, self.ops.ssd_chunk, self.ops.expert_ffn_matmul
        self.ops.attention = attention_plain_blocked
        self.ops.ssd_chunk = ssd_chunk_plain
        self.ops.expert_ffn_matmul = grouped_matmul_plain
        return self

    def __exit__(self, *exc):
        self.ops.attention, self.ops.ssd_chunk, self.ops.expert_ffn_matmul = self.saved
        return False


class routes:
    """Within the block, every MoE layer's routing (expert ids, positions,
    keep mask, gates, capacity, aux) is appended to ``self.routes`` in call
    order, detached; given ``replay`` (another block's ``routes``), each
    layer takes the replayed routing in that order in place of its own.
    With ``regate`` (training) only the discrete choices are replayed: the
    expert ids, and with them the positions, keep mask and capacity; the
    gates and the aux loss come from this run's own router probabilities at
    those ids, so the router's gradient is this run's."""

    def __init__(self, replay=None, regate=False):
        self.replay, self.regate, self.routes = replay, regate, []

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe._route

        def route(p, x, cfg):
            if self.replay is None:
                out = self.real(p, x, cfg)
            elif self.regate:
                b, s, _ = x.shape
                idx = self.replay[len(self.routes)][0].reshape(b, cfg.top_k, s).transpose(1, 2)
                probs = moe._router_probs(p, x)
                out = moe._assign(probs, probs.gather(-1, idx), idx, cfg)
            else:
                out = self.replay[len(self.routes)]
            self.routes.append(tuple(t.detach() if hasattr(t, "detach") else t for t in out))
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real
        return False


def routing_flips(a, b) -> str:
    """How many (token, slot) expert choices differ between two runs."""
    n = sum(int((x[0] != y[0]).sum()) for x, y in zip(a, b))
    total = sum(x[0].numel() for x in a)
    return f"{n} of {total} (token, slot) routing choices differ over {len(a)} MoE layers"


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
    peak_flops, peak_bytes = peaks()
    t_bytes, t_ops = nbytes / peak_bytes, flops / peak_flops[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def prefill_logits(arch, params, batch):
    """Last-position logits (B, 1, V) of a prefill of ``batch`` (tokens,
    and a stub ``prefix`` or ``frames``) on a fresh cache of at least 2048
    positions."""
    import torch

    from repro_torch.models import init_cache, prefill

    b, s = batch["tokens"].shape
    s += batch["prefix"].shape[1] if "prefix" in batch else 0
    with torch.inference_mode():
        logits, _ = prefill(params, arch, batch, init_cache(arch, b, max(2048, s)))
    return logits


def dtypes_of(tree):
    return {k: dtypes_of(v) if isinstance(v, dict) else v.dtype for k, v in tree.items()}


def retype_(tree, dtypes) -> None:
    """Each leaf of the nested dict ``tree`` replaced in place by its copy in
    ``dtypes`` (one dtype, or a tree of them), one leaf at a time: the peak
    is the new tree and one old leaf."""
    for key in list(tree):
        want = dtypes[key] if isinstance(dtypes, dict) else dtypes
        if isinstance(tree[key], dict):
            retype_(tree[key], want)
        else:
            tree[key] = tree[key].to(want)


def prefill_check(arch, params, batch, ops, f32_cap, f32_layers=None) -> int:
    """Phase 3: full-width prefill logits through the kernels against the
    same prefill with every kernel's plain version swapped in (within
    LOGIT_REL_TOL of max |logit|), and both against the same weights in
    f32 through the plain versions (see F32_MARGIN), the stub inputs cast
    with them.  With ``f32_layers`` the f32 comparison runs on the model
    cut to its first ``f32_layers`` layers (params sliced from the full
    tree, copied to f32), all three prefills again.  Without, the f32
    weights replace the bf16 ones leaf by leaf and go back after the f32
    prefill (bf16 -> f32 -> bf16 is exact), so that a model whose f32 copy
    has no room beside its bf16 weights (llama4-scout's 43.5 GB beside
    21.8) is compared at the depth it is served.

    A MoE model's routing amplifies a last-bit difference: one flipped
    expert choice moves the queue positions behind it and so which slots
    the capacity drops.  So for a MoE model the plain run first runs free,
    and its distance and the routing choices that differ are printed; the
    gated comparisons then replay one run's routing into the others (the
    kernel run's into the plain run, the f32 run's into both bf16 runs),
    so that they differ only by the arithmetic the kernels replace.
    Returns the full kernel prefill's argmax of row 0 (the first token the
    server must emit)."""
    import torch

    from repro_torch.tree import tree_map

    tokens = batch["tokens"]
    with routes() as rk:
        logits_k = prefill_logits(arch, params, batch)
    if logits_k.shape != (tokens.shape[0], 1, arch.vocab_size) or not torch.isfinite(logits_k).all():
        fail(f"{arch.name}: prefill logits malformed: shape {tuple(logits_k.shape)}")
    first_tok = int(torch.argmax(logits_k[0, -1]))
    moe = bool(rk.routes)
    if moe:
        with plain_kernels(ops), routes() as rp:
            logits_p = prefill_logits(arch, params, batch)
        free = (logits_k.float() - logits_p.float()).abs().max().item() / logits_p.float().abs().max().item()
        print(f"{arch.name}: prefill logits (S={tokens.shape[1]}) kernels vs plain, routing free: rel={free}; "
              + routing_flips(rk.routes, rp.routes))
    with plain_kernels(ops), routes(replay=rk.routes if moe else None):
        logits_p = prefill_logits(arch, params, batch)
    scale = logits_p.float().abs().max().item()
    lerr = (logits_k.float() - logits_p.float()).abs().max().item()
    print(f"{arch.name}: prefill logits (B={tokens.shape[0]} S={tokens.shape[1]}"
          f"{' after a ' + str(batch['prefix'].shape[1]) + '-token prefix' if 'prefix' in batch else ''}"
          f"{' over ' + str(batch['frames'].shape[1]) + ' frames' if 'frames' in batch else ''}, "
          f"{arch.n_layers} layers) kernels vs plain"
          f"{', routing of the kernel run' if moe else ''}: max_abs_err={lerr} max|logit|={scale} "
          f"rel={lerr / scale} tol={LOGIT_REL_TOL}")
    if not lerr <= LOGIT_REL_TOL * scale:
        fail(f"{arch.name}: full-width prefill through the kernels disagrees with the plain versions: {lerr} vs {scale}")
    if f32_layers is not None:
        arch = arch.variant(n_layers=f32_layers)
        params = dict(params, layers=tree_map(lambda t: t[:f32_layers], params["layers"]))
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    if f32_layers is None:
        dtypes = dtypes_of(params)
        retype_(params, torch.float32)
        p32 = params
    else:
        p32 = tree_map(lambda t: t.float(), params)
    with plain_kernels(ops), routes() as r32:
        logits_32 = prefill_logits(arch.variant(dtype="float32"), p32, batch32)
    del p32
    if f32_layers is None:
        retype_(params, dtypes)
    if moe or f32_layers is not None:  # both bf16 runs again, on the f32 run's routing
        with routes(replay=r32.routes if moe else None):
            logits_k = prefill_logits(arch, params, batch)
        with plain_kernels(ops), routes(replay=r32.routes if moe else None):
            logits_p = prefill_logits(arch, params, batch)
    torch.cuda.empty_cache()
    scale32 = logits_32.abs().max().item()
    rel_k = (logits_k.float() - logits_32).abs().max().item() / scale32
    rel_p = (logits_p.float() - logits_32).abs().max().item() / scale32
    print(f"{arch.name}: prefill logits vs f32 ({arch.n_layers} layers, plain versions"
          f"{', routing of the f32 run' if moe else ''}, max|logit|={scale32}): kernels rel={rel_k} "
          f"plain rel={rel_p} tol=min(plain + {F32_MARGIN}, {f32_cap})")
    if not (math.isfinite(rel_k) and rel_k <= rel_p + F32_MARGIN and rel_k <= f32_cap):
        fail(f"{arch.name}: the kernel prefill is {rel_k} of max|logit| from f32, the plain one {rel_p}")
    return first_tok


def serve_path(arch, params, prompt, first_tok, kernels, per_prefill, per_step) -> dict:
    """Phase 4: 16 requests from 2 client threads through the collective
    hand-off, 8 slots (so slots are recycled); every kernel's count is set
    to 0 just before and read just after.  A kernel must launch
    ``per_prefill[name]`` times in each single-shot prefill and
    ``per_step[name]`` times in each batched decode step.  Returns the
    launches."""
    import torch

    from repro_torch.serve import InferenceServer, ServeConfig

    server = InferenceServer(
        arch, params, ServeConfig(slots=8, context=2048, max_prefill=1024, transport="collective")
    )
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=rng).tolist() for n in PROMPT_LENS]
    prompts[-1] = prompt[0].tolist()  # the phase-3 prompt: its first token is known
    SERVED_PROMPTS[arch.name] = prompts  # phase 4c serves them again
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
        f"decode_step={server.core.decode_seconds / max(server.core.steps, 1) * 1e3} ms "
        + " ".join(f"{name}.launches={n}" for name, n in launches.items()) + " transport=collective"
    )
    if len(done) != len(prompts):
        fail(f"{arch.name}: served {len(done)} of {len(prompts)} requests")
    bad = [r.rid for r in done if len(r.out_tokens) != MAX_NEW or not all(0 <= t < arch.vocab_size for t in r.out_tokens)]
    if bad:
        fail(f"{arch.name}: requests {bad} came back with a wrong number of tokens or out-of-vocab tokens")
    if reqs[-1].out_tokens[0] != first_tok:
        fail(f"{arch.name}: served first token {reqs[-1].out_tokens[0]} != the phase-3 prefill's argmax {first_tok}")
    prefills, steps = server.core.prefill_calls, server.core.steps
    if prefills != len(prompts):
        fail(f"{arch.name}: {prefills} single-shot prefills for {len(prompts)} requests")
    for name in kernels:
        n = per_prefill[name] * prefills + per_step[name] * steps
        if launches[name] != n:
            fail(f"{arch.name}: {name} launched {launches[name]} times, want {n} on this path "
                 f"({per_prefill[name]} x {prefills} prefills + {per_step[name]} x {steps} decode steps)")
    return launches


def encdec_path(arch, params, batch, first_tok, kernels, per_prefill, per_step) -> dict:
    """Phase 4b, the encoder-decoder: the server cannot take it (a request
    carries tokens only, as in the reference), so one batched ``prefill``
    of ``batch`` (rows of stub frames and prompts) then ENCDEC_STEPS greedy
    ``decode_step``s over every row; every kernel's count is set to 0 just
    before and read just after.  A kernel must launch ``per_prefill[name]``
    times in the prefill and ``per_step[name]`` times a decode step, and
    row 0's first token must be the phase-3 argmax.  Returns the launches."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    b, s = batch["tokens"].shape
    cache = init_cache(arch, b, 2048)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.inference_mode():
        logits, cache = prefill(params, arch, batch, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out = [tok.cpu()]
        t_prefill = time.monotonic() - t0
        after_prefill = {name: fn.launches for name, fn in kernels.items()}
        for i in range(ENCDEC_STEPS):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            logits, cache = decode_step(params, arch, tok[:, None], pos, cache)
            tok = torch.argmax(logits[:, 0], dim=-1)
            out.append(tok.cpu())
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    toks = torch.stack(out, dim=1)
    n = toks.numel()
    print(f"{arch.name} prefill+decode ({b} rows, {batch['frames'].shape[1]} frames, {s}-token prompts, "
          f"{ENCDEC_STEPS} decode steps): tokens={n} throughput={n / dt} tok/s wall={dt} s prefill={t_prefill} s "
          f"decode={dt - t_prefill} s decode_step={(dt - t_prefill) / ENCDEC_STEPS * 1e3} ms "
          + " ".join(f"{name}.launches={k}" for name, k in launches.items()) + " (model API)")
    if not bool(((toks >= 0) & (toks < arch.vocab_size)).all()):
        fail(f"{arch.name}: out-of-vocab tokens")
    if int(toks[0, 0]) != first_tok:
        fail(f"{arch.name}: row 0's first token {int(toks[0, 0])} != the phase-3 prefill's argmax {first_tok}")
    for name in kernels:
        got = (after_prefill[name], launches[name] - after_prefill[name])
        want = (per_prefill[name], per_step[name] * ENCDEC_STEPS)
        if got != want:
            fail(f"{arch.name}: {name} launched {got[0]} times in the prefill and {got[1]} in {ENCDEC_STEPS} "
                 f"decode steps, want {want}")
    return launches


def prefix_path(arch, params, batch, first_tok, kernels, per_prefill, per_step) -> dict:
    """Phase 4b, the VLM's prefix: the server serves text only (as the
    reference's), so one prefill of ``batch`` (a stub prefix, then text)
    and PREFIX_STEPS greedy decode steps at positions that count the
    prefix, through the model API; every kernel's count is set to 0 just
    before and read just after, and checked as in ``encdec_path``."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    s = batch["prefix"].shape[1] + batch["tokens"].shape[1]
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.inference_mode():
        logits, cache = prefill(params, arch, batch, init_cache(arch, 1, 2048))
        after_prefill = {name: fn.launches for name, fn in kernels.items()}
        toks = [int(torch.argmax(logits[0, -1]))]
        for i in range(PREFIX_STEPS):
            pos = torch.full((1,), s + i, dtype=torch.int32, device="cuda")
            logits, cache = decode_step(params, arch, torch.tensor([[toks[-1]]], device="cuda"), pos, cache)
            toks.append(int(torch.argmax(logits[0, 0])))
    dt = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"{arch.name} prefix prefill+decode ({batch['prefix'].shape[1]}-token prefix, {batch['tokens'].shape[1]} "
          f"tokens, {PREFIX_STEPS} decode steps at positions {s}..{s + PREFIX_STEPS - 1}): tokens={toks} wall={dt} s "
          + " ".join(f"{name}.launches={k}" for name, k in launches.items()) + " (model API)")
    if toks[0] != first_tok or not all(0 <= t < arch.vocab_size for t in toks):
        fail(f"{arch.name}: prefix path tokens {toks}, the first must be the phase-3 prefill's argmax {first_tok}")
    for name in kernels:
        got = (after_prefill[name], launches[name] - after_prefill[name])
        if got != (per_prefill[name], per_step[name] * PREFIX_STEPS):
            fail(f"{arch.name}: {name} launched {got} times (prefill, decode) on the prefix path")
    return launches


def family_path(name, layers, per_prefill, per_step, f32_cap, ops, kernels, gen) -> dict:
    """Phases 3b and 4b for one of the later families (see FAMILY_PATHS):
    its prefill check, then its serving path.  Returns {path: launches}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.tree import leaves

    arch = get_config(name)
    if layers is not None:
        arch = arch.variant(n_layers=layers)
    t0 = time.monotonic()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"{name}: {arch.n_layers} layers{'' if layers is None else ' (cut)'}, {n_params} params ({arch.dtype}) "
          f"built in {time.monotonic() - t0} s")
    stub = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    tokens = lambda b, s: torch.randint(0, arch.vocab_size, (b, s), generator=gen, device="cuda")  # noqa: E731
    paths = {}
    if arch.is_encdec:
        batch = {"tokens": tokens(ENCDEC_ROWS, ENCDEC_PROMPT), "frames": stub(ENCDEC_ROWS, arch.encoder_seq, arch.d_model)}
        first = prefill_check(arch, params, batch, ops, f32_cap)
        paths[name] = encdec_path(arch, params, batch, first, kernels, per_prefill, per_step)
    elif arch.frontend == "vision":
        batch = {"tokens": tokens(1, VLM_TEXT), "prefix": stub(1, arch.n_prefix_tokens, arch.d_model)}
        first_prefix = prefill_check(arch, params, batch, ops, f32_cap)
        first = int(torch.argmax(prefill_logits(arch, params, {"tokens": batch["tokens"]})[0, -1]))
        print(f"{name}: text-only prefill (S={VLM_TEXT}) through the kernels, argmax {first}")
        paths[name] = serve_path(arch, params, batch["tokens"], first, kernels, per_prefill, per_step)
        paths[f"{name} prefix"] = prefix_path(arch, params, batch, first_prefix, kernels, per_prefill, per_step)
    else:
        prompts = [tokens(1, s) for s in FAMILY_PROMPTS.get(name, (777,))]
        first = prefill_check(arch, params, {"tokens": prompts[0]}, ops, f32_cap)
        for long in prompts[1:]:
            prefill_check(arch, params, {"tokens": long}, ops, f32_cap)
        paths[name] = serve_path(arch, params, prompts[0], first, kernels, per_prefill, per_step)
    del params
    torch.cuda.empty_cache()
    return paths


def batch_invariance(arch, params) -> None:
    """Phase 4c: rows of ``decode_step`` at batch 1, 2, 4 and 8 for
    INVARIANCE_STEPS greedy steps from the same tokens at position 0; every
    row must be bit-identical to the same row at batch 8 (the reference's
    test, tests/test_fleet.py, at full width on the card)."""
    import torch

    from repro_torch.models import decode_step, init_cache

    start = torch.randint(0, arch.vocab_size, (max(INVARIANCE_BATCHES), 1),
                          generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    runs = {}
    with torch.inference_mode():
        for b in INVARIANCE_BATCHES:
            cache = init_cache(arch, b, 2048, "cuda")
            toks, pos, out = start[:b].clone(), torch.zeros(b, dtype=torch.long, device="cuda"), []
            for _ in range(INVARIANCE_STEPS):
                logits, cache = decode_step(params, arch, toks, pos, cache)
                out.append(logits[:, 0].float())
                toks, pos = logits[:, 0].argmax(-1)[:, None], pos + 1
            runs[b] = torch.stack(out, 1)  # (b, steps, V)
            del cache
    ref = runs[max(INVARIANCE_BATCHES)]
    diffs = {b: float((runs[b] - ref[:b]).abs().max()) for b in INVARIANCE_BATCHES}
    same = {b: bool(torch.equal(runs[b], ref[:b])) for b in INVARIANCE_BATCHES}
    print(f"{arch.name} decode rows vs batch {max(INVARIANCE_BATCHES)}, {INVARIANCE_STEPS} steps: "
          f"bit-identical {same}, max |logit difference| {diffs}")
    if not all(same.values()):
        fail(f"{arch.name}: decode_step rows depend on the batch size: {diffs}")
    # what the tile's padding costs a fleet worker's 4-row step (its cache
    # rows copied out to an 8-row tile and back) against an 8-row step; no
    # profiler reading: a session of ten model calls (~20,000 kernels)
    # drops some of its records, so it never counts as whole (device_ms)
    wall = {}
    with torch.inference_mode():
        for b in (4, 8):
            cache = init_cache(arch, b, 2048, "cuda")
            toks, pos = start[:b], torch.full((b,), 100, dtype=torch.long, device="cuda")
            wall[b] = cuda_ms(lambda: decode_step(params, arch, toks, pos, cache), iters=20)
            del cache
    print(f"{arch.name} decode_step at batch 4 (one padded tile, its cache rows copied out and back) vs 8: "
          f"wall {wall[4]} vs {wall[8]} ms")


def fleet_run(arch, params, transport, limits, prompts, kernels, churn: bool):
    """Phase 4c: the 16 requests through Fleet(workers=FLEET_WORKERS,
    slots=FLEET_SLOTS, max_workers=FLEET_MAX_WORKERS), all submitted at
    once; with ``churn`` worker 0 leaves once FLEET_LEAVE_AT of the tokens
    are out (its slots handed off as snapshot bytes), then a worker joins.
    Every kernel's count is set to 0 just before and read just after.
    Returns (streams, launches, the fleet's counters)."""
    import torch

    from repro_torch.serve import Fleet, FleetConfig

    fleet = Fleet(arch, params, FleetConfig(
        workers=FLEET_WORKERS, slots=FLEET_SLOTS, context=2048, max_prefill=1024, transport=transport,
        max_workers=FLEET_MAX_WORKERS, limits=limits))
    if churn and arch.name == PP_SNAPSHOT_ARCH:
        # keep the first hand-off snapshot for phase 7(b): the fleet has no
        # public hook on a hand-off, so this wraps Router._handoff.  Inside
        # the timed leave_worker it adds a dict membership test a hand-off;
        # the one kept is the snapshot codec's bytes object, not a copy
        handoff = fleet._handoff

        def keep(rid, payload):
            if "rsnp" not in PP_PAYLOADS:
                PP_PAYLOADS["rsnp"] = payload
            handoff(rid, payload)

        fleet._handoff = keep
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [fleet.submit(p, max_new=MAX_NEW) for p in prompts]
    leave_s, moved_while_leaving = None, None
    if churn:
        for _ in range(10_000):
            fleet.step()
            if fleet.tokens_out >= FLEET_LEAVE_AT * len(prompts) * MAX_NEW and fleet.workers[0].core.active_slots():
                break
        moved_while_leaving = len(fleet.workers[0].core.active_slots())
        t1 = time.monotonic()
        fleet.leave_worker(0)
        leave_s = time.monotonic() - t1
        fleet.add_worker()
    fleet.run_until_idle()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    done = [r for r in reqs if r.done_event.is_set()]
    ttft = sorted(r.first_token_at - r.submitted_at for r in done)
    stats = {
        "served": len(done), "wall": dt, "tokens": fleet.tokens_out, "handoffs": fleet.handoffs,
        "handoff_bytes": fleet.handoff_bytes, "leave_s": leave_s, "active_at_leave": moved_while_leaving,
        "eagain": fleet.eagain_events, "joins": fleet.joins, "leaves": fleet.leaves, "steps": fleet.steps,
        "puts": fleet.group.stats.puts, "ttft_p50": ttft[len(ttft) // 2] if ttft else float("nan"),
    }
    streams = [list(r.out_tokens) for r in reqs]
    fleet.close()
    return streams, launches, stats


def fleet_path(name, transport, per_prefill, kernels) -> dict:
    """Phase 4c for one model: the batch-invariance reading; the 16 phase-4
    requests through a single-host InferenceServer(slots=FLEET_SLOTS), the
    fleet without churn and the fleet with a mid-decode leave and a join,
    all over ``transport``.  Each request's stream must be bit-identical
    across the three; the churn run must hand slots off (and, over shmem,
    respond by one-sided puts); every kernel must launch per_prefill a
    single-shot prefill, 16 prefills a run.  Returns the launches of both
    fleet runs by path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.comm import ResourceLimits
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import InferenceServer, ServeConfig
    from repro_torch.tree import leaves

    arch = get_config(name)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    batch_invariance(arch, params)
    # a shared-memory slot must hold a handed-off slot's snapshot (its cache
    # row and a manifest): the default 64 KiB slots hold token batches only
    row = sum(t.numel() * t.element_size() for t in leaves(init_cache(arch, 1, 2048, "cuda")))
    limits = ResourceLimits(bounce_buffer_size=row + (1 << 20), recv_slots=16) if transport == "shmem" else ResourceLimits()
    print(f"{name}: one slot's cache row {row} bytes; {limits}")
    prompts = SERVED_PROMPTS[name]
    server = InferenceServer(arch, params, ServeConfig(
        slots=FLEET_SLOTS, context=2048, max_prefill=1024, transport=transport))
    t0 = time.monotonic()
    reqs = [server.submit(p, max_new=MAX_NEW) for p in prompts]
    server.run_until_idle()
    torch.cuda.synchronize()
    single = [list(r.out_tokens) for r in reqs]
    print(f"{name} single host ({FLEET_SLOTS} slots, {transport}): wall={time.monotonic() - t0} s "
          f"served={sum(r.done_event.is_set() for r in reqs)}/{len(prompts)}")
    out = {}
    for churn in (False, True):
        streams, launches, st = fleet_run(arch, params, transport, limits, prompts, kernels, churn)
        label = f"{name} fleet ({transport}{', leave + join' if churn else ''})"
        print(f"{label}: workers={FLEET_WORKERS} slots={FLEET_SLOTS} max_workers={FLEET_MAX_WORKERS} "
              f"requests={st['served']}/{len(prompts)} streams == single host: {streams == single} "
              f"handoffs={st['handoffs']} bytes a handed-off slot={st['handoff_bytes'] / max(st['handoffs'], 1)} "
              f"hand-off wall (leave_worker)={st['leave_s']} s active slots at the leave={st['active_at_leave']} "
              f"joins={st['joins']} leaves={st['leaves']} eagain={st['eagain']} puts={st['puts']} "
              f"ttft_p50={st['ttft_p50'] * 1e3} ms throughput={st['tokens'] / st['wall']} tok/s wall={st['wall']} s "
              f"router_steps={st['steps']} "
              + " ".join(f"{k}.launches={n}" for k, n in launches.items()))
        if st["served"] != len(prompts):
            fail(f"{label}: served {st['served']} of {len(prompts)} requests")
        if streams != single:
            bad = [i for i, (a, b) in enumerate(zip(streams, single)) if a != b]
            fail(f"{label}: the streams of requests {bad} differ from the single host's")
        want = {k: n * len(prompts) for k, n in per_prefill.items()}
        if launches != want:
            fail(f"{label}: launches {launches}, want {want} (one prefill a request, none again on adoption)")
        if churn and not (st["handoffs"] > 0 and st["leaves"] == 1 and st["joins"] == 1):
            fail(f"{label}: handoffs={st['handoffs']} leaves={st['leaves']} joins={st['joins']}")
        if transport == "shmem" and not st["puts"] > 0:
            fail(f"{label}: no response rode a one-sided put (puts={st['puts']})")
        out[label] = launches
    del params, server
    gc.collect()  # a router and its workers form a reference cycle
    torch.cuda.empty_cache()
    print(f"{name} fleet phase done: {torch.cuda.memory_allocated()} bytes still allocated on the card")
    return out


# The gradient pack on the reference's cases (tests/test_grad_pack.py): the
# Fig-3 ladder, f32 and bf16 ragged trees, the edge trees; then 10 steps of
# error feedback.  Kernel bytes and new EF must equal the host reference's
# (pack_grads_q8) and the plain version's bit for bit.
GRAD_PACK_LADDER = (512, 4096, 8192, 16384, 32768, 65536)
# Training: tinyllama-1.1b at full width and depth, bf16, int8 error
# feedback, on one fixed SyntheticLM batch (the reference test's check that
# the loss falls, at full width); the gate against the plain path runs on
# the first TRAIN_GATE_LAYERS layers at full width.
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 8
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 1e-3, 2, 20
TRAIN_GATE_LAYERS = 2
# The train gate, as shares of the largest |grad| (and of the loss), set
# from a reading on an H100 (PERF.md): f32 kernels vs f32 plain, where
# only the flash forward's summation order differs (read 5.9e-7 of max
# |grad|; held to 1e-5); bf16 kernels vs bf16 plain (read 0.52%; held to
# about twice that, 1%); and both bf16 runs against the f32 plain run, the
# kernel run no farther than the plain run by more than F32_MARGIN and
# under TRAIN_F32_CAP, about twice the plain run's reading of 0.59%.
TRAIN_F32_TOL = 1e-5
TRAIN_BF16_TOL = 1e-2
TRAIN_F32_CAP = 1.2e-2
GRAD_PACK_BYTES = 13  # read g and ef (4 + 4), write q (1) and the new ef (4)
GRAD_PACK_OPS = 9  # add, abs, max, div, round, 2 clamps, sub, mul


def _np_tree(tree, dtype="float32"):
    import torch

    return {k: torch.from_numpy(v.astype("float32")).to(getattr(torch, dtype)).cuda() for k, v in tree.items()}


def grad_pack_cases():
    """(name, tree) of the reference test's cases, on the card."""
    import numpy as np
    import torch

    for n in GRAD_PACK_LADDER:
        rng = np.random.default_rng(n)
        a, b = max(1, n // 2), max(1, n // 3)
        yield f"fig3_{n}", _np_tree({"w": rng.standard_normal(a), "b": rng.standard_normal(b) * 1e-3,
                                      "v": rng.standard_normal(max(0, n - a - b))})
    for dtype in ("float32", "bfloat16"):
        rng = np.random.default_rng(11)
        mk = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(getattr(torch, dtype)).cuda()  # noqa: E731
        yield f"ragged_{dtype}", {"attn": (mk((33, 17)), mk((129,))), "mlp": [mk((7, 3, 5)), mk((1,))]}
    yield "scalar", {"s": torch.tensor(0.75, device="cuda")}
    yield "empty_leaf", {"e": torch.zeros((0,), device="cuda"), "w": torch.ones((3,), device="cuda")}
    yield "empty_tree", {}


def _zeros_ef(tree):
    import torch

    from repro_torch.tree import tree_map

    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), tree)


def _bits_equal(a, b) -> bool:
    """Two trees of tensors equal bit for bit: the same dtypes and shapes,
    floats compared as their bit patterns (on the first one's device)."""
    import torch

    from repro_torch.tree import leaves

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(ints.get(x.dtype, x.dtype)), y.to(x.device).view(ints.get(y.dtype, y.dtype)))
        for x, y in zip(la, lb)
    )


def pack_three(tree, ef_k, ef_p, ef_h, name) -> tuple:
    """One pack through the kernel, the plain version and the host
    reference, each from its own EF; fails unless the three wires are equal
    and the new EF trees equal bit for bit.  Returns the three new EF trees
    and the host reference's seconds."""
    from repro_torch.kernels.grad_pack import pack_grads_fused, pack_grads_fused_plain
    from repro_torch.train.grad_sync import pack_grads_q8

    got, new_k = pack_grads_fused(tree, ef_k)
    plain, new_p = pack_grads_fused_plain(tree, ef_p)
    t0 = time.monotonic()
    host, new_h = pack_grads_q8(tree, ef_h)
    host_s = time.monotonic() - t0
    ok = got == plain == host and _bits_equal(new_k, new_p) and _bits_equal(new_h, new_k)
    print(f"grad_pack {name}: wire {len(got)} bytes, kernel == plain == host: {ok} "
          f"(host reference {host_s} s) {'ok' if ok else 'MISS'}")
    if not ok:
        fail(f"grad_pack at {name}: kernel, plain and host wires or EF differ")
    return new_k, new_p, new_h, host_s


def check_grad_pack() -> None:
    """Phase 2: the grad-pack kernel against its plain version and the host
    reference on the reference test's cases and over 10 EF steps."""
    import numpy as np

    from repro_torch.tree import tree_map

    for name, tree in grad_pack_cases():
        pack_three(tree, _zeros_ef(tree), _zeros_ef(tree), _zeros_ef(tree), name)
    rng = np.random.default_rng(23)
    tree0 = _np_tree({"w": rng.standard_normal(640), "b": rng.standard_normal(9) * 1e-4})
    ef_k = ef_p = ef_h = _zeros_ef(tree0)
    for step in range(10):
        g = tree_map(lambda x: x * (1.0 + 0.1 * step) + 0.01 * step, tree0)
        ef_k, ef_p, ef_h, _ = pack_three(g, ef_k, ef_p, ef_h, f"multistep EF step {step}")


def _max_abs(x, y=None, chunk=1 << 26) -> float:
    """max |x| (or max |x - y|) in f32, a chunk of elements at a time, so
    that a 1 B-element leaf (llama4's embeddings) needs no full-size f32
    temporaries."""
    xf, yf = x.reshape(-1), None if y is None else y.reshape(-1)
    out = 0.0
    for i in range(0, xf.numel(), chunk):
        d = xf[i : i + chunk].float()
        if yf is not None:
            d = d - yf[i : i + chunk].float()
        out = max(out, d.abs().max().item())
    return out


def _grad_rel(a, b, ref) -> float:
    """max |a - b| over all leaves, as a share of max |ref|."""
    from repro_torch.tree import leaves

    err = max(_max_abs(x, y) for x, y in zip(leaves(a), leaves(b)))
    return err / max(_max_abs(r) for r in leaves(ref))


def train_batch(arch, seed, seq=None):
    """Batch 0 of the SyntheticLM stream of ``seed`` (B=TRAIN_B, S=``seq``
    or TRAIN_S) on the card: tokens and labels as int64, the frontends'
    stubs (a VLM's ``prefix``, an encoder's ``frames``) in the model's
    dtype, as ``Trainer`` moves them."""
    import torch

    from repro_torch.data import SyntheticLM

    b = SyntheticLM(arch, TRAIN_B, seq or TRAIN_S, seed=seed).make_batch(0)
    return {k: torch.from_numpy(v).cuda().to(torch.long if k in ("tokens", "labels") else getattr(torch, arch.dtype))
            for k, v in b.items()}


def train_gate(ops) -> None:
    """Phase 5: the train step's loss and gradients through the kernels
    against the plain path, at full width on the first TRAIN_GATE_LAYERS
    layers, in f32 and bf16 (see TRAIN_F32_TOL)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_map

    arch = get_config(TRAIN_ARCH).variant(n_layers=TRAIN_GATE_LAYERS)
    arch32 = arch.variant(dtype="float32")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    p32 = tree_map(lambda t: t.float(), params)
    batch = train_batch(arch, 0)
    (lk32, _), gk32 = loss_and_grads(p32, arch32, batch)
    with plain_kernels(ops):
        (lp32, _), gp32 = loss_and_grads(p32, arch32, batch)
        (lp, _), gp = loss_and_grads(params, arch, batch)
    (lk, _), gk = loss_and_grads(params, arch, batch)
    torch.cuda.synchronize()
    f32 = _grad_rel(gk32, gp32, gp32)
    bf16 = _grad_rel(gk, gp, gp)
    rel_k, rel_p = _grad_rel(gk, gp32, gp32), _grad_rel(gp, gp32, gp32)
    lf32, lbf16 = abs(lk32.item() - lp32.item()) / lp32.item(), abs(lk.item() - lp.item()) / lp.item()
    print(f"train gate ({TRAIN_ARCH}, {TRAIN_GATE_LAYERS} layers, full width, B={TRAIN_B} S={TRAIN_S}): "
          f"f32 kernels vs plain: loss rel={lf32} grads rel={f32} tol={TRAIN_F32_TOL}; bf16 kernels vs plain: "
          f"loss rel={lbf16} grads rel={bf16} tol={TRAIN_BF16_TOL}; vs f32 plain: kernels rel={rel_k} plain rel={rel_p} "
          f"tol=min(plain + {F32_MARGIN}, {TRAIN_F32_CAP})")
    ok = (f32 <= TRAIN_F32_TOL and lf32 <= TRAIN_F32_TOL and bf16 <= TRAIN_BF16_TOL and lbf16 <= TRAIN_BF16_TOL
          and rel_k <= rel_p + F32_MARGIN and rel_k <= TRAIN_F32_CAP)
    if not (ok and all(math.isfinite(x) for x in (f32, bf16, rel_k, rel_p))):
        fail("the train step through the kernels disagrees with the plain path")
    del params, p32, gk32, gp32, gp, gk
    torch.cuda.empty_cache()


def train_path(kernels) -> tuple:
    """Phase 5: tinyllama-1.1b trains TRAIN_STEPS steps at full width with
    int8_ef on one fixed batch; then two data-parallel "ranks" (batches of
    seeds 0 and 1) take that state's gradients, pack them with
    make_packer("device"), exchange the wires over the port's CommChannel,
    unpack and average, which must equal the direct average bit for bit.
    Every kernel's count is set to 0 just before and read just after.
    Returns (launches, the two gradient trees, the per-step flash count)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.comm import CommChannel
    from repro_torch.optim import OptHParams
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.grad_sync import make_packer
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    arch = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(microbatches=1, remat="none", grad_sync="int8_ef")
    t0 = time.monotonic()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
    step_fn = make_train_step(arch, OptHParams(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL), tcfg)
    batches = [train_batch(arch, 0), train_batch(arch, 1)]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    print(f"{TRAIN_ARCH} train: {n_params} params ({arch.dtype}), state built in {time.monotonic() - t0} s")
    flash = kernels["flash_attention"]
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        f0, t0 = flash.launches, time.monotonic()
        state, met = step_fn(state, batches[0])
        losses.append(float(met["loss"]))  # waits for the step
        walls.append(time.monotonic() - t0)
        per_step.append(flash.launches - f0)
        print(f"{TRAIN_ARCH} train step {i}: loss={losses[-1]} grad_norm={float(met['grad_norm'])} lr={float(met['lr'])} "
              f"wall={walls[-1]} s tokens/s={TRAIN_B * TRAIN_S / walls[-1]} flash.launches={per_step[-1]}")
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls[1:])[len(walls[1:]) // 2]
    print(f"{TRAIN_ARCH} train: {TRAIN_STEPS} steps B={TRAIN_B} S={TRAIN_S} int8_ef remat=none: loss {losses[0]} -> "
          f"{losses[-1]}; median step (after the first) {med} s, {TRAIN_B * TRAIN_S / med} tokens/s; "
          f"first step {walls[0]} s; peak memory {peak / 2**30} GiB")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{TRAIN_ARCH}: the loss did not fall over {TRAIN_STEPS} steps on a fixed batch: {losses}")
    if any(n != arch.n_layers for n in per_step):
        fail(f"{TRAIN_ARCH}: flash attention launched {per_step} times in the train steps, want {arch.n_layers} a step")

    # the DP exchange: each rank's gradients at this state, packed on the card
    grads = [loss_and_grads(state["params"], arch, b, tcfg.remat)[1] for b in batches]
    del state
    torch.cuda.empty_cache()
    pack = make_packer("device")
    zeros = _zeros_ef(grads[0])
    t0 = time.monotonic()
    wires = [pack(g, zeros)[0] for g in grads]
    torch.cuda.synchronize()
    pack_s = time.monotonic() - t0
    PP_PAYLOADS["q8"] = bytes(memoryview(wires[0])[:PP_WIRE_SLICE])  # phase 7(b) carries it
    same, _ = dp_exchange(CommChannel(), wires, grads)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"{TRAIN_ARCH} DP exchange: 2 ranks, wires of {len(wires[0])} bytes packed in {pack_s} s, "
          f"averaged over the CommChannel == direct average bit for bit: {same}; "
          + " ".join(f"{name}.launches={n}" for name, n in launches.items()))
    if not same:
        fail("DP exchange: the average over the CommChannel differs from the direct average")
    del zeros, wires
    torch.cuda.empty_cache()
    return launches, grads, per_step


def dp_exchange(channel, wires, grads) -> tuple:
    """Rank 0's wire as a request, rank 1's as a response over ``channel``;
    each side unpacks its peer's and averages.  Returns (the averages equal
    the direct average of the two ranks' own unpacked wires bit for bit,
    the wires arrived bit for bit)."""
    import torch

    from repro_torch.kernels.grad_pack import unpack_grads_fused
    from repro_torch.tree import leaves

    channel.send_request(wires[0])  # rank 0 -> rank 1
    channel.send_response(wires[1])  # rank 1 -> rank 0
    for _ in range(4):
        channel.progress()
    arrived = {}
    for source in ("request", "response"):
        for _ in range(8):
            rec = channel.reap(source)
            if rec is not None and rec.op == "recv":
                arrived[source] = rec.data
                break
    if set(arrived) != {"request", "response"}:
        fail(f"DP exchange: the wires did not arrive over the CommChannel ({sorted(arrived)})")
    intact = bytes(arrived["request"]) == bytes(wires[0]) and bytes(arrived["response"]) == bytes(wires[1])
    deq = [unpack_grads_fused(w, g) for w, g in zip(wires, grads)]
    from_peer0 = unpack_grads_fused(arrived["request"], grads[1])
    from_peer1 = unpack_grads_fused(arrived["response"], grads[0])
    same = all(
        torch.equal((a + p1) / 2, (a + b) / 2) and torch.equal((p0 + b) / 2, (a + b) / 2)
        for a, b, p0, p1 in zip(leaves(deq[0]), leaves(deq[1]), leaves(from_peer0), leaves(from_peer1))
    )
    return same, intact


def device_stage_path(grads, kernels) -> dict:
    """Phase 4c's device stage: phase 5's two-rank DP exchange once more,
    each rank's gradients packed again on the card (one pack a rank), over
    CommChannel(stage="device"): every progress drain rides one staged
    buffer on the card, one copy each way.  The wires must arrive bit for
    bit and the averages equal the direct average bit for bit.  Every
    kernel's count is set to 0 just before and read just after.  Returns
    the launches."""
    import torch

    from repro_torch.core.comm import CommChannel
    from repro_torch.train.grad_sync import make_packer

    for fn in kernels.values():
        fn.launches = 0
    pack = make_packer("device")
    zeros = _zeros_ef(grads[0])
    wires = [pack(g, zeros)[0] for g in grads]
    del zeros
    channel = CommChannel(stage="device")
    t0 = time.monotonic()
    same, intact = dp_exchange(channel, wires, grads)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    st = channel.group.stats
    print(f"{TRAIN_ARCH} DP exchange over CommChannel(stage='device') on {channel.group.device}: wires arrived bit "
          f"for bit: {intact}; average == direct average bit for bit: {same}; staged_batches={st.staged_batches} "
          f"staged_bytes={st.staged_bytes} wall={time.monotonic() - t0} s "
          + " ".join(f"{name}.launches={n}" for name, n in launches.items()))
    if not (same and intact):
        fail(f"device-stage DP exchange: wires intact {intact}, average bit for bit {same}")
    if st.staged_batches < 1 or st.staged_bytes != sum(len(w) for w in wires):
        fail(f"device-stage DP exchange: staged {st.staged_batches} batches of {st.staged_bytes} bytes, "
             f"want every wire byte ({sum(len(w) for w in wires)}) staged")
    if launches != dict(NO_LAUNCH, quantize_pack=2):
        fail(f"device-stage DP exchange: launches {launches}, want one pack a rank")
    del wires
    torch.cuda.empty_cache()
    return launches


def grad_pack_full(grads) -> dict:
    """Phase 5: the grad-pack kernel at the full-width tinyllama gradient
    tree over 2 EF steps (rank 0's gradients, then rank 1's), bit for bit
    against the plain version and the host reference; then its times (the
    kernel alone on the flattened tiles, the plain version on the same
    inputs, the whole pack_grads_fused with flatten and the copy to the
    host) and its bound."""
    import torch

    from repro_torch.kernels import grad_pack as gp
    from repro_torch.tree import leaves

    ef_k = ef_p = ef_h = _zeros_ef(grads[0])
    host_s = []
    for step, g in enumerate(grads):
        ef_k, ef_p, ef_h, s = pack_three(g, ef_k, ef_p, ef_h, f"{TRAIN_ARCH} full-width gradient tree, EF step {step}")
        host_s.append(s)
    del ef_p, ef_h
    g = grads[1]
    plan = gp._plan(g, leaves(g))
    n_leaves = len(plan.specs)
    gt, et = plan.flatten(leaves(g), leaves(ef_k))
    body = torch.empty(8 * n_leaves + plan.n_tiles * gp.TILE, dtype=torch.uint8, device="cuda")
    body[: 4 * n_leaves].copy_(plan.offs_dev)
    body_p = body.clone()
    ef_out = gp.quantize_pack(gt, et, plan.seg_dev, n_leaves, body)
    ef_plain = gp.quantize_pack_plain(gt, et, plan.seg_dev, n_leaves, body_p)
    err = (ef_out - ef_plain).abs().max().item()
    if not (torch.equal(body, body_p) and err == 0.0):
        fail(f"grad_pack at the full-width tree: kernel and plain bodies or EF differ (max |d ef| {err})")
    del ef_out, ef_plain, body_p
    t_kernel = cuda_ms(lambda: gp.quantize_pack(gt, et, plan.seg_dev, n_leaves, body), iters=20, warmup=3)
    t_plain = cuda_ms(lambda: gp.quantize_pack_plain(gt, et, plan.seg_dev, n_leaves, body), iters=5, warmup=1)
    t_kernel2 = cuda_ms(lambda: gp.quantize_pack(gt, et, plan.seg_dev, n_leaves, body), iters=20, warmup=3)
    n = plan.n_tiles * gp.TILE
    peak_flops, peak_bytes = peaks()
    t_bytes, t_ops = GRAD_PACK_BYTES * n / peak_bytes, GRAD_PACK_OPS * n / peak_flops["float32"]
    bound, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
    t_device = device_ms(lambda: gp.quantize_pack(gt, et, plan.seg_dev, n_leaves, body), iters=10, bound_ms=bound)
    del gt, et
    torch.cuda.empty_cache()
    t_whole = cuda_ms(lambda: gp.pack_grads_fused(g, ef_k), iters=3, warmup=1)
    print(f"grad_pack {TRAIN_ARCH} gradient tree ({n_leaves} leaves, {sum(s.nelems for s in plan.specs)} elements, "
          f"{n} padded, largest leaf {max(s.nelems for s in plan.specs)}): kernel={t_kernel} ms (again {t_kernel2} ms) "
          f"device={t_device} ms "
          f"plain={t_plain} ms whole pack_grads_fused={t_whole} ms bound={bound} ms ({bound_by}); "
          f"host reference {host_s} s a step")
    return {"ms": t_kernel, "plain_ms": t_plain, "whole_ms": t_whole, "bound_ms": bound, "bound_by": bound_by,
            "max_abs_err": err, "device_ms": t_device}


def family_train_gate(ops, ft) -> None:
    """Phase 5b: one family's train step, loss and gradients through the
    kernels against the plain path, at full width on its first
    ``ft.gate_layers`` layers (of each stack, where the model has an
    encoder), f32 and bf16, on its train batch (see FAMILY_TRAINS).  The
    f32 runs take the weights converted in place, one leaf at a time, and
    back after them (bf16 -> f32 -> bf16 is exact), and the stubs cast from
    the bf16 ones; each gradient tree is freed once its distances are read,
    so at most the f32 weights and two f32 gradient trees (12 B a
    parameter) are on the card at once: llama4's one layer and embeddings,
    4.27 B parameters, have no room for the 18 B a parameter of an f32
    copy beside four trees.  A MoE model's four runs share the f32 kernel
    run's expert choices, each with its own gates and aux loss
    (``routes(regate=True)``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.step import loss_and_grads

    arch = get_config(ft.name).variant(n_layers=ft.gate_layers)
    if arch.is_encdec:
        arch = arch.variant(encoder_layers=ft.gate_layers)
    arch32 = arch.variant(dtype="float32")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    batch = train_batch(arch, 0, ft.seq)
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    dtypes = dtypes_of(params)
    retype_(params, torch.float32)
    with routes() as r32:
        (lk32, mk32), gk32 = loss_and_grads(params, arch32, batch32)
    replay = r32.routes if r32.routes else None
    with plain_kernels(ops), routes(replay, regate=True):
        (lp32, mp32), gp32 = loss_and_grads(params, arch32, batch32)
    f32 = _grad_rel(gk32, gp32, gp32)
    del gk32
    retype_(params, dtypes)
    torch.cuda.empty_cache()
    with plain_kernels(ops), routes(replay, regate=True):
        (lp, _), gp = loss_and_grads(params, arch, batch)
    rel_p = _grad_rel(gp, gp32, gp32)
    with routes(replay, regate=True):
        (lk, mk), gk = loss_and_grads(params, arch, batch)
    rel_k, bf16 = _grad_rel(gk, gp32, gp32), _grad_rel(gk, gp, gp)
    torch.cuda.synchronize()
    lf32 = abs(lk32.item() - lp32.item()) / lp32.item()
    aux = f" aux f32 kernels {mk32['aux'].item()} plain {mp32['aux'].item()} bf16 kernels {mk['aux'].item()};" if replay else ""
    enc = f" + {arch.encoder_layers} encoder layers over {arch.encoder_seq} frames" if arch.is_encdec else ""
    pre = f" after a {arch.n_prefix_tokens}-token prefix" if "prefix" in batch else ""
    print(f"train gate ({ft.name}, {ft.gate_layers} layers{enc}, full width, B={TRAIN_B} S={ft.seq}{pre}"
          f"{', expert choices of the f32 kernel run' if replay else ''}): f32 kernels vs plain: loss rel={lf32} "
          f"grads rel={f32} tol={FAMILY_F32_TOL};{aux} bf16 kernels vs bf16 plain: grads rel={bf16}; vs f32 plain: "
          f"kernels rel={rel_k} plain rel={rel_p} tol=min(plain + {F32_MARGIN}, {ft.f32_cap})")
    ok = f32 <= FAMILY_F32_TOL and lf32 <= FAMILY_F32_TOL and rel_k <= rel_p + F32_MARGIN and rel_k <= ft.f32_cap
    if not (ok and all(math.isfinite(x) for x in (f32, bf16, rel_k, rel_p, lk.item()))):
        fail(f"{ft.name}: the train step through the kernels disagrees with the plain path")
    del params, gp32, gp, gk
    torch.cuda.empty_cache()


def family_train(kernels, ft) -> dict:
    """Phase 5b: one family trains FAMILY_TRAIN_STEPS steps at full width
    (its first ``ft.layers`` layers, or all), at its sequence length and
    remat mode, on one fixed batch; the loss must fall, and every kernel
    must launch ``ft.per_step[kernel]`` times each step.  Every kernel's
    count is set to 0 just before the steps and read just after.  Returns
    the launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import OptHParams
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import leaves

    name = ft.name
    arch = get_config(name)
    if ft.layers is not None:
        arch = arch.variant(n_layers=ft.layers)
    tcfg = TrainConfig(microbatches=1, remat=ft.remat, grad_sync=ft.grad_sync)
    t0 = time.monotonic()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
    step_fn = make_train_step(arch, OptHParams(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL), tcfg)
    batch = train_batch(arch, 0, ft.seq)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    print(f"{name} train: {arch.n_layers} layers, {n_params} params ({arch.dtype}), state built in {time.monotonic() - t0} s")
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tokens = TRAIN_B * ft.seq
    losses, walls, steps = [], [], []
    for i in range(FAMILY_TRAIN_STEPS):
        before, t0 = {k: fn.launches for k, fn in kernels.items()}, time.monotonic()
        state, met = step_fn(state, batch)
        losses.append(float(met["loss"]))  # waits for the step
        walls.append(time.monotonic() - t0)
        steps.append({k: fn.launches - before[k] for k, fn in kernels.items()})
        print(f"{name} train step {i}: loss={losses[-1]} aux={float(met['aux'])} grad_norm={float(met['grad_norm'])} "
              f"wall={walls[-1]} s tokens/s={tokens / walls[-1]} "
              + " ".join(f"{k}.launches={n}" for k, n in steps[-1].items()))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls[1:])[len(walls[1:]) // 2]
    extra = (f" + {arch.encoder_seq} frames through {arch.encoder_layers} encoder layers" if arch.is_encdec else "") + (
        f" after a {arch.n_prefix_tokens}-token prefix" if "prefix" in batch else "")
    print(f"{name} train: {FAMILY_TRAIN_STEPS} steps B={TRAIN_B} S={ft.seq}{extra} {arch.n_layers} layers "
          f"{ft.grad_sync} remat={ft.remat} gate layers={ft.gate_layers}: loss {losses[0]} -> {losses[-1]}; "
          f"median step (after the first) {med} s, {tokens / med} tokens/s; "
          f"first step {walls[0]} s; peak memory {peak / 2**30} GiB")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall over {FAMILY_TRAIN_STEPS} steps on a fixed batch: {losses}")
    if any(n != ft.per_step for n in steps):
        fail(f"{name}: launches a step {steps}, want {ft.per_step}")
    del state
    torch.cuda.empty_cache()
    return launches


def restart_path(kernels) -> dict:
    """Phase 5c: checkpoint/restart on the card.  ``Trainer`` runs
    RESTART_ARCH at full depth with int8_ef for RESTART_EVERY steps with a
    checkpoint directory (asynchronous saves through its executor: every
    RESTART_EVERY steps, then once more at the end, waited for); a second
    ``Trainer`` on the same directory must restore that step, bit for bit
    the state the first one saved, and run the rest of RESTART_STEPS; a
    third runs all RESTART_STEPS with no checkpoint.  The resumed losses
    must equal the uninterrupted run's bit for bit (whether the first run's
    equal it over the same steps is printed: it tells a lost restore from
    a card that does not repeat a run).  Every
    kernel's count is set to 0 just before the first run and read just
    after the third: the SSD kernel once a layer a step.  Returns the
    launches."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import OptHParams
    from repro_torch.train import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = get_config(RESTART_ARCH)
    tcfg = TrainConfig(microbatches=1, remat="none", grad_sync="int8_ef")
    hp = OptHParams(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)

    def trainer(steps, ckpt_dir):
        run = TrainerConfig(batch=TRAIN_B, seq=TRAIN_S, steps=steps, ckpt_every=RESTART_EVERY, ckpt_dir=ckpt_dir,
                            log_every=RESTART_STEPS)
        return Trainer(arch, hp, tcfg, run, device="cuda")

    def timed(fn, walls):
        def call(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            return out
        return call

    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    save_walls, restore_walls, restored_equal = [], [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        first = trainer(RESTART_EVERY, ckpt_dir)
        first.ckpt.save = timed(first.ckpt.save, save_walls)
        first.train()
        saved = first.state
        files = list((Path(ckpt_dir) / f"step_{RESTART_EVERY}").iterdir())
        n_bytes = sum(f.stat().st_size for f in files)
        resumed = trainer(RESTART_STEPS, ckpt_dir)
        restore = timed(resumed.ckpt.restore, restore_walls)

        def checked_restore(like, step=None):
            out = restore(like, step)
            restored_equal.append(_bits_equal(out[0], saved))
            return out

        resumed.ckpt.restore = checked_restore
        resumed.train()
        kept = resumed.ckpt.available_steps()
    del saved
    first.state = resumed.state = None
    torch.cuda.empty_cache()
    whole = trainer(RESTART_STEPS, None)
    whole.train()
    whole.state = None
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    torch.cuda.empty_cache()
    loss = lambda t: [r["loss"] for r in t.metrics_log]  # noqa: E731
    run1, res, ref = loss(first), loss(resumed), loss(whole)
    repeats = run1 == ref[:RESTART_EVERY]
    print(f"{RESTART_ARCH} restart ({arch.n_layers} layers, int8_ef, B={TRAIN_B} S={TRAIN_S}): saved step {RESTART_EVERY}, "
          f"{n_bytes} bytes in {len(files)} files; save calls {save_walls} s (asynchronous at step {RESTART_EVERY}, "
          f"then the final save, waited for); restored step {resumed.start_step} in {restore_walls} s, the state bit "
          f"for bit the saved one: {restored_equal}; kept steps {kept}; losses: run 1 {run1}, resumed {res}, "
          f"uninterrupted {ref}; run 1 repeats the uninterrupted run bit for bit: {repeats}; "
          + " ".join(f"{k}.launches={n}" for k, n in launches.items()))
    if restored_equal != [True] or resumed.start_step != RESTART_EVERY:
        fail(f"{RESTART_ARCH}: the resumed Trainer restored step {resumed.start_step}, bit for bit: {restored_equal}")
    if [r["step"] for r in resumed.metrics_log] != list(range(RESTART_EVERY, RESTART_STEPS)):
        fail(f"{RESTART_ARCH}: the resumed Trainer ran steps {[r['step'] for r in resumed.metrics_log]}")
    if not all(math.isfinite(x) for x in ref) or res != ref[RESTART_EVERY:]:
        fail(f"{RESTART_ARCH}: the resumed losses {res} differ from the uninterrupted run's {ref[RESTART_EVERY:]}")
    want = dict(NO_LAUNCH, ssd_chunk_kernel=arch.n_layers * 2 * RESTART_STEPS)  # 3 + 3 resumed + 6 uninterrupted
    if launches != want:
        fail(f"{RESTART_ARCH} restart: launches {launches}, want {want}")
    return launches


# The served models, in order; the launches each kernel must make per
# prefill and per decode step on its path: one flash attention per
# attention layer in a prefill (zamba2's shared block runs at layers 0, 6,
# ..., 36: 7), one SSD chunk scan per SSM layer in a prefill, three grouped
# matmuls (gate, up, down) per MoE layer in every model call; the cap on
# the kernel prefill's distance from f32, about twice the plain bf16 run's
# own as measured on an H100 (1.46%, 1.83%, 4.23% and, for deepseek on 4
# layers on the f32 run's routing, 1.39% of max |logit|); and the layers of
# the f32 comparison (all, or deepseek's first DEEPSEEK_F32_LAYERS).
NO_LAUNCH = {"flash_attention": 0, "ssd_chunk_kernel": 0, "grouped_matmul": 0, "quantize_pack": 0}
PATHS = [
    ("tinyllama-1.1b", dict(NO_LAUNCH, flash_attention=22), NO_LAUNCH, 3e-2, None),
    ("mamba2-130m", dict(NO_LAUNCH, ssd_chunk_kernel=24), NO_LAUNCH, 4e-2, None),
    ("zamba2-1.2b", dict(NO_LAUNCH, flash_attention=7, ssd_chunk_kernel=38), NO_LAUNCH, 8e-2, None),
    ("deepseek-moe-16b", dict(NO_LAUNCH, flash_attention=28, grouped_matmul=84), dict(NO_LAUNCH, grouped_matmul=84),
     3e-2, DEEPSEEK_F32_LAYERS),
]

# Phase 4c, the fleet: each model (full width and depth, bf16, seed 0) with
# its transport and the launches each kernel must make a single-shot
# prefill.  Decode launches no kernel on these two paths, and an adopted slot
# is never prefilled again, so a fleet run of the 16 phase-4 requests makes
# exactly 16 prefills' worth.  The fleet: FLEET_WORKERS workers of
# FLEET_SLOTS // FLEET_WORKERS slots, rank slots for FLEET_MAX_WORKERS.
FLEET_PATHS = [
    ("tinyllama-1.1b", "collective", dict(NO_LAUNCH, flash_attention=22)),
    ("mamba2-130m", "shmem", dict(NO_LAUNCH, ssd_chunk_kernel=24)),
]
FLEET_SLOTS, FLEET_WORKERS, FLEET_MAX_WORKERS = 8, 2, 3
# worker 0 leaves once the fleet has emitted this share of all its tokens
FLEET_LEAVE_AT = 0.25
# batch sizes of the batch-invariance reading, and its steps
INVARIANCE_BATCHES, INVARIANCE_STEPS = (1, 2, 4, 8), 4
SERVED_PROMPTS = {}  # phase 4's prompts by model, filled by serve_path

# Phases 3b/4b, the later families at full width, bf16, random weights from
# seed 0, each as (model, layers on the card (None: all), the launches each
# kernel must make a prefill and a decode step, the cap of the kernel
# prefill's distance from f32).  MLA has no kernel in the reference, so
# minicpm3's counts all read 0; whisper's prefill runs flash in its 32
# encoder layers (bidirectional) and its 32 decoder self-attention layers,
# and its cross-attention (128 queries against 1500 frames) on plain ops;
# internvl2 (70.6 B parameters at full depth, ~141 GB in bf16) is cut to 8
# of its 80 layers, 8.95 B parameters; llama4-scout (107.8 B, ~216 GB) to 4
# of its 48, 10.88 B parameters, so that layer 3 is a global one: flash once
# a layer, the grouped matmul 3 times a MoE layer in every model call.
# The caps are about twice the plain bf16 run's distance from f32 as read
# on an H100 80GB HBM3 at 700 W (PERF.md, §6): 1.093% of max |logit| for minicpm3,
# 1.279% for whisper, 1.172% for internvl2 and, on the f32 run's routing,
# 1.015% and 0.992% for llama4 at S = 1024 and 9216 (the kernel runs read
# 1.093%, 1.334%, 1.002%, 1.087% and 1.030%).
FAMILY_PATHS = [
    ("minicpm3-4b", None, NO_LAUNCH, NO_LAUNCH, 2.2e-2),
    ("whisper-large-v3", None, dict(NO_LAUNCH, flash_attention=64), NO_LAUNCH, 2.6e-2),
    ("internvl2-76b", 8, dict(NO_LAUNCH, flash_attention=8), NO_LAUNCH, 2.4e-2),
    ("llama4-scout-17b-a16e", 4, dict(NO_LAUNCH, flash_attention=4, grouped_matmul=12),
     dict(NO_LAUNCH, grouped_matmul=12), 2.0e-2),
]
# whisper: 8 rows of 1500-frame stubs and 128-token prompts, then 32 decode
# steps; internvl2: a 256-token stub prefix and 768 tokens of text, then 3
# decode steps; the others' prefill checks at 777 tokens, llama4's at S =
# 1024 (the served prompt) and at S = 9216, past its first 8192-token chunk
ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC_STEPS = 8, 128, 32
VLM_TEXT, PREFIX_STEPS = 768, 3
FAMILY_PROMPTS = {"llama4-scout-17b-a16e": (1024, 9216)}

class FamilyTrain(NamedTuple):
    """One phase-5b train (see FAMILY_TRAINS)."""

    name: str
    layers: Optional[int]  # the first layers on the card; None: all
    grad_sync: str
    remat: str
    seq: int
    gate_layers: int
    per_step: dict  # the launches each kernel must make a step
    f32_cap: float  # the cap of the gate's bf16 kernel run's distance from f32


# Phase 5b, the other families' trains, each at full width, bf16, B=4,
# FAMILY_TRAIN_STEPS steps on one fixed batch from seed 0.  A step launches
# the SSD kernel once an SSM layer (38 for zamba2), flash once a
# self-attention layer (zamba2's shared block at layers 0, 6, ..., 36: 7;
# whisper's 32 encoder and 32 decoder layers: 64; none for MLA) and the
# grouped matmul three times a MoE layer, all in the forward (the
# backwards are PyTorch ops; under remat="full" a recompute would launch
# again, but minicpm3, the one remat train, has no kernel).  A train state
# takes 12 B a parameter (bf16 weights and gradients, f32 AdamW moments),
# int8_ef 8 B more (the f32 EF tree and compressed gradients); the cuts
# (PERF.md, section 4):
# - deepseek-moe-16b on 4 of 28 layers, 2.77 B parameters, ~33 GB, default
#   grad sync (EF would add ~22 GB);
# - minicpm3-4b at all 62 layers, 4.07 B, 48.9 GB, default grad sync
#   (int8_ef would add 32.6 GB), remat="full": MLA's plain (B, H, S, S) f32
#   scores are 671 MB a layer, kept with their softmax over 62 layers they
#   pass 80 GB; under "full" a layer's input (21 MB) is kept;
# - whisper-large-v3 at all 32 + 32 layers, 1.60 B, int8_ef (32 GB), at
#   S=448, Whisper's published decoder context, over 1500 frames: the plain
#   cross-attention keeps B*H*S*1500 f32 scores and probabilities, 215 MB
#   each a layer;
# - internvl2-76b on 2 of 80 layers, 3.81 B (2.10 B of them embeddings),
#   45.8 GB, a 256-token prefix before 1024 tokens of text;
# - llama4-scout-17b-a16e on 1 of 48 layers (layer 0, chunked; at S=1024 <
#   8192 a chunked and a global layer apply the same mask), 4.27 B, 51.2
#   GB; two layers would take 77.6 GB before activations.
# The gate runs each model's first gate_layers layers (zamba2's shared
# block fires at layer 0; whisper's encoder cut alike), TRAIN_GATE_LAYERS
# or, where 18 B a parameter would not fit beside the activations,
# internvl2's and llama4's 1: the f32 kernel run against the f32 plain run
# within FAMILY_F32_TOL of max |grad| and of the loss (the SSD and
# grouped-matmul contracts' own 1e-4), and the bf16 runs against the f32
# plain run, the kernel run no farther than the plain run by more than
# F32_MARGIN and under the model's cap: about twice the plain run's
# distance as read on an H100 80GB HBM3 at 700 W (PERF.md): 0.287% of max
# |grad| for mamba2, 0.513% for zamba2, 1.09% for deepseek, 0.243% for
# minicpm3, 0.424% for whisper, 0.438% for internvl2 and 0.584% for llama4
# (the kernel runs read 0.340%, 0.518%, 0.955%, 0.243%, 0.424%, 0.500% and
# 0.574%).
FAMILY_TRAIN_STEPS = 8
FAMILY_F32_TOL = 1e-4
FAMILY_TRAINS = [
    FamilyTrain("mamba2-130m", None, "int8_ef", "none", TRAIN_S, TRAIN_GATE_LAYERS,
                dict(NO_LAUNCH, ssd_chunk_kernel=24), 6e-3),
    FamilyTrain("zamba2-1.2b", None, "int8_ef", "none", TRAIN_S, TRAIN_GATE_LAYERS,
                dict(NO_LAUNCH, ssd_chunk_kernel=38, flash_attention=7), 1.0e-2),
    FamilyTrain("deepseek-moe-16b", 4, "auto", "none", TRAIN_S, TRAIN_GATE_LAYERS,
                dict(NO_LAUNCH, flash_attention=4, grouped_matmul=12), 2.2e-2),
    FamilyTrain("minicpm3-4b", None, "auto", "full", TRAIN_S, TRAIN_GATE_LAYERS, NO_LAUNCH, 5e-3),
    FamilyTrain("whisper-large-v3", None, "int8_ef", "none", 448, TRAIN_GATE_LAYERS,
                dict(NO_LAUNCH, flash_attention=64), 9e-3),
    FamilyTrain("internvl2-76b", 2, "auto", "none", TRAIN_S, 1, dict(NO_LAUNCH, flash_attention=2), 9e-3),
    FamilyTrain("llama4-scout-17b-a16e", 1, "auto", "none", TRAIN_S, 1,
                dict(NO_LAUNCH, flash_attention=1, grouped_matmul=3), 1.2e-2),
]

# Phase 5c, restart on the card: mamba2-130m at full depth with int8_ef (a
# state of ~1.8 GB; every step launches the SSD kernel inside SSDChunkFn),
# B=4, S=1024, the SyntheticLM stream of seed 0: 3 steps and a checkpoint,
# then a resumed run to 6, then 6 steps uninterrupted.  An H100 repeats a
# run of this train bit for bit (PERF.md), so the resumed losses are held
# to the uninterrupted run's bit for bit.
RESTART_ARCH = "mamba2-130m"
RESTART_EVERY, RESTART_STEPS = 3, 6

# Phase 7, the parcelport stack on the card's machine.  (a) The reference's
# protocol gate (benchmarks/run.py's smoke parts 1, 2, 3 and 8) over the
# port's modules, on its SMOKE_PAYLOAD_SIZES.  (b) Bytes made on the card,
# kept from earlier phases as PP_PAYLOADS (no model runs again): the first
# PP_WIRE_SLICE bytes of rank 0's KIND_Q8 wire from phase 5's
# make_packer("device") and the first mamba2 RSNP hand-off snapshot of phase
# 4c's churn run (its slot prefilled through the SSD kernel), each a
# zero-copy chunk, through PP_CARRIERS; "collective" on a group that stages
# every drain through a buffer on the card.  Shared-memory slots are sized
# for the largest payload (the default 64 KiB slot holds a token batch).
# (c) lci_eprg0_2's elastic pool with real threads.  The walls are host
# walls on the card's machine.
PP_SMOKE_SIZES = (8, 600, 3_000, 12_000, 40_000)
PP_BOUNDED = dict(send_queue_depth=2, bounce_buffers=2, bounce_buffer_size=65_536)
PP_WIRE_SLICE = 64 << 20
PP_SNAPSHOT_ARCH = "mamba2-130m"
PP_CARRIERS = ("lci", "mpi", "shmem_putq", "collective")
PP_SHMEM_SLOTS = 4
PP_ELASTIC_PARCELS = 40
PP_PAYLOADS = {}  # "q8" and "rsnp", filled by train_path and fleet_run

# Phase 8, the DES over the port.  (a) DES_CARRIERS' decision traces at the
# sizes of phase 7(b)'s payloads, the DES's against a functional world's
# carrying the bytes (shared-memory slots sized as in 7(b)).  (b) The
# paper's verdicts at the sizes of tests/test_amtsim.py, Octo-Tiger at its
# defaults (8 nodes, 16 workers, 512 subgrids, 5 steps).  The numbers are
# simulated values of the paper's clusters (amtsim/costs.py), not times on
# the card.
DES_CARRIERS = ("lci", "mpi", "shmem_putq")


def _pp_delivered(got) -> list:
    return sorted(bytes(a[0]) for a in got)


def _pp_shmem_kwargs(payloads) -> dict:
    """A shared-memory world's fabric kwargs: slots sized for the largest
    payload (the default 64 KiB slot holds a token batch)."""
    from repro_torch.core.comm import ResourceLimits

    return {"limits": ResourceLimits(bounce_buffer_size=max(len(p) for p in payloads) + (1 << 20),
                                     recv_slots=PP_SHMEM_SLOTS)}


def _pp_trace(name, sizes) -> tuple:
    """benchmarks/run.py's part 8 on the port: ``name``'s engine decision
    trace over ``sizes`` sent one at a time (a drain after each), and its
    transport's message count."""
    from repro_torch.core.harness import transport_stats
    from repro_torch.core.parcelport import World
    from repro_torch.core.variants import make_parcelport_factory, max_devices

    world = World(2, make_parcelport_factory(name), devices_per_rank=max_devices(name))
    try:
        tr: list = []
        for loc in world.localities:
            loc.parcelport.engine.trace = tr
        got: list = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for s in sizes:
            world.localities[0].async_action(1, "sink", bytes([s % 251]) * s)
            world.drain(max_rounds=50_000)
        if len(got) != len(sizes):
            fail(f"phase 7 trace: {name} delivered {len(got)} of {len(sizes)}")
        return tr, transport_stats(world).messages
    finally:
        world.close()


def parcelport_gate() -> dict:
    """Phase 7(a): every variant delivers the smoke payloads bit for bit,
    quiesces and closes; a bounded lci world and a bounded collective one
    backpressure and deliver; lci_eager uses fewer messages than
    lci_noeager; the collective decision trace equals sendrecv_queue's.
    Returns the message counts by variant."""
    from repro_torch.core.harness import deliver_payloads, transport_stats
    from repro_torch.core.comm import ResourceLimits
    from repro_torch.core.variants import variant_names

    smoke = [bytes([s % 251]) * s for s in PP_SMOKE_SIZES]

    def run(name, fabric_kwargs=None):
        try:
            world, got = deliver_payloads(name, smoke, fabric_kwargs=fabric_kwargs, max_rounds=50_000)
        except Exception as exc:  # noqa: BLE001 - a drain that cannot quiesce raises
            fail(f"phase 7: {name} did not deliver and quiesce: {exc!r}")
        try:
            pps = [loc.parcelport for loc in world.localities]
            quiet = not any(pp.pending_work() or pp.retry_queue_depth() for pp in pps)
            st = transport_stats(world)
            out = dict(messages=st.messages, eager=st.eager_msgs, rendezvous=st.rendezvous_msgs,
                       backpressure=st.backpressure_events, bytes=st.bytes)
        finally:
            world.close()
        if _pp_delivered(got) != sorted(smoke) or not quiet:
            fail(f"phase 7: {name} delivered {len(got)} of {len(smoke)} (bit for bit: "
                 f"{_pp_delivered(got) == sorted(smoke)}), quiesced: {quiet}")
        return out

    t0 = time.monotonic()
    counts = {}
    for name in variant_names():
        counts[name] = run(name)
        c = counts[name]
        print(f"parcelport {name}: messages={c['messages']} eager={c['eager']} rendezvous={c['rendezvous']} "
              f"backpressure={c['backpressure']} bytes={c['bytes']}")
    bounded = run("lci", fabric_kwargs=dict(PP_BOUNDED))
    bounded_coll = run("collective", fabric_kwargs={"limits": ResourceLimits(**PP_BOUNDED)})
    if not (bounded["backpressure"] > 0 and bounded_coll["backpressure"] > 0):
        fail(f"phase 7: bounded worlds produced no backpressure (lci {bounded['backpressure']}, "
             f"collective {bounded_coll['backpressure']})")
    if not counts["lci_eager"]["messages"] < counts["lci_noeager"]["messages"]:
        fail(f"phase 7: eager used {counts['lci_eager']['messages']} messages, "
             f"noeager {counts['lci_noeager']['messages']}")
    (tr_c, m_c), (tr_s, m_s) = _pp_trace("collective", PP_SMOKE_SIZES), _pp_trace("sendrecv_queue", PP_SMOKE_SIZES)
    if tr_c != tr_s or m_c != m_s:
        fail(f"phase 7: the collective decision trace ({len(tr_c)} decisions, {m_c} messages) differs from "
             f"sendrecv_queue's ({len(tr_s)}, {m_s})")
    print(f"phase 7(a): {len(counts)} variants delivered bit for bit and quiesced; bounded lci "
          f"{bounded['backpressure']} and collective {bounded_coll['backpressure']} backpressure events; "
          f"eager {counts['lci_eager']['messages']} < noeager {counts['lci_noeager']['messages']} messages; "
          f"collective == sendrecv_queue trace ({len(tr_c)} decisions, {m_c} messages); "
          f"host wall {time.monotonic() - t0} s")
    return counts


def parcelport_carry(payloads, device) -> dict:
    """Phase 7(b): ``payloads`` (bytes made on the card) as zero-copy
    chunks through each of PP_CARRIERS, one world each, from rank 0 and
    rank 1 in turn.  Every payload must arrive bit for bit; the collective
    world's group stages on ``device``: at least one staged batch, and the
    staged bytes are every message's payload (its bytes less the 8-byte
    frame a send).  Returns each carrier's counters and host wall."""
    import torch

    from repro_torch.core.comm.collective import FRAME_OVERHEAD, CollectiveParcelport, collective_group_for
    from repro_torch.core.harness import transport_stats
    from repro_torch.core.parcelport import World
    from repro_torch.core.variants import VARIANTS, make_parcelport_factory, max_devices

    total = sum(len(p) for p in payloads)
    out = {}
    for name in PP_CARRIERS:
        factory, fabric_kwargs = make_parcelport_factory(name), None
        if name == "collective":
            cfg = VARIANTS[name]

            def factory(loc, fab, cfg=cfg):  # the world's one group, staged on the card
                collective_group_for(fab, cfg.ndevices, stage="device", device=device)
                return CollectiveParcelport(loc, fab, cfg)
        elif name.startswith("shmem"):
            fabric_kwargs = _pp_shmem_kwargs(payloads)
        world = World(2, factory, devices_per_rank=max_devices(name), fabric_kwargs=fabric_kwargs)
        try:
            got: list = []
            for loc in world.localities:
                loc.register_action("sink", lambda *a, _g=got: _g.append(a))
            t0 = time.monotonic()
            for i, p in enumerate(payloads):
                world.localities[i % 2].async_action((i + 1) % 2, "sink", p)
            world.drain(max_rounds=100_000)
            wall = time.monotonic() - t0
            st = transport_stats(world)
            staged_on = getattr(getattr(world.fabric, "_collective_group", None), "device", None)
        except Exception as exc:  # noqa: BLE001 - a drain that cannot quiesce raises
            fail(f"phase 7(b): {name} did not carry the card's payloads: {exc!r}")
        finally:
            world.close()
        intact = _pp_delivered(got) == sorted(bytes(p) for p in payloads)
        out[name] = dict(messages=st.messages, eager=st.eager_msgs, rendezvous=st.rendezvous_msgs, sends=st.sends,
                         puts=st.puts, bytes=st.bytes, staged_batches=st.staged_batches, staged_bytes=st.staged_bytes,
                         wall_s=wall, mb_s=total / wall / 1e6)
        print(f"phase 7(b) {name}{f' (staged on {staged_on})' if staged_on is not None else ''}: "
              f"{len(payloads)} payloads of {[len(p) for p in payloads]} bytes arrived bit for bit: {intact}; "
              f"messages={st.messages} eager={st.eager_msgs} rendezvous={st.rendezvous_msgs} sends={st.sends} "
              f"puts={st.puts} bytes={st.bytes} staged_batches={st.staged_batches} staged_bytes={st.staged_bytes} "
              f"host wall={wall} s ({total / wall / 1e6} MB/s)")
        if not intact:
            fail(f"phase 7(b): {name} delivered {len(got)} payloads, not the sent bytes")
        if name == "collective":
            if staged_on is None or staged_on.type != torch.device(device).type:
                fail(f"phase 7(b): the collective group staged on {staged_on}, not on {device}")
            if st.staged_batches < 1 or st.staged_bytes != st.bytes - FRAME_OVERHEAD * st.sends:
                fail(f"phase 7(b): staged {st.staged_batches} batches of {st.staged_bytes} bytes; want >= 1 batch "
                     f"and bytes - {FRAME_OVERHEAD} x sends = {st.bytes - FRAME_OVERHEAD * st.sends}")
    return out


def parcelport_elastic() -> dict:
    """Phase 7(c): lci_eprg0_2 with real threads — PP_ELASTIC_PARCELS
    parcels delivered, each elastic pool within (0, 2) throughout, 0 after
    close, and the live threads (and the port's worker census) back to
    where they were."""
    import threading

    from repro_torch.core.comm.membership import live_worker_count
    from repro_torch.core.parcelport import World
    from repro_torch.core.variants import VARIANTS, make_parcelport_factory, max_devices

    name = "lci_eprg0_2"
    lo, hi = VARIANTS[name].elastic_progress
    base, census = threading.active_count(), live_worker_count()
    world = World(2, make_parcelport_factory(name), devices_per_rank=max_devices(name))
    sizes = []
    try:
        got: list = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for i in range(PP_ELASTIC_PARCELS):
            world.localities[0].async_action(1, "sink", b"x" * (64 + i))
            sizes.append([loc.parcelport._pw_pool.size() for loc in world.localities])
        world.drain(max_rounds=100_000)
        sizes.append([loc.parcelport._pw_pool.size() for loc in world.localities])
        delivered = _pp_delivered(got) == sorted(b"x" * (64 + i) for i in range(PP_ELASTIC_PARCELS))
    finally:
        world.close()
    after = [loc.parcelport._pw_pool.size() for loc in world.localities]
    threads = threading.active_count()
    in_bounds = all(lo <= n <= hi for row in sizes for n in row)
    print(f"phase 7(c) {name}: delivered {len(got)}/{PP_ELASTIC_PARCELS} bit for bit: {delivered}; pool sizes seen "
          f"{sorted({n for row in sizes for n in row})} within ({lo}, {hi}): {in_bounds}; after close {after}; "
          f"threads {base} -> {threads}; worker census {census} -> {live_worker_count()}")
    if not (delivered and in_bounds and after == [0, 0] and threads <= base + 1 and live_worker_count() == census):
        fail(f"phase 7(c): {name} delivered {delivered}, pool in bounds {in_bounds}, after close {after}, "
             f"threads {base} -> {threads}")
    return {"pool_sizes": sorted({n for row in sizes for n in row}), "threads": (base, threads)}


def parcelport_path(kernels, payloads, device) -> dict:
    """Phase 7: parts (a), (b) and (c) with every kernel's count set to 0
    just before and read just after (the stack launches none).  Returns
    the launches."""
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    parcelport_gate()
    parcelport_carry(payloads, device)
    parcelport_elastic()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"phase 7: parcelport stack done in {time.monotonic() - t0} s (host wall); "
          + " ".join(f"{name}.launches={n}" for name, n in launches.items()))
    if any(launches.values()):
        fail(f"phase 7: the parcelport stack launched kernels: {launches}")
    return launches


def des_trace(name, sizes) -> list:
    """The port's DES decision trace of ``name`` over ``sizes``, chained
    sequentially (each send spawned by the previous delivery)."""
    from repro_torch.amtsim.parcelport_sim import SimWorld, Task, sim_config_for_variant

    world = SimWorld(2, 4, sim_config_for_variant(name))
    tr: list = []
    world.engine.trace = tr
    state = {"i": 0}

    def send_next() -> None:
        if state["i"] >= len(sizes):
            world.stop()
            return
        op = world.make_parcel(0, 1, sizes[state["i"]], on_delivered=send_next)
        state["i"] += 1
        world.spawn(0, Task(action=lambda w, _op=op: world.send_parcel(w, _op)))

    send_next()
    world.run(until=5.0)
    if not (world.stopped and state["i"] == len(sizes)):
        fail(f"phase 8(a): the DES {name} delivered {state['i']} of {len(sizes)} sends")
    return tr


def functional_trace(name, payloads) -> list:
    """The functional stack's decision trace of ``name`` carrying
    ``payloads`` from rank 0 to rank 1, one at a time with a drain after
    each, none of them a zero-copy chunk; every payload must arrive bit
    for bit."""
    from repro_torch.core.parcelport import World
    from repro_torch.core.variants import make_parcelport_factory, max_devices

    fabric_kwargs = _pp_shmem_kwargs(payloads) if name.startswith("shmem") else None
    world = World(2, make_parcelport_factory(name), devices_per_rank=max_devices(name), fabric_kwargs=fabric_kwargs)
    try:
        tr: list = []
        for loc in world.localities:
            loc.parcelport.engine.trace = tr
        got: list = []
        world.localities[1].register_action("sink", lambda *a: got.append(a))
        for p in payloads:
            world.localities[0].async_action(1, "sink", p, zero_copy_threshold=1 << 30)
            world.drain(max_rounds=100_000)
    finally:
        world.close()
    if _pp_delivered(got) != sorted(bytes(p) for p in payloads):
        fail(f"phase 8(a): the functional {name} world delivered {len(got)} payloads, not the sent bytes")
    return tr


def des_agreement(payloads) -> dict:
    """Phase 8(a): for each of DES_CARRIERS the DES trace at the payloads'
    sizes equals the functional world's carrying them.  Returns the
    traces' lengths."""
    sizes = [len(p) for p in payloads]
    out = {}
    for name in DES_CARRIERS:
        des, fun = des_trace(name, sizes), functional_trace(name, payloads)
        paths = [e[1] for e in des if e[0] in ("send", "header")]
        print(f"phase 8(a) {name} at {sizes} bytes: DES trace {len(des)} decisions, functional {len(fun)}; "
              f"protocol paths (send, header) {paths}; equal: {des == fun}")
        if des != fun:
            fail(f"phase 8(a): {name}: the DES trace {des} differs from the functional stack's {fun}")
        out[name] = len(des)
    return out


def check_des_verdicts(r: dict) -> None:
    """The paper's verdicts on phase 8(b)'s numbers; fails on any that
    flips."""
    small, large = r["flood_8"], r["flood_16k"]
    gain_small, gain_large = small["mpi_a"] / small["mpi"], large["mpi_a"] / large["mpi"]
    lad, octo = r["ladder"], r["octotiger"]
    verdicts = {
        "flood 8 B: lci > mpi_a > mpi": small["lci"] > small["mpi_a"] > small["mpi"],
        "aggregation's 16 KiB gain < half its 8 B gain": gain_large < 0.5 * gain_small,
        "chains latency: lci < mpi": r["chains"]["lci"] < r["chains"]["mpi"],
        "flood: lci >= try_progress >= block": lad["lci"] >= lad["try_progress"] >= lad["block"],
        "devices: lci_d4 > 1.5 x lci_d1": r["devices"]["lci_d4"] > 1.5 * r["devices"]["lci_d1"],
        "Octo-Tiger: lci < mpi": octo["lci"] < octo["mpi"],
        "flood lci: delta < expanse": r["platforms"]["delta"] < r["platforms"]["expanse"],
    }
    flipped = [k for k, ok in verdicts.items() if not ok]
    print(f"phase 8(b): {len(verdicts) - len(flipped)} of {len(verdicts)} of the paper's verdicts hold"
          + (f"; flipped: {flipped}" if flipped else ""))
    if flipped:
        fail(f"phase 8(b): the paper's verdicts flipped over the port's DES: {flipped}")


def des_verdicts() -> dict:
    """Phase 8(b): the DES runs behind the paper's verdicts, their
    simulated numbers printed, then ``check_des_verdicts``.  Returns the
    numbers."""
    from repro_torch.amtsim.costs import DELTA, EXPANSE
    from repro_torch.amtsim.workloads import chains, flood, octotiger

    r = {
        "flood_8": {v: flood(v, msg_size=8, nthreads=32, nmsgs=2000).rate for v in ("lci", "mpi", "mpi_a")},
        "flood_16k": {v: flood(v, msg_size=16384, nthreads=32, nmsgs=1000).rate for v in ("lci", "mpi", "mpi_a")},
        "chains": {v: chains(v, msg_size=8, nchains=8, nsteps=20, nthreads=8).elapsed for v in ("lci", "mpi")},
        "ladder": {v: flood(v, msg_size=8, nthreads=32, nmsgs=1500).rate for v in ("block", "try_progress", "lci")},
        "devices": {v: flood(v, msg_size=8, nthreads=32, nmsgs=2000).rate for v in ("lci_d1", "lci_d4")},
        "octotiger": {v: octotiger(v).elapsed for v in ("lci", "mpi")},
        "platforms": {p.name: flood("lci", msg_size=8, nthreads=32, nmsgs=1500, platform=p).rate
                      for p in (EXPANSE, DELTA)},
    }
    sim = f"simulated, {EXPANSE.name} model"
    print(f"phase 8(b) flood 8 B, 32 threads ({sim}): {r['flood_8']} parcels/s; "
          f"lci/mpi {r['flood_8']['lci'] / r['flood_8']['mpi']}")
    print(f"phase 8(b) flood 16 KiB, 32 threads ({sim}): {r['flood_16k']} parcels/s; "
          f"lci/mpi {r['flood_16k']['lci'] / r['flood_16k']['mpi']}")
    print(f"phase 8(b) chains 8 B, 8 chains x 20 hops ({sim}): one-way hop {r['chains']} s; "
          f"lci/mpi {r['chains']['lci'] / r['chains']['mpi']}")
    print(f"phase 8(b) multithreading ladder, flood 8 B ({sim}): {r['ladder']} parcels/s")
    print(f"phase 8(b) devices, flood 8 B ({sim}): {r['devices']} parcels/s; "
          f"lci_d4/lci_d1 {r['devices']['lci_d4'] / r['devices']['lci_d1']}")
    print(f"phase 8(b) Octo-Tiger, 8 nodes x 16 workers, 512 subgrids, 5 steps ({sim}): {r['octotiger']} s; "
          f"lci/mpi {r['octotiger']['lci'] / r['octotiger']['mpi']}")
    print(f"phase 8(b) flood lci 8 B (simulated, {EXPANSE.name} and {DELTA.name} models): "
          f"{r['platforms']} parcels/s; {DELTA.name}/{EXPANSE.name} "
          f"{r['platforms'][DELTA.name] / r['platforms'][EXPANSE.name]}")
    check_des_verdicts(r)
    return r


def des_path(kernels, payloads) -> dict:
    """Phase 8: parts (a) and (b) with every kernel's count set to 0 just
    before and read just after (the DES launches none).  Returns the
    launches."""
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    des_agreement(payloads)
    des_verdicts()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"phase 8: the DES done in {time.monotonic() - t0} s (host wall); "
          + " ".join(f"{name}.launches={n}" for name, n in launches.items()))
    if any(launches.values()):
        fail(f"phase 8: the DES launched kernels: {launches}")
    return launches


# Phase 6's device times come from a process of their own (device_times):
# in the smoke's own process, after the earlier phases, every profiler
# session of the flash kernel at SLICE_CASE recorded 14 (and, with the
# profiler's warm-up step, 17) of its 20 launches, six sessions in a row,
# where a fresh process records all 20 (PERF.md).
DEVICE_TIMES_ARG = "--device-times"
DEVICE_TIMES_TIMEOUT_S = 600


def flash_timed():
    return [SLICE_CASE, DEEPSEEK_CASES[0], TRAIN_FLASH_CASE, WHISPER_ENC_CASE, INTERNVL2_CASE, LLAMA4_CHUNK_CASE]


def gmm_timed():
    return [GMM_PREFILL_UP, GMM_PREFILL_DOWN, GMM_DECODE, LLAMA4_GMM_UP, LLAMA4_GMM_DOWN, LLAMA4_GMM_DECODE]


def device_times() -> dict:
    """Phase 6: the profiler's device time a call (:func:`device_ms`) of
    the kernel and of its library call at every timed case, from a fresh
    process of this script (DEVICE_TIMES_ARG) on inputs drawn from seed 0;
    returns {repr(case): {"kernel": ms[, "library": ms]}}."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), DEVICE_TIMES_ARG], capture_output=True,
                       text=True, timeout=DEVICE_TIMES_TIMEOUT_S, cwd=str(ROOT))
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"phase 6 timing process: {line}")
    if r.returncode or not lines:
        fail(f"phase 6: the device-time process exited {r.returncode}: {r.stderr[-3000:]}")
    return json.loads(lines[-1])


def device_times_main() -> int:
    """The process of :func:`device_times`: prints the readings as one JSON
    line."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_matmul
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["flash_attention", "ssd_scan", "moe_gmm"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for case in flash_timed():
        kw = dict(zip(("causal", "window", "chunk"), case[5:8]))
        q, k, v = attention_inputs(case, gen)
        bound = attention_bound_ms(case)[0]
        out[repr(case)] = {"kernel": device_ms(lambda: flash_attention(q, k, v, **kw), bound_ms=bound),
                           "library": device_ms(sdpa_yardstick(case, q, k, v), bound_ms=bound)}
        del q, k, v
    for case in (SSD_MAMBA2, SSD_ZAMBA2):
        a, x, b, c = ssd_inputs(case, gen)
        out[repr(case)] = {"kernel": device_ms(lambda: ssd_chunk_kernel(a, x, b, c), bound_ms=ssd_bound_ms(case)[0])}
    for case in gmm_timed():
        x, w = gmm_inputs(case, gen)
        bound = gmm_bound_ms(case)[0]
        out[repr(case)] = {"kernel": device_ms(lambda: grouped_matmul(x, w), bound_ms=bound),
                           "library": device_ms(lambda: torch.bmm(x, w), bound_ms=bound)}
        del x, w
    print(json.dumps(out))
    return 0


# Phase 9: the port's sharding on the card.  (a) tinyllama's train step
# with its state and batch placed as DTensors on a 1×1 ("data", "model")
# mesh over a one-rank NCCL group: the same local ops as the unsharded step
# (DTensor adds no op on one device: a CPU rehearsal of the smoke config on
# a one-rank gloo mesh matched bit for bit), so the gate is bit for bit,
# loss and every state leaf; then the seq_act forward of qwen2 and minicpm3
# (first SEQ_ACT_LAYERS layers, full width, f32) against the default one.
# (b) the dry-run (host work, in subprocesses beside (a)): every cell of
# every model on both production meshes and on the one-card view (1×1);
# (c) the meta prediction against the card: bytes exactly, the matrix
# products no kernel replaces exactly.
SHARD_STEPS = 2
SEQ_ACT_ARCHS = ("qwen2-7b", "minicpm3-4b")
SEQ_ACT_LAYERS = 2
SEQ_ACT_B, SEQ_ACT_S = 1, 1024
# the reference test's 2e-4 (tests/test_integration.py), made relative to
# max |logit| for full width
SEQ_ACT_REL_TOL = 2e-4
DRYRUN_TIMEOUT_S = 540
SERVE_SLOTS, SERVE_CONTEXT, SERVE_PROMPT = 8, 2048, 1024  # phase 4's server: 8 slots of 2048, prompts up to 1024
# Phase 9(a), the other families on the same 1×1 mesh: the sharded train
# step of each SHARDED_TRAINS model at its phase-5b width, layers, B, S and
# remat (the default grad sync), SHARD_STEPS steps, against the same steps
# unsharded, kept on the host so that two states never sit on the card
# together (deepseek's 4 layers take ~28 GB of state and peak at ~45 GiB);
# then a prefill of SERVE_SLOTS prompts of SERVE_PROMPT tokens and
# SHARD_DECODE_STEPS greedy decode steps (one decode tile) of each
# SHARDED_SERVES model under the serving rules (seq_kv on "model", the
# cache placed by cache_specs), against the same unsharded.  Every gate is
# bit for bit, launches included.
SHARDED_TRAINS = ("mamba2-130m", "zamba2-1.2b", "deepseek-moe-16b")
SHARDED_SERVES = (("deepseek-moe-16b", 4, dict(NO_LAUNCH, flash_attention=4, grouped_matmul=12),
                   dict(NO_LAUNCH, grouped_matmul=12)),
                  ("zamba2-1.2b", None, dict(NO_LAUNCH, flash_attention=7, ssd_chunk_kernel=38), NO_LAUNCH))
SHARD_DECODE_STEPS = 3


def _tree_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _one_rank_nccl(tmp):
    """A default NCCL group of world 1 over a ``file://`` store in ``tmp``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)


def sharded_train(kernels) -> tuple:
    """Phase 9(a): TRAIN_ARCH at full width, bf16, B=TRAIN_B, S=TRAIN_S,
    SHARD_STEPS steps from phase 5's initial parameters (seed 0) under the
    default ``TrainConfig()`` (remat "dots"), once unsharded and once with
    the state placed by ``param_specs``/``opt_specs(zero=True)`` and the
    batch by ``batch_specs`` on the 1×1 mesh, under ``make_rules``.  Gates:
    the losses and every state leaf's local tensor bit for bit; the flash
    kernel launching as often in the sharded steps as in the unsharded
    ones, and at least once a layer a step.  Then the seq_act forwards.
    Every count is set to 0 just before the sharded steps and read just
    after them; the unsharded steps, run to compare, are counted apart.
    Then the other families' sharded steps and serving
    (:func:`sharded_family_train`, :func:`sharded_serve`).  Returns (the
    sharded runs' launches by path, the unsharded step's readings for
    9(c))."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.optim import OptHParams
    from repro_torch.roofline import count_ops
    from repro_torch.sharding import PartitionSpec, use_rules
    from repro_torch.sharding.params import batch_specs, distribute_tree, opt_specs, param_specs
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.checkpoint.manager import _flatten

    arch = get_config(TRAIN_ARCH)
    tcfg = TrainConfig()
    step_fn = make_train_step(arch, OptHParams(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL), tcfg)
    batch = train_batch(arch, 0)
    flash = kernels["flash_attention"]
    with tempfile.TemporaryDirectory() as tmp:
        _one_rank_nccl(tmp)
        try:
            plain = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
            state_bytes = _tree_bytes(plain)
            plain_losses, plain_flash, readings = [], 0, {"state_bytes": state_bytes}
            for i in range(SHARD_STEPS):
                f0 = flash.launches
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if i == 0:  # 9(c): the step's matrix products and peak, counted on the card
                    with count_ops() as counted:
                        plain, met = step_fn(plain, batch)
                    readings["train_mm_flops"] = _mm_flops(counted)
                else:
                    plain, met = step_fn(plain, batch)
                plain_losses.append(met["loss"].clone())
                torch.cuda.synchronize()
                readings.setdefault("train_peak", torch.cuda.max_memory_allocated())
                plain_flash += flash.launches - f0
            mesh = make_test_mesh((1, 1), ("data", "model"))
            rules = make_rules(mesh)
            with use_rules(rules):
                state = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
                spec = {"params": param_specs(state["params"], rules),
                        "opt": opt_specs(state["opt"], state["params"], rules, zero=True, mesh=mesh),
                        "step": PartitionSpec()}
                state = distribute_tree(state, mesh, spec)
                placed = distribute_tree(batch, mesh, batch_specs(batch, rules))
                for fn in kernels.values():
                    fn.launches = 0
                losses, walls = [], []
                for i in range(SHARD_STEPS):
                    t0 = time.monotonic()
                    state, met = step_fn(state, placed)
                    losses.append(met["loss"].clone())
                    torch.cuda.synchronize()
                    walls.append(time.monotonic() - t0)
                launches = {name: fn.launches for name, fn in kernels.items()}
                differ = [k for (k, a), (_, b) in zip(_flatten(state), _flatten(plain)) if not torch.equal(a.to_local(), b)]
                kinds = {type(t).__name__ for _, t in _flatten(state)}
            same_loss = all(torch.equal(a, b) for a, b in zip(losses, plain_losses))
            print(f"phase 9(a) {TRAIN_ARCH} sharded train on a 1x1 mesh (NCCL, world 1), B={TRAIN_B} S={TRAIN_S} "
                  f"remat={tcfg.remat}, {SHARD_STEPS} steps: losses {[float(x) for x in losses]} vs unsharded "
                  f"{[float(x) for x in plain_losses]}, bit for bit: {same_loss}; state leaves {kinds}, "
                  f"{len(differ)} of {len(_flatten(state))} differing from the unsharded step's {differ[:5]}; "
                  f"flash launches sharded {launches['flash_attention']} unsharded {plain_flash}; walls {walls} s")
            if not same_loss or differ or kinds != {"DTensor"}:
                fail(f"phase 9(a): the sharded step is not the unsharded step bit for bit (loss {same_loss}, leaves {differ[:5]}, {kinds})")
            if launches["flash_attention"] != plain_flash or plain_flash < arch.n_layers * SHARD_STEPS:
                fail(f"phase 9(a): flash launched {launches['flash_attention']} times sharded, {plain_flash} unsharded, "
                     f"want equal and at least {arch.n_layers * SHARD_STEPS}")
            if any(n for name, n in launches.items() if name != "flash_attention"):
                fail(f"phase 9(a): kernels other than flash launched on the dense train: {launches}")
            del state, plain, placed
            torch.cuda.empty_cache()
            paths = {f"{TRAIN_ARCH} sharded train": launches}
            for ft in FAMILY_TRAINS:
                if ft.name in SHARDED_TRAINS:
                    paths[f"{ft.name} sharded train"] = sharded_family_train(kernels, mesh, ft)
            for name, layers, per_prefill, per_step in SHARDED_SERVES:
                paths[f"{name} sharded serve"] = sharded_serve(kernels, mesh, name, layers, per_prefill, per_step)
            seq_act_forward(mesh)
        finally:
            dist.destroy_process_group()
    return paths, readings


def seq_act_forward(mesh) -> None:
    """Phase 9(a): the first SEQ_ACT_LAYERS layers of each SEQ_ACT_ARCHS
    model at full width in f32, B=SEQ_ACT_B, S=SEQ_ACT_S: the forward under
    rules with ``seq_act="model"`` (heads and kv heads replicated: the
    reference's sequence-parallel einsums) against the default forward
    (flash on the card for qwen2; MLA's einsums for minicpm3), within
    SEQ_ACT_REL_TOL of max |logit|."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models import forward_train, init_params
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.params import batch_specs, distribute_tree, param_specs

    for name in SEQ_ACT_ARCHS:
        arch = get_config(name).variant(n_layers=SEQ_ACT_LAYERS, dtype="float32")
        params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
        toks = torch.randint(0, arch.vocab_size, (SEQ_ACT_B, SEQ_ACT_S), generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks.cuda()}
        with torch.no_grad():
            ref, _ = forward_train(params, arch, batch)
            rules = make_rules(mesh, overrides={"seq_act": "model", "heads": None, "kv_heads": None})
            with use_rules(rules):
                sp, _ = forward_train(distribute_tree(params, mesh, param_specs(params, rules)), arch,
                                      distribute_tree(batch, mesh, batch_specs(batch, rules)))
            sp = sp.full_tensor()
        rel = float((sp - ref).abs().max() / ref.abs().max())
        print(f"phase 9(a) seq_act forward {name} ({SEQ_ACT_LAYERS} layers, full width, f32, B={SEQ_ACT_B} "
              f"S={SEQ_ACT_S}): max |seq_act - default| = {rel} of max |logit| {float(ref.abs().max())} "
              f"(tol {SEQ_ACT_REL_TOL}); finite {bool(torch.isfinite(sp).all())}")
        if not (rel <= SEQ_ACT_REL_TOL and torch.isfinite(sp).all()):
            fail(f"phase 9(a): the seq_act forward of {name} disagrees with the default forward: {rel}")
        del params, ref, sp
        torch.cuda.empty_cache()


def _as_local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def sharded_family_train(kernels, mesh, ft) -> dict:
    """Phase 9(a): ``ft``'s model (a FamilyTrain) SHARD_STEPS steps
    unsharded, its final state copied to the host, then the same steps with
    the state and batch placed on ``mesh`` under ``make_rules``.  Gates:
    losses and every state leaf bit for bit, every kernel launching as
    often sharded as unsharded and ``ft.per_step`` times a step.  Every
    count is set to 0 just before each run and read just after it; returns
    the sharded run's."""
    import torch

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_rules
    from repro_torch.optim import OptHParams
    from repro_torch.sharding import PartitionSpec, use_rules
    from repro_torch.sharding.params import batch_specs, distribute_tree, opt_specs, param_specs
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    arch = get_config(ft.name)
    if ft.layers is not None:
        arch = arch.variant(n_layers=ft.layers)
    tcfg = TrainConfig(microbatches=1, remat=ft.remat)
    step_fn = make_train_step(arch, OptHParams(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL), tcfg)
    batch = train_batch(arch, 0, ft.seq)

    def steps(state, batch):
        for fn in kernels.values():
            fn.launches = 0
        losses, t0 = [], time.monotonic()
        for _ in range(SHARD_STEPS):
            state, met = step_fn(state, batch)
            losses.append(_as_local(met["loss"]).clone())
        torch.cuda.synchronize()
        return state, losses, {k: fn.launches for k, fn in kernels.items()}, time.monotonic() - t0

    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
    state, plain_losses, plain_launches, plain_wall = steps(state, batch)
    host = {k: t.cpu() for k, t in _flatten(state)}
    del state
    torch.cuda.empty_cache()
    rules = make_rules(mesh)
    with use_rules(rules):
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
        spec = {"params": param_specs(state["params"], rules),
                "opt": opt_specs(state["opt"], state["params"], rules, zero=True, mesh=mesh), "step": PartitionSpec()}
        state = distribute_tree(state, mesh, spec)
        placed = distribute_tree(batch, mesh, batch_specs(batch, rules))
        state, losses, launches, wall = steps(state, placed)
    differ = [k for k, t in _flatten(state) if not torch.equal(_as_local(t).cpu(), host[k])]
    kinds = {type(t).__name__ for _, t in _flatten(state)}
    same_loss = all(torch.equal(a, b) for a, b in zip(losses, plain_losses))
    want = {k: n * SHARD_STEPS for k, n in ft.per_step.items()}
    print(f"phase 9(a) {ft.name} sharded train on a 1x1 mesh (NCCL, world 1), {arch.n_layers} layers B={TRAIN_B} "
          f"S={ft.seq} remat={ft.remat}, {SHARD_STEPS} steps: losses {[float(x) for x in losses]} vs unsharded "
          f"{[float(x) for x in plain_losses]}, bit for bit: {same_loss}; state leaves {kinds}, {len(differ)} of "
          f"{len(host)} differing from the unsharded steps' {differ[:5]}; launches sharded {launches} unsharded "
          f"{plain_launches}; walls sharded {wall} s unsharded {plain_wall} s")
    if not same_loss or differ or kinds != {"DTensor"}:
        fail(f"phase 9(a): {ft.name}'s sharded step is not the unsharded step bit for bit "
             f"(loss {same_loss}, leaves {differ[:5]}, {kinds})")
    if launches != plain_launches or launches != want:
        fail(f"phase 9(a): {ft.name} launched {launches} sharded, {plain_launches} unsharded, want {want}")
    del state, placed, host
    torch.cuda.empty_cache()
    return launches


def sharded_serve(kernels, mesh, name, layers, per_prefill, per_step) -> dict:
    """Phase 9(a): ``name`` (its first ``layers`` layers, or all) at full
    width, bf16, seed 0: a prefill of SERVE_SLOTS random prompts of
    SERVE_PROMPT tokens and SHARD_DECODE_STEPS greedy decode steps, once
    unsharded and once with the weights, prompts and cache (SERVE_CONTEXT
    slots) placed on ``mesh`` under the serving rules.  Gates: every
    logit bit for bit, the greedy tokens equal, and the kernels launching
    ``per_prefill`` times a prefill and ``per_step`` times a step in both
    runs.  Counts as in :func:`sharded_family_train`; returns the sharded
    run's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_rules
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.params import batch_specs, cache_specs, distribute_tree, param_specs

    arch = get_config(name)
    if layers is not None:
        arch = arch.variant(n_layers=layers)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    toks = torch.randint(0, arch.vocab_size, (SERVE_SLOTS, SERVE_PROMPT), generator=torch.Generator().manual_seed(3))
    prompt = {"tokens": toks.cuda()}

    def serve(params, prompt, cache, place):
        for fn in kernels.values():
            fn.launches = 0
        logits, cache = prefill(params, arch, prompt, cache)
        out, t0 = [_as_local(logits).clone()], time.monotonic()
        for i in range(SHARD_DECODE_STEPS):
            tok = out[-1][:, -1].argmax(-1)
            step_in = place({"tokens": tok[:, None], "positions": torch.full_like(tok, SERVE_PROMPT + i)})
            logits, cache = decode_step(params, arch, step_in["tokens"], step_in["positions"], cache)
            out.append(_as_local(logits).clone())
        torch.cuda.synchronize()
        return out, {k: fn.launches for k, fn in kernels.items()}, time.monotonic() - t0

    with torch.no_grad():
        ref, plain_launches, plain_wall = serve(params, prompt, init_cache(arch, SERVE_SLOTS, SERVE_CONTEXT, "cuda"),
                                                lambda b: b)
        rules = make_rules(mesh, overrides={"seq_kv": "model"})
        with use_rules(rules):
            place = lambda b: distribute_tree(b, mesh, batch_specs(b, rules))  # noqa: E731
            cache = init_cache(arch, SERVE_SLOTS, SERVE_CONTEXT, "cuda")
            got, launches, wall = serve(distribute_tree(params, mesh, param_specs(params, rules)), place(prompt),
                                        distribute_tree(cache, mesh, cache_specs(cache, rules)), place)
    same = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    want = {k: per_prefill[k] + SHARD_DECODE_STEPS * per_step[k] for k in per_prefill}
    print(f"phase 9(a) {name} sharded serve on a 1x1 mesh, {arch.n_layers} layers, seq_kv on model: prefill of "
          f"{SERVE_SLOTS} x {SERVE_PROMPT} tokens and {SHARD_DECODE_STEPS} decode steps: logits bit for bit {same} "
          f"(max |logit| {float(ref[0].float().abs().max())}); launches sharded {launches} unsharded "
          f"{plain_launches}; decode walls sharded {wall} s unsharded {plain_wall} s")
    if not all(same):
        fail(f"phase 9(a): {name}'s sharded prefill/decode logits differ from the unsharded ones: {same}")
    if launches != plain_launches or launches != want:
        fail(f"phase 9(a): {name} served launches {launches} sharded, {plain_launches} unsharded, want {want}")
    del params, cache, got, ref
    torch.cuda.empty_cache()
    return launches


def _mm_flops(counted) -> float:
    """The FLOPs of the matrix products with no batch (projections, MLP, LM
    head: ``mm``, ``addmm``, an einsum's ``bmm`` of one); attention's
    einsums are batched over B × kv heads."""
    return counted.flat_dot_flops


def dryrun_start(tmp) -> list:
    """Phase 9(b): the dry-run subprocesses (host work), started before
    9(a) so they run beside it: the production 16×16 mesh, the 2×16×16
    one, and the one-card view (a 1×1 mesh: per-device bytes are the
    global bytes)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")  # host work: off the card
    runs = []
    for name, extra in (("16x16", []), ("2x16x16", ["--multi-pod"]), ("1x1", ["--mesh", "1x1"])):
        out = Path(tmp) / name
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out", str(out), *extra]
        runs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                                 env=env, cwd=str(ROOT))))
    return runs


def dryrun_finish(runs, total_memory: int, smi: str) -> dict:
    """Phase 9(b): waits for the dry-runs, prints a line a cell and gates:
    every applicable cell of every model ``ok`` on both production meshes
    and the 1×1 one, every other cell ``skipped`` (``long_500k`` on the
    full-attention models)."""
    from repro_torch.roofline import HW, analyze_cell

    hw = HW()
    print(f"phase 9(b) the dry-run (meta tensors on a fake mesh, host work; roofline terms on HW(): "
          f"{hw.peak_flops} FLOP/s, {hw.hbm_bw} B/s, link {hw.ici_link_bw} B/s, data-sheet figures); "
          f"fits against this card's {total_memory} bytes; card: {smi}")
    recs = {}
    for name, out, proc in runs:
        try:
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"phase 9(b): the {name} dry-run ran past {DRYRUN_TIMEOUT_S} s")
        walls = [ln for ln in log.splitlines() if ln.startswith("[")]
        print(f"phase 9(b) {name} dry-run exit {proc.returncode}:\n  " + "\n  ".join(walls))
        for p in sorted(out.glob("*.json")):
            recs[(name, p.stem)] = json.loads(p.read_text())
    for (name, tag), rec in sorted(recs.items()):
        if rec["status"] == "ok":
            mem = rec["memory"]
            need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            c = analyze_cell(rec, hw)
            print(f"  {name} {tag}: ok args={mem['argument_size_in_bytes']} temp={mem['temp_size_in_bytes']} "
                  f"fits={need <= total_memory} dot_flops={rec['dot_flops']} coll={rec['collective_bytes']} "
                  f"compute={c.compute_s} s memory={c.memory_s} s collective={c.collective_s} s dominant={c.dominant}")
        else:
            print(f"  {name} {tag}: {rec['status']} {rec.get('op')} {rec.get('error', rec.get('reason', ''))[:200]}")
    from repro_torch.configs import SHAPES, cell_is_applicable, get_config, list_archs

    tags = {"16x16": "pod1", "2x16x16": "pod2", "1x1": "1x1"}
    bad, counts = [], {"ok": 0, "skipped": 0, "error": 0}
    for mesh, tag in tags.items():
        for a in list_archs():
            for s in SHAPES:
                rec = recs.get((mesh, f"{a}__{s}__{tag}"))
                status = rec["status"] if rec else "missing"
                counts[status] = counts.get(status, 0) + 1
                want = "ok" if cell_is_applicable(get_config(a), SHAPES[s])[0] else "skipped"
                if status != want:
                    bad.append(f"{a} x {s} on {mesh}: {status} {rec and rec.get('op')} {rec and rec.get('error', '')[:160]}")
    print(f"phase 9(b) the dry-run's cells over {', '.join(tags)}: {counts}")
    if bad:
        fail(f"phase 9(b): {len(bad)} cells not as the assignment rule says (every applicable cell ok): {bad[:8]}")
    return recs


def meta_prediction(readings) -> None:
    """Phase 9(c): TRAIN_ARCH's bytes as ``launch/specs.py`` predicts them
    on meta against the tensors on the card (params; the cache of phase
    4's server, SERVE_SLOTS × SERVE_CONTEXT; the train state), exactly; the
    FLOPs of the matrix products no kernel replaces (no batch: ``_mm_flops``) over a prefill
    of SERVE_SLOTS × SERVE_PROMPT and over the train step, counted on meta
    and on the card, exactly; the meta temp peak beside the card's peak of
    the same train step (printed, not gated)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import META, abstract_cache, abstract_params, abstract_train_state
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.optim import OptHParams
    from repro_torch.roofline import count_ops
    from repro_torch.train import TrainConfig, make_train_step

    arch = get_config(TRAIN_ARCH)
    tcfg = TrainConfig()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    cache = init_cache(arch, SERVE_SLOTS, SERVE_CONTEXT, device="cuda")
    toks = torch.randint(0, arch.vocab_size, (SERVE_SLOTS, SERVE_PROMPT), generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), count_ops() as card:
        prefill(params, arch, {"tokens": toks.cuda()}, cache)
    torch.cuda.synchronize()
    m_params, m_cache = abstract_params(arch), abstract_cache(arch, SERVE_SLOTS, SERVE_CONTEXT)
    with torch.no_grad(), count_ops() as meta:
        prefill(m_params, arch, {"tokens": torch.empty_like(toks, device=META)}, m_cache)
    m_state = abstract_train_state(arch, tcfg)
    step_fn = make_train_step(arch, OptHParams(lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL), tcfg)
    m_batch = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=torch.long, device=META) for k in ("tokens", "labels")}
    with count_ops() as meta_train:
        step_fn(m_state, m_batch)
    rows = {
        "params bytes": (_tree_bytes(m_params), _tree_bytes(params)),
        "cache bytes": (_tree_bytes(m_cache), _tree_bytes(cache)),
        "train state bytes": (_tree_bytes(abstract_train_state(arch, tcfg)), readings["state_bytes"]),
        "prefill mm FLOPs": (_mm_flops(meta), _mm_flops(card)),
        "train step mm FLOPs": (_mm_flops(meta_train), readings["train_mm_flops"]),
    }
    for what, (pred, got) in rows.items():
        print(f"phase 9(c) {TRAIN_ARCH} {what}: meta {pred}, card {got}, equal {pred == got}")
    print(f"phase 9(c) {TRAIN_ARCH} train step B={TRAIN_B} S={TRAIN_S} remat={tcfg.remat}: meta temp peak "
          f"{meta_train.peak_bytes} bytes; the card's max_memory_allocated {readings['train_peak']} bytes "
          f"({readings['train_peak'] - readings['state_bytes']} above the state); ratio temp / (peak - state) "
          f"{meta_train.peak_bytes / max(1, readings['train_peak'] - readings['state_bytes'])}")
    bad = {k: v for k, v in rows.items() if v[0] != v[1] or not v[0]}
    if bad:
        fail(f"phase 9(c): the meta prediction differs from the card: {bad}")
    del params, cache
    torch.cuda.empty_cache()


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
    from repro_torch.kernels.grad_pack import quantize_pack
    from repro_torch.kernels.moe_gmm import grouped_matmul, grouped_matmul_plain
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel, ssd_chunk_plain
    from repro_torch.models import init_params
    from repro_torch.models.moe import GroupedMatmulFn
    from repro_torch.models.ssm import SSDChunkFn
    from repro_torch.tree import leaves

    # full-f32 products for the f32 comparisons, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"flash_attention": flash_attention, "ssd_chunk_kernel": ssd_chunk_kernel,
               "grouped_matmul": grouped_matmul, "quantize_pack": quantize_pack}

    # 1. the card and the build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.monotonic()
    build.build(["flash_attention", "ssd_scan", "moe_gmm", "grad_pack"])
    print(f"kernel build: {time.monotonic() - t0} s")

    # 2. every kernel against its plain version ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_attention(flash_attention, attention_plain, gen, FLASH_CASES + [SLICE_CASE, RAGGED_CASE] + ZAMBA2_CASES)
    ssd_errs = check_ssd(ssd_chunk_kernel, ssd_chunk_plain, gen)
    check_ssd_chunked_ragged(ops, ssd_chunk_plain, gen)
    gen_moe = torch.Generator(device="cuda").manual_seed(13)  # leaves gen's draws for the earlier paths as they were
    check_attention(flash_attention, attention_plain, gen_moe, DEEPSEEK_CASES)
    gmm_errs = check_gmm(grouped_matmul, grouped_matmul_plain, gen_moe,
                         GMM_CASES + [GMM_PREFILL_UP, GMM_PREFILL_DOWN, GMM_DECODE])
    gen_fam = torch.Generator(device="cuda").manual_seed(29)  # the later families' own draws
    errs.update(check_attention(flash_attention, attention_plain_blocked, gen_fam, FAMILY_FLASH_CASES))
    gmm_errs.update(check_gmm(grouped_matmul, grouped_matmul_plain, gen_fam,
                              [LLAMA4_GMM_UP, LLAMA4_GMM_DOWN, LLAMA4_GMM_DECODE]))
    check_grad_pack()

    # 3./4. each model: full-width prefill check, then serving ----------------
    by_path = {}
    grouped_matmul.copies = 0  # operands the wrapper had to copy contiguous
    for name, per_prefill, per_step, f32_cap, f32_layers in PATHS:
        arch = get_config(name)
        t0 = time.monotonic()
        params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in leaves(params))
        print(f"{name}: {n_params} params ({arch.dtype}) built in {time.monotonic() - t0} s")
        prompt = torch.randint(0, arch.vocab_size, (1, 777), generator=gen, device="cuda")
        first_tok = prefill_check(arch, params, {"tokens": prompt}, ops, f32_cap, f32_layers)
        by_path[name] = serve_path(arch, params, prompt, first_tok, kernels, per_prefill, per_step)
        del params
        torch.cuda.empty_cache()

    # 3b./4b. the later families: full-width prefill checks, then serving ------
    for name, layers, per_prefill, per_step, f32_cap in FAMILY_PATHS:
        by_path.update(family_path(name, layers, per_prefill, per_step, f32_cap, ops, kernels, gen_fam))

    # 4c. the fleet: batch invariance, then single host vs fleet vs churn ------
    for name, transport, per_prefill in FLEET_PATHS:
        by_path.update(fleet_path(name, transport, per_prefill, kernels))

    # 5. training: the gate, the train path with the DP exchange, the pack ---
    train_gate(ops)
    train_launches, grads, _ = train_path(kernels)
    want = dict(NO_LAUNCH, flash_attention=(TRAIN_STEPS + 2) * get_config(TRAIN_ARCH).n_layers, quantize_pack=2)
    if train_launches != want:
        fail(f"{TRAIN_ARCH} train path: launches {train_launches}, want {want} "
             f"({TRAIN_STEPS} steps and 2 ranks' gradients of one flash launch a layer; one pack a rank)")
    by_path[f"{TRAIN_ARCH} train"] = train_launches
    by_path[f"{TRAIN_ARCH} DP exchange (stage=device)"] = device_stage_path(grads, kernels)
    gp_ms = grad_pack_full(grads)
    del grads
    torch.cuda.empty_cache()

    # 5b. the other families' trains: the gate, then the steps -----------------
    for ft in FAMILY_TRAINS:
        family_train_gate(ops, ft)
        by_path[f"{ft.name} train"] = family_train(kernels, ft)

    # 5c. checkpoint/restart: save, resume, and the uninterrupted run --------
    by_path[f"{RESTART_ARCH} restart"] = restart_path(kernels)
    print(f"grouped_matmul copies of a non-contiguous operand on the main paths: {grouped_matmul.copies}")
    if grouped_matmul.copies:
        fail(f"the main paths handed the grouped matmul {grouped_matmul.copies} operands to copy contiguous")

    # 6. times at the main paths' shapes -------------------------------------
    dev = device_times()
    flash_ms = {SLICE_CASE: time_attention(flash_attention, attention_plain, SLICE_CASE, gen, dev[repr(SLICE_CASE)])}
    ssd_ms = {}
    for case in (SSD_MAMBA2, SSD_ZAMBA2):
        a, x, b, c = ssd_inputs(case, gen)
        t_kernel = cuda_ms(lambda: ssd_chunk_kernel(a, x, b, c))
        t_plain = cuda_ms(lambda: ssd_chunk_plain(a, x, b, c))
        t_lib = cuda_ms(ssd_yardstick(a, x, b, c))
        t_kernel2 = cuda_ms(lambda: ssd_chunk_kernel(a, x, b, c))
        sbound, sbound_by = ssd_bound_ms(case)
        d_kernel = dev[repr(case)]["kernel"]
        with torch.inference_mode():  # the host cost of the serving route: the wrapper, and SSDChunkFn around it
            h_kernel, h_fn = host_us(lambda: ssd_chunk_kernel(a, x, b, c)), host_us(lambda: SSDChunkFn.apply(a, x, b, c))
        ssd_ms[case] = (t_kernel, t_plain, t_lib, sbound, sbound_by, d_kernel, ssd_chunk_kernel.heads_per_block,
                        h_kernel, h_fn)
        print(f"ssd_chunk_kernel {case}: kernel={t_kernel} ms (again {t_kernel2} ms) device={d_kernel} ms "
              f"({sbound / d_kernel} of the bound, {ssd_chunk_kernel.heads_per_block} heads a block) "
              f"plain={t_plain} ms einsum_chain (model plain branch)={t_lib} ms bound={sbound} ms ({sbound_by}); "
              f"host a call under inference_mode: wrapper {h_kernel} us, SSDChunkFn {h_fn} us")

    # deepseek's attention (D=128) at S=1024, then the train step's
    flash_ms[DEEPSEEK_CASES[0]] = time_attention(flash_attention, attention_plain, DEEPSEEK_CASES[0], gen_moe,
                                                 dev[repr(DEEPSEEK_CASES[0])])
    flash_ms[TRAIN_FLASH_CASE] = time_attention(flash_attention, attention_plain, TRAIN_FLASH_CASE, gen,
                                                dev[repr(TRAIN_FLASH_CASE)])
    for case in (WHISPER_ENC_CASE, INTERNVL2_CASE, LLAMA4_CHUNK_CASE):  # the later families'
        flash_ms[case] = time_attention(flash_attention, attention_plain_blocked, case, gen_fam, dev[repr(case)])
    gmm_ms = {}
    for case in gmm_timed():
        x, w = gmm_inputs(case, gen_moe if case[0] == 64 else gen_fam)
        t_kernel = cuda_ms(lambda: grouped_matmul(x, w))
        t_plain = cuda_ms(lambda: grouped_matmul_plain(x, w))
        t_lib = cuda_ms(lambda: torch.bmm(x, w))
        t_kernel2 = cuda_ms(lambda: grouped_matmul(x, w))
        gbound, gbound_by = gmm_bound_ms(case)
        d_kernel, d_lib = dev[repr(case)]["kernel"], dev[repr(case)]["library"]
        with torch.inference_mode():  # the wrapper, and GroupedMatmulFn around it (84 a deepseek decode step)
            h_kernel, h_fn = host_us(lambda: grouped_matmul(x, w)), host_us(lambda: GroupedMatmulFn.apply(x, w))
        gmm_ms[case] = (t_kernel, t_plain, t_lib, gbound, gbound_by, d_kernel, d_lib, h_kernel, h_fn)
        print(f"grouped_matmul {case}: kernel={t_kernel} ms (again {t_kernel2} ms) device={d_kernel} ms "
              f"plain={t_plain} ms torch.bmm={t_lib} ms (device {d_lib} ms) bound={gbound} ms ({gbound_by}); "
              f"host a call under inference_mode: wrapper {h_kernel} us, GroupedMatmulFn {h_fn} us")

    # 7. the parcelport stack: the protocol gate, the card's bytes, elastic ---
    from repro_torch.core.comm.wire import KIND_Q8, parse_grad_header

    if set(PP_PAYLOADS) != {"q8", "rsnp"}:
        fail(f"phase 7: phases 4c and 5 kept {sorted(PP_PAYLOADS)}, want the q8 wire slice and an RSNP snapshot")
    if parse_grad_header(PP_PAYLOADS["q8"])[0] != KIND_Q8 or PP_PAYLOADS["rsnp"][:4] != b"RSNP":
        fail("phase 7: the kept payloads are not a KIND_Q8 wire and an RSNP snapshot")
    by_path["parcelport stack"] = parcelport_path(kernels, [PP_PAYLOADS["q8"], PP_PAYLOADS["rsnp"]], "cuda")

    # 8. the DES: its traces against the stack's on the card's bytes, verdicts -
    by_path["DES"] = des_path(kernels, [PP_PAYLOADS["q8"], PP_PAYLOADS["rsnp"]])

    # 9. sharding: the sharded train step and seq_act on the card, the
    # dry-run (host subprocesses, beside 9(a)), the meta prediction --------
    import tempfile

    with tempfile.TemporaryDirectory() as dry_tmp:
        t0 = time.monotonic()
        runs = dryrun_start(dry_tmp)
        try:
            paths, readings = sharded_train(kernels)
            by_path.update(paths)
            t_a = time.monotonic() - t0
            dryrun_finish(runs, torch.cuda.get_device_properties(0).total_memory, smi)
            t_b = time.monotonic() - t0
        finally:  # a failed gate leaves no dry-run running
            for _, _, proc in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    meta_prediction(readings)
    print(f"phase 9: {time.monotonic() - t0} s (9(a) {t_a} s; the dry-runs done {t_b} s after the start)")

    # 10. the record --------------------------------------------------------------
    g_kernel, g_plain, g_lib, gbound, gbound_by, g_device, g_lib_device = gmm_ms[GMM_PREFILL_UP][:7]
    t_kernel, t_plain, t_lib, sbound, sbound_by, t_device = ssd_ms[SSD_MAMBA2][:6]
    fl = flash_ms[SLICE_CASE]
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:38",
        "launches": sum(p["flash_attention"] for p in by_path.values()),
        "launches_by_path": {n: p["flash_attention"] for n, p in by_path.items()},
        "max_abs_err": errs[SLICE_CASE],
        "ms": fl["ms"],
        "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"],
        "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
        "device_ms": fl["device_ms"],
        "library_device_ms": fl["library_device_ms"],
        "at_shapes": {f"B={c[0]} S={c[1]} H={c[2]} KV={c[3]} D={c[4]}{mask_label(c)}": flash_ms[c] for c in flash_ms},
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
        "device_ms": t_device,
        "at_shapes": {f"B={c[0]} H={c[1]} G={c[2]} nc={c[3]} Q={c[4]} P={c[5]} N={c[6]}": dict(zip(
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms", "heads_per_block", "host_us",
             "fn_host_us"), ssd_ms[c]))
            for c in ssd_ms},
        "check": "pass",
    }, {
        "name": "grouped_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:28",
        "launches": sum(p["grouped_matmul"] for p in by_path.values()),
        "launches_by_path": {n: p["grouped_matmul"] for n, p in by_path.items()},
        "max_abs_err": gmm_errs[GMM_PREFILL_UP],
        "ms": g_kernel,
        "plain_ms": g_plain,
        "bound_ms": gbound,
        "bound_by": gbound_by,
        "library_ms": g_lib,
        "device_ms": g_device,
        "library_device_ms": g_lib_device,
        "at_shapes": {f"E={c[0]} C={c[1]} D={c[2]} F={c[3]}": dict(zip(
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms", "library_device_ms", "host_us",
             "fn_host_us"), gmm_ms[c]))
            for c in gmm_ms},
        "check": "pass",
    }, {
        "name": "grad_pack",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grad_pack.cu",
        "replaces": "src/repro/kernels/grad_pack.py:84",
        "launches": sum(p["quantize_pack"] for p in by_path.values()),
        "launches_by_path": {n: p["quantize_pack"] for n, p in by_path.items()},
        "max_abs_err": gp_ms["max_abs_err"],
        "ms": gp_ms["ms"],
        "plain_ms": gp_ms["plain_ms"],
        "bound_ms": gp_ms["bound_ms"],
        "bound_by": gp_ms["bound_by"],
        "library_ms": None,
        "device_ms": gp_ms["device_ms"],
        "whole_pack_ms": gp_ms["whole_ms"],
        "check": "pass",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(device_times_main() if sys.argv[1:] == [DEVICE_TIMES_ARG] else main())
