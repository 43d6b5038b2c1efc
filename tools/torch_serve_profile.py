#!/usr/bin/env python3
"""Where the serving time goes on an NVIDIA card: the PyTorch port's
prefill and decode step of one model at full width, under
``torch.profiler``.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_serve_profile.py [--arch tinyllama-1.1b] [--out build/torch_serve_profile]

``--arch`` takes any model of ``configs/``: ``tinyllama-1.1b`` (the
default), ``mamba2-130m``, ``zamba2-1.2b``, ``deepseek-moe-16b``,
``minicpm3-4b``, ``whisper-large-v3``, ``internvl2-76b`` (cut to its
first 8 of 80 layers, as ``chip_smoke.py`` runs it) or
``llama4-scout-17b-a16e`` (cut to 4 of 48, so that layer 3 is global).

It builds the model (bf16, random weights from a fixed seed), fills an
``InferenceServer`` (8 slots, 2048-token context, collective hand-off)
with 8 requests of 512 prompt tokens, then profiles (1) one prefill of a
512-token and of a 1024-token prompt and (2) 10 engine steps of batched
decode over the 8 slots.  The encoder-decoder (``whisper-large-v3``),
which the server does not take, goes through ``prefill`` (with a stub of
its 1500 encoder frames) and ``decode_step`` directly: the decode window
is 10 steps over 8 rows prefilled with 512 tokens each.  For each window it prints the host wall time,
the summed device time of the kernels (one stream, so they do not
overlap), the number of kernels, the device busy share (device time over
wall time), the share of the port's own kernels (flash attention, the SSD
chunk scan, the grouped matmul, the gradient pack) and the kernels that took the most device time.  The profiler
adds host time to every operator, so the walls here are upper bounds;
``chip_smoke.py`` reports the serving walls without it.  Chrome traces go
to ``--out``.  Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# device-side names of the port's hand-written kernels (csrc/*.cu); the
# gradient pack is two launches
PORT_KERNELS = {"flash_attention": ("attn_fwd_kernel",), "ssd_chunk_kernel": ("ssd_chunk_kernel",),
                "grouped_matmul": ("gmm_kernel",), "quantize_pack": ("max_kernel", "quant_kernel")}
# the depth chip_smoke.py runs a model at, where the full one has no room on one card
CUT_LAYERS = {"internvl2-76b": 8, "llama4-scout-17b-a16e": 4}


def report(title: str, prof, wall_s: float, top: int = 12) -> None:
    """Host wall time, the device kernels' summed time (one stream, so they
    do not overlap), their ratio (the device busy share), each port
    kernel's share, and the kernels that took the most device time.  Only
    device-side kernel events are summed: the operators that launch them
    carry the same time again, and so do the device-side spans of
    ``record_function`` ranges (user annotations)."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    device_s = sum(r[1] for r in rows) / 1e6
    launches = sum(r[2] for r in rows)
    print(f"== {title}: wall={wall_s * 1e3} ms device={device_s * 1e3} ms kernels={launches} "
          f"busy_share={device_s / wall_s}")
    if not rows:
        print("   no device time in the profile: device busy share not measured")
        return
    for name, symbols in PORT_KERNELS.items():
        mine = [r for r in rows if any(sym in r[0] for sym in symbols)]
        us = sum(r[1] for r in mine)
        print(f"   port kernel {name}: {us / 1e3} ms x{sum(r[2] for r in mine)} "
              f"share={us / 1e6 / device_s if device_s else float('nan')}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"   {us / 1e3:10.4f} ms {us / 1e6 / device_s:7.2%} x{count:<5d} {key[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--out", default="build/torch_serve_profile")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.serve import InferenceServer, ServeConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    arch = get_config(args.arch)
    if arch.name in CUT_LAYERS:
        arch = arch.variant(n_layers=CUT_LAYERS[arch.name])
    print(f"arch={arch.name} layers={arch.n_layers}")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def batch(rows, s):
        b = {"tokens": torch.randint(0, arch.vocab_size, (rows, s), generator=gen, device="cuda")}
        if arch.is_encdec:  # the stubbed audio frontend's frames
            b["frames"] = torch.randn((rows, arch.encoder_seq, arch.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        return b

    # (1) prefill, straight through the model entry point
    for s in (512, 1024):
        b = batch(1, s)
        with torch.inference_mode():
            for _ in range(2):  # warm-up: kernel build, allocator, cuBLAS
                prefill(params, arch, b, init_cache(arch, 1, 2048))
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                logits, _ = prefill(params, arch, b, init_cache(arch, 1, 2048))
                int(torch.argmax(logits[0, -1]))
                wall = time.perf_counter() - t0
        report(f"prefill S={s}", prof, wall)
        prof.export_chrome_trace(str(out / f"torch_serve_profile_{arch.name}_prefill_{s}.json"))

    if arch.is_encdec:  # (2) the server does not take it: decode_step over 8 prefilled rows
        b = batch(8, 512)
        with torch.inference_mode():
            logits, cache = prefill(params, arch, b, init_cache(arch, 8, 2048))
            tok = torch.argmax(logits[:, -1], dim=-1)

            def step(i):
                nonlocal tok, cache
                pos = torch.full((8,), 512 + i, dtype=torch.int32, device="cuda")
                logits, cache = decode_step(params, arch, tok[:, None], pos, cache)
                tok = torch.argmax(logits[:, 0], dim=-1)
                tok.cpu()

            for i in range(3):
                step(i)
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for i in range(3, 13):
                    step(i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        report("decode, 10 decode_step calls of 8 rows", prof, wall)
        prof.export_chrome_trace(str(out / f"torch_serve_profile_{arch.name}_decode.json"))
        return 0

    # (2) batched decode of 8 slots through the server's engine step
    server = InferenceServer(arch, params, ServeConfig(slots=8, context=2048, max_prefill=1024, transport="collective"))
    prompts = torch.randint(0, arch.vocab_size, (8, 512), generator=gen, device="cuda").tolist()
    for p in prompts:
        server.submit(p, max_new=64)
    while server.core.prefill_calls < 8:
        server.step()
    for _ in range(3):
        server.step()
    torch.cuda.synchronize()
    steps0 = server.steps
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            server.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"decode, {server.steps - steps0} engine steps of 8 slots", prof, wall)
    prof.export_chrome_trace(str(out / f"torch_serve_profile_{arch.name}_decode.json"))
    server.run_until_idle()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
