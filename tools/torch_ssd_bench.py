#!/usr/bin/env python3
"""The SSD chunk-scan kernel alone on an NVIDIA card: its build report,
and its device time at the serving paths' shapes for each slice of heads
a bf16 block may take.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_ssd_bench.py

It prints the card's name and power limit; compiles
``src/repro_torch/kernels/csrc/ssd_scan.cu`` with the port's flags plus
``-Xptxas -v`` and prints what ``ptxas`` says of each kernel (registers,
spills, shared memory); then, at mamba2-130m's and zamba2-1.2b's S=1024
prefill shapes (bf16, the inputs of ``chip_smoke.py``), the device time a
launch from ``torch.profiler`` (20 launches after 3 warm-up ones) for 1,
2, 3, 4, 6 and 8 heads a block through the C entry point, and for the
wrapper's own choice, each beside the bound (bytes moved once over
3.35 TB/s).  Without a card it exits non-zero.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, H, G, nc, Q, P, N): mamba2-130m and zamba2-1.2b at S=1024
SHAPES = {"mamba2-130m": (1, 24, 1, 16, 64, 64, 128), "zamba2-1.2b": (1, 64, 1, 16, 64, 64, 64)}
SLICES = (1, 2, 3, 4, 6, 8)


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds a call, summed over the kernels it ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    if not us > 0:
        raise SystemExit("torch_ssd_bench: torch.profiler saw no device time")
    return us / 1e3 / iters


def bound_ms(shape) -> float:
    """a_dt, x, b, c read once, y and the f32 states written once."""
    from repro_torch.roofline import HW  # the card's data-sheet HBM3 rate, one copy

    bsz, h, g, nc, q, p, n = shape
    nbytes = 4 * bsz * h * nc * q + 2 * bsz * nc * q * (2 * h * p + 2 * g * n) + 4 * bsz * h * nc * p * n
    return nbytes / HW().hbm_bw * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ssd_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import DTYPES, _lib, _opt_in, _wave_slots, heads_per_block, smem_bytes
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out = ROOT / "build" / "torch_ssd_bench"
    out.mkdir(parents=True, exist_ok=True)
    ptxas = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "ssd_scan.so"),
                            str(build.CSRC / "ssd_scan.cu")], capture_output=True, text=True)
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        if any(key in line for key in ("Compiling", "registers", "spill")):
            print(line.strip())
    if ptxas.returncode != 0:
        print(ptxas.stderr, file=sys.stderr)
        return 1

    code = DTYPES[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch, shape in SHAPES.items():
        bsz, h, g, nc, q, p, n = shape
        a = -torch.randn((bsz, h, nc, q), generator=gen, device="cuda").abs() * 0.1
        x = torch.randn((bsz, h, nc, q, p), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
        c = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
        y = torch.empty((bsz, h, nc, q, p), dtype=torch.bfloat16, device="cuda")
        st = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device="cuda")
        smem = smem_bytes(q, p, n, torch.bfloat16)
        _opt_in(x.device, code, smem)
        slots = _wave_slots(x.device, code, smem)
        picked = heads_per_block(bsz * h * nc, h // g, slots)
        bound = bound_ms(shape)
        print(f"{arch} {shape}: shared memory {smem} B a block, {slots} block slots on the card, "
              f"the wrapper takes {picked} heads a block; bound {bound} ms (bytes)")

        def run(hpb):
            rc = _lib().repro_ssd_chunk_fwd(
                a.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), st.data_ptr(),
                code, bsz, h, g, nc, q, p, n, hpb, *a.stride(), *x.stride()[:4], *b.stride()[:4],
                *c.stride()[:4], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"torch_ssd_bench: launch failed (CUDA error {rc})")

        for hpb in SLICES:
            if hpb <= h // g:
                t = device_ms(lambda: run(hpb))
                blocks = bsz * nc * g * -(-(h // g) // hpb)
                print(f"  {hpb} heads a block ({blocks} blocks): device {t} ms a launch, {bound / t} of the bound")
        t = device_ms(lambda: ssd_chunk_kernel(a, x, b, c))
        print(f"  the wrapper ({picked} heads a block): device {t} ms a launch, {bound / t} of the bound")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
