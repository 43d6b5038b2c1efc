#!/usr/bin/env python3
"""How often does a ``torch.profiler`` session on an NVIDIA card record no
kernels, and does a pause before the next try get past it?

``chip_smoke.py``'s ``device_ms`` takes a device time from a profiler
session of its own (CUDA activity only, 20 calls after 3 warm-up ones),
and traces again, up to 3 sessions, when one records no kernels.  This
takes ``--measurements`` such device times in a row, alternating the
port's SSD chunk kernel (``csrc/ssd_scan.cu``, a library with a CUDA
runtime of its own: even indices) and a PyTorch matmul (odd), with up to
``--tries`` sessions each and ``--pause`` seconds of sleep after an empty
one.  It prints the card's name and power limit, then one JSON line: the
sessions opened, the empty ones, the measurements whose every try was
empty, the first 40 empty sessions as (measurement, try, seconds since
the start), the seconds taken, and the environment's ``TEARDOWN_CUPTI``
(Kineto's switch to tear CUPTI down after each session).  From the root
of a checkout on a machine with a card:

    python3 tools/torch_profiler_sessions.py                 # retries at once
    python3 tools/torch_profiler_sessions.py --pause 0.5
    TEARDOWN_CUPTI=0 python3 tools/torch_profiler_sessions.py

Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 20  # calls a session, as device_ms makes them
SSD_SHAPE = (1, 64, 1, 16, 64, 64, 64)  # (B, H, G, nc, Q, P, N): zamba2-1.2b at S=1024


def session_us(fn) -> float:
    """One profiler session as ``chip_smoke.py``'s ``device_ms`` opens it:
    the summed device time of the kernels ITERS calls ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measurements", type=int, default=3000)
    ap.add_argument("--tries", type=int, default=3)
    ap.add_argument("--pause", type=float, default=0.0, help="seconds to wait after an empty session")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_sessions: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ssd_scan import ssd_chunk_kernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    bsz, h, g, nc, q, p, n = SSD_SHAPE
    a = -torch.randn((bsz, h, nc, q), generator=gen, device="cuda").abs() * 0.1
    x = torch.randn((bsz, h, nc, q, p), generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    c = (torch.randn((bsz, g, nc, q, n), generator=gen, device="cuda") * 0.3).to(torch.bfloat16)
    m = torch.randn((1024, 1024), generator=gen, device="cuda", dtype=torch.bfloat16)
    calls = [lambda: ssd_chunk_kernel(a, x, b, c), lambda: m @ m]
    for fn in calls:  # warm-up, and the kernel's build
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    empty, failed = [], 0
    t0 = time.monotonic()
    sessions = 0
    for i in range(args.measurements):
        for attempt in range(1, args.tries + 1):
            sessions += 1
            if session_us(calls[i % len(calls)]) > 0:
                break
            empty.append((i, attempt, round(time.monotonic() - t0, 3)))
            time.sleep(args.pause)
        else:
            failed += 1
    print(json.dumps({"teardown_cupti": os.environ.get("TEARDOWN_CUPTI"), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "measurements": args.measurements, "tries": args.tries,
                      "pause_s": args.pause, "sessions": sessions, "empty": len(empty), "failed": failed,
                      "empty_at": empty[:40], "seconds": time.monotonic() - t0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
