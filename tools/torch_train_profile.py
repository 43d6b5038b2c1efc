#!/usr/bin/env python3
"""Where the training time goes on an NVIDIA card: one full-width train
step of the PyTorch port, and one device pack of its gradients, under
``torch.profiler``.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_train_profile.py [--arch tinyllama-1.1b] [--layers N] [--grad-sync int8_ef|auto]
                                         [--batch 4] [--seq 1024] [--out build/torch_train_profile]

``--arch`` takes any model the port trains: ``tinyllama-1.1b`` (the
default), ``mamba2-130m``, ``zamba2-1.2b`` or ``deepseek-moe-16b``;
``--layers`` cuts its depth (deepseek's 28 layers and their f32 moments do
not fit one card: ``--layers 4 --grad-sync auto`` is the train of
``chip_smoke.py``).  It builds the train state (bf16, random weights from
a fixed seed, ``--grad-sync``, no remat), runs two warm-up steps on one
``SyntheticLM`` batch, then profiles (1) one train step and, under
``int8_ef``, (2) one ``make_packer("device")`` pack of that state's
gradients (flatten, the kernel, the copy of the wire to the host).  For
each window it prints what ``tools/torch_serve_profile.py`` prints: host
wall, summed device time, kernel count, device busy share, each port
kernel's share and the kernels that took the most device time; for the
step also the device time of each kernel's backward (the
``autograd.Function``s' backwards, PyTorch ops, each in a
``record_function`` range) and its share of the step.  The profiler adds
host time to every operator, so the walls are upper bounds;
``chip_smoke.py`` reports the step walls without it.  Chrome traces go to
``--out``.  Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serve_profile import report  # noqa: E402


def range_backwards(functions) -> list:
    """Run each ``autograd.Function``'s backward inside a
    ``record_function`` range named after it; returns the range names."""
    import torch

    names = []
    for fn in functions:
        name = f"{fn.__name__}.backward"

        def backward(ctx, *grads, _inner=fn.backward, _name=name):
            with torch.profiler.record_function(_name):
                return _inner(ctx, *grads)

        fn.backward = staticmethod(backward)
        names.append(name)
    return names


def backward_shares(prof, ranges) -> None:
    """Device time of the kernels launched inside each backward range, and
    its share of the window's kernel time."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    total = sum(e.device_time_total for e in events
                if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    for name in ranges:
        mine = [e for e in events if e.key == name and e.device_type == DeviceType.CPU]
        us, calls = sum(e.device_time_total for e in mine), sum(e.count for e in mine)
        print(f"   backward {name}: {us / 1e3} ms device x{calls} share={us / total if total else float('nan')}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=None, help="cut the model to its first N layers")
    ap.add_argument("--grad-sync", default="int8_ef", choices=["int8_ef", "auto"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", default="build/torch_train_profile")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.attention import FlashAttentionFn
    from repro_torch.models.moe import GroupedMatmulFn
    from repro_torch.models.ssm import SSDChunkFn
    from repro_torch.optim import OptHParams
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.grad_sync import make_packer
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import tree_map

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    arch = get_config(args.arch)
    if args.layers is not None:
        arch = arch.variant(n_layers=args.layers)
    tcfg = TrainConfig(microbatches=1, remat="none", grad_sync=args.grad_sync)
    ranges = range_backwards((FlashAttentionFn, SSDChunkFn, GroupedMatmulFn))
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0), arch, tcfg)
    step_fn = make_train_step(arch, OptHParams(lr_peak=1e-3, warmup_steps=2, total_steps=20), tcfg)
    batch = {k: torch.from_numpy(v).long().cuda()
             for k, v in SyntheticLM(arch, args.batch, args.seq, seed=0).make_batch(0).items()}
    print(f"arch={arch.name} layers={arch.n_layers} batch={args.batch} seq={args.seq} grad_sync={args.grad_sync} "
          f"remat=none")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    # (1) one train step: forward, backward, int8_ef compression, AdamW
    for _ in range(2):  # warm-up: kernel build, allocator, cuBLAS
        state, met = step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        float(met["loss"])
        wall = time.perf_counter() - t0
    report(f"train step B={args.batch} S={args.seq}", prof, wall)
    backward_shares(prof, ranges)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30} GiB")
    prof.export_chrome_trace(str(out / f"torch_train_profile_{arch.name}_step.json"))
    if args.grad_sync != "int8_ef":
        return 0

    # (2) one device pack of this state's gradients, wire to the host
    grads = loss_and_grads(state["params"], arch, batch, tcfg.remat)[1]
    del state
    ef = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
    pack = make_packer("device")
    pack(grads, ef)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        data, _ = pack(grads, ef)
        wall = time.perf_counter() - t0
    report(f"device pack of {len(data)} wire bytes", prof, wall)
    prof.export_chrome_trace(str(out / f"torch_train_profile_{arch.name}_pack.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
