#!/usr/bin/env python3
"""Do the port's decode rows depend on the batch size?

For each family, runs ``decode_step`` from the same start tokens at batch
1, 2, 4 and 8 for a few greedy steps and prints, for each smaller batch,
the largest |logit| difference of its rows against the same rows at batch
8 (0.0 everywhere: the rows are bit-identical).  With ``--first-op`` it
also records every torch function's output during one step at batch 2
and at batch 4 and names the first whose first two rows differ — the op
to repair.

    PYTHONPATH=src python tools/torch_decode_rows.py            # smoke, f32, CPU
    PYTHONPATH=src python tools/torch_decode_rows.py --first-op --arch tinyllama-1.1b
    python3 tools/torch_decode_rows.py --device cuda --dtype bfloat16

Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params  # noqa: E402

FAMILIES = ["tinyllama-1.1b", "mamba2-130m", "zamba2-1.2b", "deepseek-moe-16b", "minicpm3-4b",
            "internvl2-76b", "llama4-scout-17b-a16e", "whisper-large-v3"]
START = [3, 5, 7, 9, 11, 13, 2, 4]


class _Recorder(TorchFunctionMode):
    """Every torch function's tensor output, in call order."""

    def __init__(self):
        super().__init__()
        self.outputs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.dim() > 0:
            self.outputs.append((getattr(func, "__name__", str(func)), out.detach().clone()))
        return out


def rows(arch, params, b, steps, device, record=False):
    cache = init_cache(arch, b, 64, device)
    toks = torch.tensor(START[:b], device=device)[:, None]
    pos, out, rec = torch.zeros(b, dtype=torch.long, device=device), [], None
    for i in range(steps):
        if record and i == 0:
            rec = _Recorder()
            with rec:
                logits, cache = decode_step(params, arch, toks, pos, cache)
        else:
            logits, cache = decode_step(params, arch, toks, pos, cache)
        out.append(logits[:, 0].float())
        toks, pos = logits[:, 0].argmax(-1)[:, None], pos + 1
    return torch.stack(out, 1), rec


def first_op(rec2, rec4):
    for (name, a), (_, b) in zip(rec2.outputs, rec4.outputs):
        if a.shape[0] == 2 and b.shape[0] == 4 and a.shape[1:] == b.shape[1:] and not torch.equal(a, b[:2]):
            return name
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", help="a family (default: every one)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--threads", type=int, default=1, help="torch CPU threads (tier-1 pins 1)")
    ap.add_argument("--first-op", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for name in args.arch or FAMILIES:
        arch = SMOKES[name].variant(dtype=args.dtype)
        params = init_params(torch.Generator(device=args.device).manual_seed(0), arch)
        with torch.inference_mode():
            ref, _ = rows(arch, params, 8, args.steps, args.device)
            diff = {b: float((rows(arch, params, b, args.steps, args.device)[0] - ref[:b]).abs().max())
                    for b in (1, 2, 4)}
            line = f"{name}: max |logit difference| against batch 8: {diff}"
            if args.first_op:
                _, r2 = rows(arch, params, 2, 1, args.device, record=True)
                _, r4 = rows(arch, params, 4, 1, args.device, record=True)
                line += f"; first op whose rows differ (batch 2 vs 4): {first_op(r2, r4)}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
