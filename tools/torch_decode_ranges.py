#!/usr/bin/env python3
"""Where a decode step of the benchmark's decode cell waits, by the port's
own ``repro::`` ranges (``repro_torch.obs``).

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_decode_ranges.py [--steps 6] [--seed 7] [--out build/decode_ranges.json]

It builds ``deepseek-moe-16b`` as the cell ``deepseek-moe-16b.decode``
serves it (``perfbench/configs/``, weights drawn on the card from the
seed), fills the cell's 8 slots with prompts of 161 tokens (the traffic's
mean), decodes 30 steps, and profiles ``--steps`` engine steps (host and
card).  The server replays its decode step from CUDA graphs, where no
``repro::`` range opens; the profiled steps (and ``ranges_ms``) call
``models.decode_step`` directly on the core's cache instead, so that the
idle time by range describes the eager step's ops.  It prints one JSON line:

* ``idle_ms_a_step``: the seconds inside each ``repro::engine.step`` in
  which no device operation ran, by the innermost ``repro::`` host range
  at the gap's midpoint, in ms a step;
* ``device_ops``: device time by operation and by the innermost card-side
  ``repro::`` range that holds it, in ms a step (the largest first);
* ``wall_ms``: the mean host wall of a profiled (eager) step, of an
  unprofiled eager one and of an unprofiled replayed one;
* ``off_ns``: what ``obs.span`` and ``obs.range`` cost with no profiler,
  in ns a call, and the spans a decode step records;
* ``ranges_ms``: the mean host wall of a step with no profiler, under a
  card-only and under a host-and-card session, each with the model's
  ranges and with ``obs.range`` made a no-op, in turns (what the ranges
  cost a step, off and on).

Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def off_cost(n: int = 200_000) -> dict:
    """ns a call of ``obs.span`` (enter and exit) and ``obs.range`` with no profiler."""
    from repro_torch import obs

    def one_span():
        with obs.span("x"):
            pass

    def one_range():
        with obs.range("x"):
            pass

    out = {"span": 1e9 * min(timeit.repeat(one_span, number=n, repeat=3)) / n,
           "range": 1e9 * min(timeit.repeat(one_range, number=n, repeat=3)) / n}
    obs.clear()
    return out


@contextlib.contextmanager
def eager(server_mod):
    """The server's decode calls ``models.decode_step`` on the core's cache
    (no replay)."""
    from repro_torch.models import decode_step

    real = server_mod.decode_step
    server_mod.decode_step = decode_step
    try:
        yield
    finally:
        server_mod.decode_step = real


def unprofiled_walls(server, n: int = 10) -> list:
    """Host walls of ``n`` engine steps, in s."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        server.step()
        walls.append(time.perf_counter() - t0)
    return walls


def ranges_cost(server, steps: int = 6, rounds: int = 2) -> dict:
    """Mean host wall (ms) of a step with no profiler, under a card-only and
    under a host-and-card session, with the model's ranges and with
    ``obs.range`` a no-op, in turns (ranges, none, none, ranges), ``rounds``
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    kinds = {"unprofiled": None, "card": [ProfilerActivity.CUDA],
             "host_and_card": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    real = obs.range
    walls = {f"{k}.{r}": [] for k in kinds for r in ("ranges", "no_ranges")}
    try:
        for i in range(4 * rounds):
            ranged = i % 4 in (0, 3)
            obs.range = real if ranged else (lambda name: obs._NOOP)
            for kind, acts in kinds.items():
                torch.cuda.synchronize()
                with profile(activities=acts) if acts else contextlib.nullcontext():
                    for _ in range(steps):
                        t0 = time.perf_counter()
                        server.step()
                        walls[f"{kind}.{'ranges' if ranged else 'no_ranges'}"].append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
    finally:
        obs.range = real
    return {k: 1e3 * sum(v) / len(v) for k, v in walls.items()}


def innermost(spans, s, e):
    """The shortest (start, end, name) of ``spans`` that holds [s, e], or None."""
    best = None
    for a, b, n in spans:
        if a <= s and e <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, n)
    return best


def read(prof, steps: int) -> dict:
    from torch.autograd import DeviceType

    host, card, dev = [], [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation:
                if e.name.startswith("repro::"):
                    card.append(r)
            else:
                dev.append(r)
        elif e.name.startswith("repro::"):
            host.append(r)
    dev.sort()
    idle, ops = {}, {}
    for s, e, n in dev:
        holder = innermost(card, s, e)
        key = f"{n[:70]} @ {holder[2][7:] if holder else '(no range)'}"
        ops[key] = ops.get(key, 0.0) + (e - s) / 1e3 / steps
    for s0, e0, _ in (h for h in host if h[2] == "repro::engine.step"):
        t = s0
        for s, e, _ in dev:
            if e <= s0 or s >= e0:
                continue
            if s > t:
                gap = (t, s)
                lab = innermost(host, (gap[0] + gap[1]) / 2, (gap[0] + gap[1]) / 2)
                idle[lab[2][7:]] = idle.get(lab[2][7:], 0.0) + (s - t) / 1e3 / steps
            t = max(t, e)
        if e0 > t:
            lab = innermost(host, (t + e0) / 2, (t + e0) / 2)
            idle[lab[2][7:]] = idle.get(lab[2][7:], 0.0) + (e0 - t) / 1e3 / steps
    top = lambda d, k: dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])  # noqa: E731
    busy = sum(e - s for s, e, _ in dev) / 1e3 / steps
    return {"idle_ms_a_step": top(idle, 20), "device_ops": top(ops, 16), "device_ms_a_step": busy,
            "kernels_a_step": len(dev) / steps}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_decode_ranges: needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench.cells import arch_config, load_cell
    from perfbench.weights import make_params
    from repro_torch import obs
    from repro_torch.serve import InferenceServer, ServeConfig
    from repro_torch.serve import server as server_mod

    off = off_cost()
    cell = load_cell("deepseek-moe-16b.decode")
    cfg, sv = cell["cfg"], cell["serve"]
    params = make_params(cfg, args.seed, "cuda")
    server = InferenceServer(arch_config(cfg), params, ServeConfig(slots=sv["slots"], context=sv["context"],
                                                                   max_prefill=sv["max_prefill"],
                                                                   transport=sv["transport"]))
    gen = torch.Generator().manual_seed(args.seed)
    for _ in range(sv["slots"]):
        server.submit(torch.randint(0, cfg["vocab_size"], (161,), generator=gen).tolist(), 1000)
    for _ in range(30):
        server.step()
    torch.cuda.synchronize()
    replayed = unprofiled_walls(server)
    with eager(server_mod):
        obs.clear()
        walls = unprofiled_walls(server)
        spans_a_step = len(obs.spans()[0]) / 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pwalls = unprofiled_walls(server, args.steps)
            torch.cuda.synchronize()
        cost = ranges_cost(server)
    mean_ms = lambda v: 1e3 * sum(v) / len(v)  # noqa: E731
    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__, "steps": args.steps,
           "wall_ms": {"profiled": mean_ms(pwalls), "unprofiled": mean_ms(walls), "replayed": mean_ms(replayed)},
           "off_ns": dict(off, spans_a_step=spans_a_step), "ranges_ms": cost, **read(prof, args.steps)}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
