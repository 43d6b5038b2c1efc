"""One run of one cell: set-up, the measured window, the check, the result line.

The cell, its configuration, its traffic mix, its driver and every metric
reader are found by name (``perfbench/cells.py``).  The metrics a run
reports are those ``BENCHMARK.json`` gives the cell: with ``--trace 0`` its
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  A reader
that finds nothing to read returns None and its metric is left out.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from types import SimpleNamespace
from typing import Any, Dict, List

from perfbench.cells import HERE, arch_config, benchmark_entries, load_cell, load_module, read_json
from perfbench.readings import idle_by_kind, summaries

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py", description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None, help="override an open loop's rate (the knee sweep)")
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control, the reference in float8, in the program's place")
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is a forbidden one."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_info(torch, chips: int) -> Dict[str, Any]:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def make_ctx(args, cell, device: str, t_start: float, peaks: Dict[str, float]):
    import torch

    cfg = cell["cfg"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    return SimpleNamespace(cell=cell, cfg=cfg, arch=arch_config(cfg), device=device, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace), control=bool(args.control),
                           t_start=t_start, peaks=peaks, sync=sync)


def read_metrics(run: Dict[str, Any], ctx, wanted: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in wanted:
        value = load_module("metrics", m["name"]).read(run, ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks(run: Dict[str, Any], cell: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Each number the run's ``correct`` compares, beside its limit: those
    the cell's ``check`` names (all but ``sample``), every request's length
    and the requests that never got a token."""
    c = run["check"]
    out = {k: {"value": c.get(k), "limit": v} for k, v in cell["check"].items() if k != "sample"}
    out["wrong_length"] = {"value": c["wrong_length"], "limit": 0}
    out["failed"] = {"value": run["failed"], "limit": 0}
    return out


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    if args.rate is not None:
        cell["rate"] = args.rate
    bench = benchmark_entries(args.workload)
    wanted = bench["per_layer"] if args.trace else bench["end_to_end"]
    import torch

    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    table = read_json(HERE / "peaks.json")
    if kind not in table:
        print(f"perfbench: no peaks for {kind!r} in perfbench/peaks.json", file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed={args.seed} seconds={args.seconds} trace={args.trace} "
          f"card: {power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}", file=sys.stderr)
    ctx = make_ctx(args, cell, "cuda", t_start, table[kind])
    result = execute(ctx, cell, wanted)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    result["device"] = {**device_info(torch, chips), **result["device"]}
    emit(result)
    return 0


def execute(ctx, cell: Dict[str, Any], wanted: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Run the cell's driver and build the result (without ``device``'s
    platform, kind and count)."""
    run = load_module("drivers", cell["driver"]).run(ctx)
    count_requests(run)
    metrics = read_metrics(run, ctx, wanted)
    cks = checks(run, cell)
    correct = all(v["value"] is not None and v["value"] <= v["limit"] for v in cks.values())
    device = {"memory_peak_bytes": run["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"], "metrics": metrics,
              "device": device}
    tr = run.get("trace")
    if tr is not None:
        print(f"perfbench: profiler sessions {tr['sessions']}, complete {tr['complete']}, dropped {len(tr['dropped'])}: "
              f"{json.dumps(tr['dropped'])[:2000]}; mean host wall of a profiled step {tr['step_walls']} s, "
              f"of an unprofiled step with work {sum(w for w, _ in run['work_walls']) / max(1, len(run['work_walls']))} s; "
              f"idle by step kind {json.dumps(idle_by_kind(run))}", file=sys.stderr)
        if not all(tr["complete"].values()):
            raise RuntimeError(f"a kind of profiler session has no complete session ({tr['complete']}): "
                               "its device metrics cannot be read")
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        result["breakdown"] = {"device_ops": top(tr["ops"]), "idle_gaps": top(tr["gaps"])}
    for line in run.get("notes", []) + summaries(run):
        print(f"perfbench: {line}", file=sys.stderr)
    c = run["check"]
    print(f"perfbench: check sampled {c['sampled']} requests, {c['sampled_tokens']} served tokens, "
          f"reference {c.get('reference_s')} s; readings {json.dumps({k: v for k, v in c.items() if 'gap' in k or 'share' in k})}",
          file=sys.stderr)
    for name, v in cks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    result["check"] = cks
    return result


def count_requests(run: Dict[str, Any]) -> None:
    """``attempted``: requests due in the window (an open loop) or sent in
    it (a closed loop, its first round included); ``failed``: those of them
    that never got their first token."""
    if run["kind"] != "serve":
        return
    reqs = run["requests"]
    if run["open_loop"]:
        due = [r for r in reqs if run["open"] <= r["due"] < run["close"]]
    else:
        due = [r for r in reqs if r["due"] < run["close"]]
    run["attempted"] = len(due)
    run["failed"] = sum(1 for r in due if not r["times"])


def emit(result: Dict[str, Any]) -> None:
    """The result line: the checks' key last."""
    check = result.pop("check")
    result["check"] = check
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
