"""``repro-torch-analyze`` / ``tools/torch_analyze.py`` — run the analysis
passes over ``src/repro_torch``.

Exit code is 0 iff every finding is covered by the reviewed baseline
(``tools/torch_analysis_baseline.json``).  Stale baseline entries (fingerprint
no longer produced) are *warnings*, not failures — a fixed violation
should not break CI, it should prompt a baseline cleanup.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .registry import AnalysisContext, all_passes, load_baseline, run_passes, split_findings


def _default_root() -> Path:
    # src/repro_torch/analysis/cli.py -> repo root
    return Path(__file__).resolve().parents[3]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-analyze",
        description="concurrency static analysis: lock order, blocking-under-lock, "
        "PostStatus usage, capability dominance, thread ownership, plus the "
        "eight API gates",
    )
    ap.add_argument("--root", type=Path, default=None, help="repo root (default: autodetect)")
    ap.add_argument("--list", action="store_true", help="list registered passes and exit")
    ap.add_argument(
        "-p", "--pass", dest="passes", action="append", metavar="ID",
        help="run only this pass (repeatable; default: all)",
    )
    ap.add_argument("--json", type=Path, default=None, metavar="PATH",
                    help="write findings as JSON to PATH")
    ap.add_argument("--baseline", type=Path, default=None, metavar="PATH",
                    help="reviewed allowlist (default: <root>/tools/torch_analysis_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything as new)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on any non-baselined finding (CI mode; "
                    "this is also the default behavior, the flag documents intent)")
    args = ap.parse_args(argv)

    if args.list:
        for spec in sorted(all_passes().values(), key=lambda s: s.pass_id):
            print(f"{spec.pass_id:24s} {spec.title}")
        return 0

    root = args.root or _default_root()
    ctx = AnalysisContext.for_repo(root)
    try:
        findings = run_passes(ctx, args.passes)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or (root / "tools" / "torch_analysis_baseline.json")
    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    new, accepted, stale = split_findings(findings, baseline)

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {
                "new": [f.to_json() for f in new],
                "baselined": [f.to_json() for f in accepted],
                "stale_baseline": stale,
            },
            indent=2,
        ) + "\n")

    for f in new:
        loc = f"{f.file}:{f.line}" if f.file else "<runtime>"
        print(f"FINDING [{f.pass_id}] {loc}: {f.message}")
        for step in f.witness:
            print(f"    | {step}")
        print(f"    fingerprint: {f.fingerprint}")
    for fp in stale:
        print(f"warning: stale baseline entry (no longer produced): {fp}")
    n_pass = len(args.passes) if args.passes else len(all_passes())
    print(
        f"analyze: {n_pass} pass(es), {len(new)} new finding(s), "
        f"{len(accepted)} baselined, {len(stale)} stale baseline entr(y/ies)"
    )
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
