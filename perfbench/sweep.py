#!/usr/bin/env python3
"""The knee sweep of an open-loop cell: run the cell at each of several
offered rates and print, for each, the TTFT median and 75th percentile, the
ITL percentiles and the growth of the backlog (requests waiting for their first token).  The knee is the
highest rate whose backlog does not grow through the window; the cell's
file takes 0.8 of it as a number.  Run once, when the cell is defined, on
the card:

    python3 perfbench/sweep.py --workload deepseek-moe-16b.longprompt --rates 1.5,2,2.5,3 --seconds 30 --seed 7

Each rate is its own run of ``perfbench/run.py`` (``--rate`` overrides the
cell's), so each pays its set-up.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        cmd = [sys.executable, str(RUN), "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", "0", "--rate", str(rate)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode:
            print(f"rate {rate}: exit {p.returncode}\n{p.stderr[-3000:]}", file=sys.stderr)
            return p.returncode
        res = json.loads(p.stdout.strip().splitlines()[-1])
        backlog = re.search(r"backlog: mean by quarter (\[.*?\]), growth (\S+)", p.stderr)
        ttft = re.search(r"ttft over \d+ requests due in the window: median (\S+) ms, p75 (\S+) ms", p.stderr)
        itl = re.search(r"itl over \d+ gaps: percentiles \(ms\) (\{.*?\})", p.stderr)
        row = {"rate": rate, "attempted": res["attempted"], "failed": res["failed"],
               "ttft_p50_ms": float(ttft.group(1)) if ttft else None, "ttft_p75_ms": float(ttft.group(2)) if ttft else None,
               "itl_ms": itl.group(1) if itl else None, "backlog_by_quarter": backlog.group(1) if backlog else None,
               "backlog_growth_per_s": float(backlog.group(2)) if backlog else None, "correct": res["correct"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
