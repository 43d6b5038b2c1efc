#!/usr/bin/env python3
"""Run the repro_torch.analysis concurrency passes over src/repro_torch.

Usage:

    python tools/torch_analyze.py                 # all passes, baseline-aware
    python tools/torch_analyze.py --list
    python tools/torch_analyze.py -p lock-order -p blocking-under-lock
    python tools/torch_analyze.py --strict --json analysis_findings.json

The reviewed baseline is tools/torch_analysis_baseline.json.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
