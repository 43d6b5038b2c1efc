#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this machine holds.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints progress and, as its last lines, each
number the correctness check compares beside its limit on standard error;
prints the result as one JSON line, the last line of standard output.
Exits non-zero, printing no result, without enough CUDA devices.  Every
cache the run writes stays inside the checkout (``build/``): the port's
kernels are built by ``nvcc`` into ``build/repro_torch_kernels/`` on the
first run and loaded from there after.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# the script's own folder (sys.path[0]) would shadow the standard library's
# names (trace, stats) with the benchmark's modules
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
