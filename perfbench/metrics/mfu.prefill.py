"""Model FLOPs of the prompts prefilled (``perfbench/flops.py``) over the
prefill walls times the card's bf16 peak, outside the profiler's sessions, in %."""
from perfbench.readings import PREFILL_FLOPS, PREFILL_S, unprofiled


def read(run, ctx):
    d = unprofiled(run)["deltas"]
    return 100.0 * d[PREFILL_FLOPS] / (d[PREFILL_S] * ctx.peaks["bfloat16_flops"]) if d[PREFILL_S] else None
