"""Model FLOPs of the tokens decoded (``perfbench/flops.py``) over the
decode walls times the card's bf16 peak, outside the profiler's sessions, in %."""
from perfbench.readings import DECODE_FLOPS, DECODE_S, unprofiled


def read(run, ctx):
    d = unprofiled(run)["deltas"]
    return 100.0 * d[DECODE_FLOPS] / (d[DECODE_S] * ctx.peaks["bfloat16_flops"]) if d[DECODE_S] else None
