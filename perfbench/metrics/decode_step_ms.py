"""Wall of one batched decode call (``DecodeCore.decode_seconds`` over
``steps``, ending in the argmax read back), outside the profiler's sessions, in ms."""
from perfbench.readings import DECODE_S, STEPS, unprofiled


def read(run, ctx):
    d = unprofiled(run)["deltas"]
    return 1e3 * d[DECODE_S] / d[STEPS] if d[STEPS] else None
