"""Prefill wall (``DecodeCore.prefill_seconds``) per 1,000 prompt tokens
prefilled, outside the profiler's sessions, in ms."""
from perfbench.readings import PREFILL_S, PROMPT_TOKENS, unprofiled


def read(run, ctx):
    d = unprofiled(run)["deltas"]
    return 1e3 * d[PREFILL_S] / (d[PROMPT_TOKENS] / 1e3) if d[PROMPT_TOKENS] else None
