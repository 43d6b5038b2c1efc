"""Host time of the engine and the comm hand-off a step, in ms: the wall of
``server.step()`` minus the model calls' walls (``prefill_seconds`` and
``decode_seconds``), over the steps that prefilled or decoded outside the
profiler's sessions."""
from perfbench.readings import DECODE_S, PREFILL_S, unprofiled


def read(run, ctx):
    u = unprofiled(run)
    if not u["n"]:
        return None
    d = u["deltas"]
    return 1e3 * (u["wall"] - d[PREFILL_S] - d[DECODE_S]) / u["n"]
