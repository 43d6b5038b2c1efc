"""75th percentile, over every request due in the window of an open loop,
of its first token's arrival minus its due time, in ms: the highest
percentile with ten or more requests beyond it in a window of 50 or more.
A request that never got its first token counts with the time it waited
until the run stopped waiting."""
from perfbench.readings import ttft_waits
from perfbench.stats import percentile


def read(run, ctx):
    waits = ttft_waits(run)
    return 1e3 * percentile(waits, 75) if waits else None
