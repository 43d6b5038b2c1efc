"""Wait of a decode step for the card, in ms: the mean of the program's
``decode.sync`` spans (``DecodeCore.step``: the argmax read back to the
host; ``perfbench/spans.py``), outside the profiler's sessions."""
from perfbench.spans import mean_ms


def read(run, ctx):
    return mean_ms(run, "decode.sync")
