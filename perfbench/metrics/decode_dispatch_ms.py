"""Host time of a decode step's dispatch, in ms: the mean of the program's
``decode.dispatch`` spans (``DecodeCore.step``: the tokens and positions
uploaded, ``decode_step`` enqueued, the argmax launched; ``perfbench/spans.py``),
outside the profiler's sessions."""
from perfbench.spans import mean_ms


def read(run, ctx):
    return mean_ms(run, "decode.dispatch")
