"""Time of the comm hand-off a step, in ms: the program's ``handoff`` spans
(each ``InferenceServer._comm_step`` over the ``CommChannel`` and its
``ProgressEngine``) summed over each ``engine.step`` span that prefilled or
decoded, outside the profiler's sessions (``perfbench/spans.py``)."""
from perfbench.spans import per_work_step_ms


def read(run, ctx):
    return per_work_step_ms(run, "handoff")
