"""Share of the window's decode steps replayed from CUDA graphs, in %: the
program's ``decode.graph`` spans (``serve/server.py`` ``decode_step``, one
a replayed step) whose parent is a ``decode.dispatch`` span (one a decode
step) that started in the window outside the profiler's sessions, over
those ``decode.dispatch`` spans (``perfbench/spans.py``).  None where the
program has no graph runner (``repro_torch.models.decode_graph``)."""
import importlib.util

from perfbench.spans import NAME, PARENT, START, records, window_spans


def share(run):
    if importlib.util.find_spec("repro_torch.models.decode_graph") is None:
        return None
    recs = records(run)
    steps = {r[START] for r in window_spans(run, recs, "decode.dispatch")} if recs is not None else set()
    if not steps:
        return None
    return 100.0 * sum(1 for r in recs if r[NAME] == "decode.graph" and r[PARENT] in steps) / len(steps)


def read(run, ctx):
    return share(run)
