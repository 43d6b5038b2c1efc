"""95th percentile of every gap between consecutive tokens of one request
whose later token arrived in the window, in ms."""
from perfbench.readings import itl_gaps
from perfbench.stats import percentile


def read(run, ctx):
    gaps = itl_gaps(run) if run["kind"] == "serve" else []
    return 1e3 * percentile(gaps, 95) if gaps else None
