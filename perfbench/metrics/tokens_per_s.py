"""Output tokens that arrived in the window, over the window."""
from perfbench.readings import in_window, token_times
from perfbench.stats import rate


def read(run, ctx):
    if run["kind"] != "serve":
        return None
    return rate(sum(1 for ts in token_times(run) for t in ts if in_window(run, t)), run["close"] - run["open"])
