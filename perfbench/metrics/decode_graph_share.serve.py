"""``decode_graph_share`` of a serving cell whose end-to-end metric is the
time to first token: the share of the window's decode steps replayed from
CUDA graphs, in % (``decode_graph_share.py``)."""
from perfbench.cells import load_module


def read(run, ctx):
    return load_module("metrics", "decode_graph_share").share(run)
