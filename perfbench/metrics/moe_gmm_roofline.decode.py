"""Percent of the roofline of the calls to ``ops.expert_ffn_matmul`` in decode (their
summed bound, ``rooflines/expert_ffn_matmul.py``, over the device time of every
kernel launched inside their ranges), in complete profiler sessions."""
from perfbench.readings import roofline


def read(run, ctx):
    return roofline(run, "expert_ffn_matmul.decode")
