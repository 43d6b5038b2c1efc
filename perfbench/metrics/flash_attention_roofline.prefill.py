"""Percent of the roofline of the calls to ``ops.attention`` in prefill (their
summed bound, ``rooflines/attention.py``, over the device time of every
kernel launched inside their ranges), in complete profiler sessions."""
from perfbench.readings import roofline


def read(run, ctx):
    return roofline(run, "attention.prefill")
