"""Percent of the roofline of the calls to ``ops.ssd_chunk`` in prefill (their
summed bound, ``rooflines/ssd_chunk.py``, over the device time of every
kernel launched inside their ranges), in complete profiler sessions."""
from perfbench.readings import roofline


def read(run, ctx):
    return roofline(run, "ssd_chunk.prefill")
