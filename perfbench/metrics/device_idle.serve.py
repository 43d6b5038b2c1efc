"""Percent of an engine step's host wall in which no device operation ran,
counted only over steps in which the engine held an active slot or a
request (gaps between arrivals do not count): the device-busy seconds a
step in complete card-only profiler sessions over the mean wall of the
unprofiled steps with work (``readings.idle_share``)."""
from perfbench.readings import idle_share


def read(run, ctx):
    return idle_share(run)
