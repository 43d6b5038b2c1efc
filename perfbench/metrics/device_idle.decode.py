"""Percent of a decode step's host wall in which no device operation ran:
the device-busy seconds a step in complete card-only profiler sessions
over the mean wall of the unprofiled steps (``readings.idle_share``)."""
from perfbench.readings import idle_share


def read(run, ctx):
    return idle_share(run)
