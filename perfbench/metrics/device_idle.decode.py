"""Percent of a decode step's host wall in which no device operation ran:
the busy seconds of complete card-only profiler sessions over the walls
their steps take unprofiled, admitting and plain steps each held against
their own kind and weighted as the window's unprofiled steps hold them
(``readings.idle_share``)."""
from perfbench.readings import idle_share


def read(run, ctx):
    return idle_share(run)
