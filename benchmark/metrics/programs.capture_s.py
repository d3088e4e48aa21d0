"""Seconds the program's CUDA graphs took to capture (their warm-up runs
included), summed over the programs the window ran: set-up work."""

from benchmark import common


def read(run):
    graphs = common.graphs_of(run.programs)
    return sum(g.capture_seconds for g in graphs) if graphs else None
