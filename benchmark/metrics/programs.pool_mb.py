"""The device memory the captured graphs' private pools hold, in MB (1e6
bytes), summed over the programs the window ran."""

from benchmark import common


def read(run):
    graphs = common.graphs_of(run.programs)
    return sum(g.pool_bytes for g in graphs) / 1e6 if graphs else None
