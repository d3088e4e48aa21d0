"""The device milliseconds of a myopic BO iteration's solve: the mean over
the window's untraced BO iterations of the device time of the graph
replays inside the iteration's `bo.acquire` span (the lane kernel, its
best-start pass and what surrounds them in `solvers.multistart_maximize`),
from the program's CUDA events (`benchmark/chunks.py`). None off CUDA."""

from benchmark import chunks


def read(run):
    steps = chunks.steps(run)
    return 1e3 * sum(s.solve_s for s in steps) / len(steps) if steps else None
