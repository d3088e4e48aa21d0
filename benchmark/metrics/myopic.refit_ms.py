"""The device milliseconds of a myopic observe step that refits: the mean
over the window's untraced BO iterations with the MLE run of the device
time of the graph replays inside the iteration's `bo.observe` span (true
function, condition, the MLE's Adam steps), from the program's CUDA events
(`benchmark/chunks.py`). None off CUDA or where no iteration refit."""

from benchmark import chunks


def read(run):
    steps = chunks.steps(run)
    times = [s.observe_s for s in steps or () if s.refit]
    return 1e3 * sum(times) / len(times) if times else None
