"""The device milliseconds of an observe step that refits: the mean over
the untraced BO iterations with the MLE run of the device time of the
graph replays inside their `bo.observe` span (true function, condition,
the MLE's Adam steps), from the program's CUDA events
(`benchmark/records.py`). None off CUDA or where no iteration refit."""

from benchmark import records


def read(run):
    recs = records.window(run)
    if not records.on_device(recs):
        return None
    times = [sum(r.device_s for r in rec.replays if rec.within(r.span, "bo.observe"))
             for rec in recs if rec.refit]
    return 1e3 * sum(times) / len(times) if times else None
