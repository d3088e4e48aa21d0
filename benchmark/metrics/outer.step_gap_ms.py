"""The device's idle milliseconds per SGA step inside the acquisition: the
mean time, on the device's clock, from the end of one graph replay to the
start of the next where a step's replay is followed by the next step's or
the final pass's, i.e. the turnaround of the host's read of "all stopped"
(the program's own CUDA events; untraced BO iterations of the window,
`benchmark/records.py`). None off CUDA."""

from benchmark import records


def read(run):
    recs = records.window(run)
    if not records.on_device(recs):
        return None
    gaps = []
    for rec in recs:
        for before, after in zip(rec.replays, rec.replays[1:]):
            if (rec.spans[before.span].name == "outer.step"
                    and rec.spans[after.span].name in ("outer.step", "outer.final")
                    and after.idle_s is not None):
                gaps.append(after.idle_s)
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
