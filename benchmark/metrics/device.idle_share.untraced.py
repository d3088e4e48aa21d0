"""The device's idle share of the untraced BO iterations, in percent: 1
less the device seconds of the program's graph replays (their CUDA events)
over the host seconds of the `bo.iteration` spans. Work the device runs
outside a graph replay (the eager kernels around the programs: the
stream's upload, the "all stopped" reduction) counts as idle. The
window's untraced iterations (`benchmark/records.py`); None off CUDA."""

from benchmark import records


def read(run):
    recs = records.window(run)
    if not records.on_device(recs):
        return None
    host = sum(rec.spans[0].seconds for rec in recs)
    device = sum(r.device_s for rec in recs for r in rec.replays)
    return 100.0 * (1.0 - device / host) if host > 0 else None
