"""The program's own trace records of a myopic run's window: the
`IterationRecord`s that `rollout_bo_tpu_torch.utils.profiling.RECORDS`
keeps of every chunk of BO iterations, read by the per-layer metrics of a
myopic iteration's split (`myopic.*`).

The window's trials are the last the process runs (set-up's warm-up runs
before them), so their chunks' records are the last ones: each trial's
records of one serial, in order, their iterations tiling b = 0, 1, ...,
the trial's iterations, each trial's serial above the one before. The
records a profiler saw (the harness's traced trial) are dropped, so that
the metrics read the untraced program. A program whose records hold no
per-iteration split (`steps`), or no device time, gives nothing to read.
"""

from __future__ import annotations


def window(run):
    """The untraced chunk records of the run's window, or None: a program
    that keeps no records, too few, or records that do not tile the run's
    trials."""
    try:
        from rollout_bo_tpu_torch.utils import profiling
    except ImportError:
        return None
    kept = list(getattr(profiling, "RECORDS", ()))
    if not run.trials:
        return None
    out, end, later = [], len(kept), None
    for trial in reversed(run.trials):
        group, covered = [], 0
        while covered < trial.iterations and end > 0:
            end -= 1
            group.insert(0, kept[end])
            covered += kept[end].iterations
        serial, b = group[0].serial if group else None, 0
        for rec in group:
            if rec.serial != serial or rec.loop != "myopic" or rec.b != b:
                return None
            b += rec.iterations
        if b != trial.iterations or (later is not None and serial >= later):
            return None
        later = serial
        out[:0] = group
    return [r for r in out if not r.traced]


def steps(run):
    """The `Step` (solve_s, observe_s, refit) of every untraced BO
    iteration of the window, or None where there is nothing to read."""
    recs = window(run)
    if not recs:
        return None
    out = []
    for rec in recs:
        split = getattr(rec, "steps", None)
        if split is None or len(split) != rec.iterations:
            return None
        out.extend(split)
    if not out or any(s.solve_s is None or s.observe_s is None for s in out):
        return None
    return out
