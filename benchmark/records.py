"""The program's own trace records of a run's window: the
`IterationRecord`s that `rollout_bo_tpu_torch.utils.profiling.RECORDS`
keeps of every BO iteration, read by the per-layer metrics of the spans
inside the program.

The window's trials are the last BO iterations the process runs (set-up's
warm-up iteration runs before them), so the window's records are the last
N, N the BO iterations of the run's trials. They must match the trials one
for one: each trial a serial of its own, in order, with iterations
b = 0, 1, ... The records of iterations a profiler saw (`traced`: the one
the harness traces, and the next, whose acquisition holds the profiler's
stop) are dropped, so that the metrics read the untraced program.
"""

from __future__ import annotations


def window(run):
    """The untraced records of the run's window, or None: a program that
    keeps no records, fewer than N, or records that do not match the
    run's trials."""
    try:
        from rollout_bo_tpu_torch.utils import profiling
    except ImportError:
        return None
    kept = getattr(profiling, "RECORDS", None)
    n = sum(t.iterations for t in run.trials)
    if kept is None or n == 0 or len(kept) < n:
        return None
    last = list(kept)[-n:]
    start, serial = 0, None
    for trial in run.trials:
        group = last[start:start + trial.iterations]
        start += trial.iterations
        if serial is not None and group[0].serial <= serial:
            return None
        serial = group[0].serial
        if [(r.serial, r.b) for r in group] != [(serial, b) for b in range(trial.iterations)]:
            return None
    return [r for r in last if not r.traced]


def on_device(records) -> bool:
    """Whether the records hold device time (CUDA)."""
    return bool(records) and all(r.cuda for r in records)
