"""Seconds per BO iteration: the window's wall clock over every BO
iteration of the whole trials it ran (acquisition, true evaluation,
condition, MLE; each trial's initial fit)."""


def read(run):
    iterations = sum(t.iterations for t in run.trials)
    return run.window_s / iterations if iterations else None
