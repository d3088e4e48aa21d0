"""Milliseconds per BO iteration spent outside the acquisition: each
trial's wall clock less its acquisitions' times (the observe step: true
function, condition, MLE; and the trial's initial fit), over the BO
iterations."""


def read(run):
    iterations = sum(t.iterations for t in run.trials)
    if not iterations:
        return None
    return 1e3 * sum(t.seconds - t.acquisition_seconds for t in run.trials) / iterations
