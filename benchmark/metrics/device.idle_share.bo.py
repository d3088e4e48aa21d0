"""The device's idle share of the traced stretch, in percent: 1 less the
union of the kernel intervals over the stretch's length."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
