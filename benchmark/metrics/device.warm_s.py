"""Seconds that set-up spent bringing the card to its steady state for
streams of small kernels (`core.warm_device`), which `setup_s` leaves out:
every run pays them before its window."""


def read(run):
    return run.warm_s if run.warm_s > 0 else None
