"""Seconds from the process's start to the window's: imports, the build or
load of the kernels, the inputs from the seed, the programs' captures and
warm-up; the card's own warm-up (`core.warm_device`) left out, since its
length follows the card's state and not the program: `device.warm_s`
reads it."""


def read(run):
    return run.setup_s
