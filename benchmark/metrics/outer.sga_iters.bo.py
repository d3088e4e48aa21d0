"""The mean number of outer SGA iterations the window's acquisitions ran
(the eswavs stop ends an acquisition before its cap)."""


def read(run):
    its = [a.iterations for a in run.acquisitions]
    return sum(its) / len(its) if its else None
