"""What the loops share: the run record the metric readers read, the
program counters, and the comparisons that decide `correct`."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Acquisition:
    """One rollout acquisition the window completed."""

    seconds: float           # host clock to its synchronized result
    iterations: int          # outer SGA iterations it ran
    n_base: int              # observations of the surrogate it solved on
    lanes: int               # restarts x trajectories
    traced: bool = False     # inside the profiler's stretch


@dataclasses.dataclass
class Trial:
    """One BO trial the window completed."""

    seconds: float               # wall clock of the trial
    acquisition_seconds: float   # the sum of its acquisitions' times
    iterations: int              # BO iterations


@dataclasses.dataclass
class Run:
    """What a window did: the metric readers read this and nothing else."""

    cell: object                      # core.Cell
    window_s: float = 0.0             # the window's wall clock
    acquisitions: list = dataclasses.field(default_factory=list)
    trials: list = dataclasses.field(default_factory=list)
    programs: list = dataclasses.field(default_factory=list)   # GraphProgram-like
    trace: object = None              # trace.Trace of the traced stretch
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0              # the process's start to the window's, less warm_s
    warm_s: float = 0.0               # the card's warm-up (core.warm_device)
    peak_bytes: int = 0
    answers: object = None            # what the loop's check reads

    @property
    def traced(self):
        return [a for a in self.acquisitions if a.traced]


def seed_rng(seed: int, *key: int) -> np.random.Generator:
    """The NumPy generator of the stream `key` of a run's seed (any whole
    number: it is taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % 2 ** 64, *key])


def graphs_of(programs):
    """Every graph program among `programs`: a program that holds graphs
    of its own (`.graphs`) counts each of them."""
    out = []
    for p in programs:
        out.extend(getattr(p, "graphs", (p,)))
    return [g for g in out if hasattr(g, "capture_seconds")]


def rel_gap(a, b) -> float:
    """max |a - b| / max |b|; 0 where a and b are equal."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    if diff == 0.0:
        return 0.0
    scale = float(np.max(np.abs(b)))
    return diff / scale if scale > 0 else math.inf


def se_gap(value: float, est) -> float:
    """|value - the reference's estimate| in standard errors of the
    estimate (its trajectories' sd over sqrt(M)); 0 where they are equal,
    infinite where they differ and the estimate has no spread."""
    mu, sd, m = float(est.mu[0]), float(est.std[0]), est.count
    diff = abs(value - mu)
    if diff == 0.0:
        return 0.0
    se = sd / math.sqrt(m)
    return diff / se if se > 0 else math.inf


def box_excess(x, lbs, ubs) -> float:
    """How far x lies outside the box, as a share of the box's width."""
    return float(np.max(np.maximum(np.maximum(lbs - x, x - ubs), 0.0) / (ubs - lbs)))


def worst(values) -> float:
    """The largest of `values` (NaN counts as infinite); 0 for none."""
    vals = [math.inf if not math.isfinite(v) else v for v in values]
    return max(vals) if vals else 0.0
