"""BO metrics: gap, simple regret (reference utils.jl:126-143).

Copy of `rollout_bo_tpu/utils/metrics.py` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["gap", "update_gaps", "simple_regret"]


def gap(initial_best: float, observed_best: float, actual_best: float) -> float:
    """(init - best)/(init - opt); 1 means the optimum was found."""
    denom = initial_best - actual_best
    if denom == 0.0:
        return 1.0
    return (initial_best - observed_best) / denom


def update_gaps(observations, actual_best: float, start_index: int = 1) -> np.ndarray:
    """Gap trajectory over a stream of observations (utils.jl:130-141).

    start_index is 1-based as in the reference: the initial best is the min
    of the first `start_index` observations.
    """
    obs = np.asarray(observations, dtype=float)
    initial_best = obs[:start_index].min()
    best_so_far = np.minimum.accumulate(obs)
    return np.array([gap(initial_best, b, actual_best) for b in best_so_far[start_index - 1:]])


def simple_regret(actual_minimum: float, observation: float) -> float:
    return observation - actual_minimum
