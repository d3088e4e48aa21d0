"""Experiment setup container (reference: ExperimentSetup, utils.jl:174-208).

Port of `rollout_bo_tpu/utils/experiment.py`. The reference preallocates,
per BO iteration, the Sobol + epsilon-interior multistart guesses of the
inner solves (generate_initial_guesses, utils.jl:145-153), the batch of
outer SGA restart candidates (adaptive_bayesopt.jl:480) and per-sample
result containers. The functional engine needs no containers, so
`ExperimentSetup` bundles the inputs of a non-myopic solve: inner starts,
outer restarts and a TrajectoryParams with the normal stream, computed once
and reused across BO iterations, on an explicit device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

__all__ = ["ExperimentSetup"]


@dataclasses.dataclass(frozen=True)
class ExperimentSetup:
    """Precomputed inputs of one non-myopic acquisition optimization.

    xstarts:  (S, d) inner multistart guesses (Sobol, eps-interior).
    restarts: (R, d) outer SGA restart candidates.
    tp:       TrajectoryParams with the stream (M, d+1, h+1) and the box;
              `tp.x0` is a placeholder that the outer solvers replace.
    """

    xstarts: torch.Tensor
    restarts: torch.Tensor
    tp: TrajectoryParams
    horizon: int
    mc_iters: int

    @classmethod
    def build(cls, lbs, ubs, *, horizon: int, mc_iters: int = 100, num_starts: int = 8,
              num_restarts: int = 8, theta=(0.0,), variance_reduction: bool = True,
              rng: np.random.Generator | None = None, dtype=torch.float64,
              device="cuda") -> "ExperimentSetup":
        """Mirror of the reference constructor (utils.jl:174-208).

        variance_reduction toggles QMC (Sobol / Box-Muller) against
        pseudo-random normal streams (reference TrajectoryParameters,
        trajectory.jl:71-94).
        """
        lbs, ubs = np.asarray(lbs, float), np.asarray(ubs, float)
        d = lbs.shape[0]
        rng = rng or np.random.default_rng(0)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        xstarts = qmc.generate_initial_guesses(num_starts, lbs, ubs)
        restarts = qmc.generate_batch(num_restarts, lbs, ubs)[:num_restarts]
        if variance_reduction:
            z = qmc.gen_low_discrepancy_sequence(mc_iters, d, horizon + 1)
        else:
            z = rng.standard_normal((mc_iters, d + 1, horizon + 1))
        tp = TrajectoryParams(x0=torch.zeros((d,), dtype=dtype, device=device),
                              theta=as_t(theta), lbs=as_t(lbs), ubs=as_t(ubs),
                              rnstream=as_t(z))
        return cls(xstarts=as_t(xstarts), restarts=as_t(restarts), tp=tp,
                   horizon=horizon, mc_iters=mc_iters)

    def resample(self, rng: np.random.Generator, *, variance_reduction=True,
                 start_index: int = 0) -> "ExperimentSetup":
        """A fresh stream: a new QMC offset or new pseudo-random draws."""
        d = int(self.tp.lbs.shape[0])
        if variance_reduction:
            z = qmc.gen_low_discrepancy_sequence(
                self.mc_iters, d, self.horizon + 1, start=start_index)
        else:
            z = rng.standard_normal((self.mc_iters, d + 1, self.horizon + 1))
        rn = self.tp.rnstream
        return dataclasses.replace(self, tp=self.tp._replace(
            rnstream=torch.as_tensor(z, dtype=rn.dtype, device=rn.device)))
