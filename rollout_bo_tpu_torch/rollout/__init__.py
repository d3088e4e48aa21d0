from rollout_bo_tpu_torch.rollout import mc, observables, outer, solvers, trajectory
from rollout_bo_tpu_torch.rollout.mc import simulate_trajectory_mc
from rollout_bo_tpu_torch.rollout.outer import stochastic_solve_fused
from rollout_bo_tpu_torch.rollout.trajectory import (
    ExpectedTrajectoryOutput,
    TrajectoryParams,
)
