from rollout_bo_tpu_torch.rollout import bo, mc, observables, outer, solvers, trajectory
from rollout_bo_tpu_torch.rollout.bo import MyopicBOResult, run_myopic_bo, run_nonmyopic_bo
from rollout_bo_tpu_torch.rollout.mc import (
    simulate_trajectory_deterministic,
    simulate_trajectory_ghq,
    simulate_trajectory_mc,
)
from rollout_bo_tpu_torch.rollout.outer import (
    deterministic_solve,
    deterministic_solve_batch,
    stochastic_solve_fused,
)
from rollout_bo_tpu_torch.rollout.trajectory import (
    ExpectedTrajectoryOutput,
    TrajectoryParams,
)
