from rollout_bo_tpu_torch.rollout import (
    adjoint,
    bo,
    mc,
    observables,
    outer,
    solvers,
    trajectory,
    trust_region,
)
from rollout_bo_tpu_torch.rollout.adjoint import gradient_adjoint
from rollout_bo_tpu_torch.rollout.bo import (
    MyopicBOResult,
    alternating_horizon,
    fixed_horizon,
    run_adaptive_bo,
    run_myopic_bo,
    run_nonmyopic_bo,
    truncated_horizon,
)
from rollout_bo_tpu_torch.rollout.mc import (
    simulate_trajectory_deterministic,
    simulate_trajectory_ghq,
    simulate_trajectory_mc,
)
from rollout_bo_tpu_torch.rollout.outer import (
    deterministic_solve,
    deterministic_solve_batch,
    make_batched_grad_step,
    make_batched_sga_step,
    make_fused_sga_program,
    make_scanned_sga_program,
    stochastic_solve,
    stochastic_solve_batch,
    stochastic_solve_fused,
    stochastic_solve_scanned,
    stochastic_solve_stepped,
)
from rollout_bo_tpu_torch.rollout.solvers import newton_solve_batch
from rollout_bo_tpu_torch.rollout.trajectory import (
    ExpectedTrajectoryOutput,
    TrajectoryParams,
    TrajectoryRecord,
)
