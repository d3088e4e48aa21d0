from rollout_bo_tpu_torch.ops import chol, gp_mle, kernels, newton_lanes, qmc, quadrature, small_chol
from rollout_bo_tpu_torch.ops.kernels import (
    RBFKernel,
    matern12,
    matern32,
    matern52,
    periodic,
    squared_exponential,
)
