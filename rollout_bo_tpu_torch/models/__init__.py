from rollout_bo_tpu_torch.models import (
    cost_functions,
    decision_rules,
    fantasy,
    perturbation,
    surrogate,
    testfns,
)
from rollout_bo_tpu_torch.models.cost_functions import (
    CostAwareRule,
    GaussianProcessCost,
    NonUniformCost,
    UniformCost,
    UnitCost,
    cost_aware,
)
from rollout_bo_tpu_torch.models.decision_rules import (
    EI,
    LCB,
    POI,
    DecisionRule,
    LogEI,
    LogPOI,
    RandomAcquisition,
)
from rollout_bo_tpu_torch.models.surrogate import (
    SurrogateState,
    condition,
    fit,
    from_numpy_state,
    lazy_posterior,
    optimize_hypers,
    posterior,
)
from rollout_bo_tpu_torch.models.testfns import TestFunction, get_function
