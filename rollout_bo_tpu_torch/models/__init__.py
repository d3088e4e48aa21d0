from rollout_bo_tpu_torch.models import decision_rules, fantasy, surrogate, testfns
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
    optimize_hypers,
    posterior,
)
from rollout_bo_tpu_torch.models.testfns import TestFunction, get_function
