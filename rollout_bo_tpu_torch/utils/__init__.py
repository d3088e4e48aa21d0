from rollout_bo_tpu_torch.utils import checkpoint, experiment, lazy, logging, metrics, profiling
