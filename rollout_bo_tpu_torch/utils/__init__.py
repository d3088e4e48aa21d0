from rollout_bo_tpu_torch.utils import checkpoint, logging, metrics
