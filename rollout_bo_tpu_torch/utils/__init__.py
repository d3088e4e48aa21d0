from rollout_bo_tpu_torch.utils import checkpoint, experiment, graphs, lazy, logging, metrics, profiling
