"""Several GPUs: the ('restarts', 'mc') rank mesh (`mesh`), the sharded
solves (`sharded`, imported on its own: it builds on `rollout`, which
imports `mesh`) and the multi-process worker (`multihost_worker`)."""

from rollout_bo_tpu_torch.parallel import mesh
from rollout_bo_tpu_torch.parallel.mesh import Mesh, initialize_distributed, make_mesh
