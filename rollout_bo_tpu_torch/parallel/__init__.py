"""Several GPUs: the ('restarts', 'mc') rank mesh (`mesh`), the sharded
solves (`sharded`, loaded on first use: it builds on `rollout`, which
imports `mesh`) and the multi-process worker (`multihost_worker`)."""

import importlib

from rollout_bo_tpu_torch.parallel import mesh
from rollout_bo_tpu_torch.parallel.mesh import Mesh, initialize_distributed, make_mesh

_SHARDED = ("sharded", "sharded_simulate_mc", "sharded_stochastic_solve_batch",
            "sharded_stochastic_solve_fused", "sharded_stochastic_solve_scanned")


def __getattr__(name):
    if name in _SHARDED:
        sharded = importlib.import_module("rollout_bo_tpu_torch.parallel.sharded")
        return sharded if name == "sharded" else getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
