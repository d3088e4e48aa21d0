"""rollout_bo_tpu_torch — the rollout-BO engine in PyTorch, for NVIDIA Hopper.

A port of the JAX package `rollout_bo_tpu` (which stays the reference it is
tested against). Module paths and function names follow the JAX package:
`models/surrogate.py` here is the counterpart of `models/surrogate.py`
there, and so on. The idiom is PyTorch's own:

- plain functions on tensors and small NamedTuple / dataclass states;
- every tensor on the rollout path carries leading lane axes (restart x
  MC trajectory) instead of being vmapped, and `lax.scan` loops are Python
  loops;
- the one TPU kernel of the JAX package (the multistart Newton lane solve,
  `ops/pallas_newton.py`) is a hand-written CUDA kernel
  (`csrc/newton_lanes.cu`, bound in `ops/newton_lanes.py`) with a plain
  PyTorch version beside it for CPU tensors.

Numerics: full-f32 matmuls. Reduced-precision (TF32) products push the GP
joint predictive covariance S = k(x,x) - K_xX K^{-1} K_Xx outside the PD
cone past its jitter, at which point chol(S) is NaN and one poisoned MC
lane NaNs the whole acquisition mean (seen with bf16 accumulation on
trid10d at mc=200 in the JAX package). Every product here is tiny, so the
precision costs nothing.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from rollout_bo_tpu_torch import constants, ops, models, parallel, rollout, utils  # noqa: E402

__version__ = "0.1.0"
