"""Checkpoint / resume for BO runs.

Port of `rollout_bo_tpu/utils/checkpoint.py`, with the same `.npz` schema
(`kind, theta, X, y, L, c, n, noise, iteration, metric_*`): a snapshot
written by either package loads in the other. The reference has no
checkpointing: a crashed trial keeps completed CSV rows but cannot resume
a trial. Here every BO iteration can snapshot the full surrogate state and
the metric arrays to a single file, and a run can resume mid-trial.

The explicit inverse factor Li is not stored; loading rebuilds it from L.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as kern

__all__ = ["save_state", "load_state", "save_bo_checkpoint", "load_bo_checkpoint"]


def _state_payload(state: sg.SurrogateState) -> dict:
    arr = lambda t: t.detach().cpu().numpy()
    return dict(kind=np.asarray(state.kernel.kind), theta=arr(state.kernel.theta),
                X=arr(state.X), y=arr(state.y), L=arr(state.L), c=arr(state.c),
                n=arr(state.n), noise=arr(state.noise))


def _state_from(z, device, capacity=None) -> sg.SurrogateState:
    dtype = torch.from_numpy(z["X"][:0]).dtype
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    kernel = kern.RBFKernel(as_t(z["theta"]), str(z["kind"]))
    n = int(z["n"])
    if capacity is not None and capacity != z["X"].shape[0]:
        return sg.fit(kernel, z["X"][:n], z["y"][:n], capacity=capacity,
                      noise=float(z["noise"]), device=device, dtype=dtype)
    L = as_t(z["L"])
    return sg.SurrogateState(
        kernel, as_t(z["X"]), as_t(z["y"]), L, as_t(z["c"]),
        torch.tensor(n, dtype=torch.int64, device=device), as_t(z["noise"]),
        chol_ops.tri_inv_padded(L))


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: sg.SurrogateState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_state_payload(state))


def load_state(path: str, *, device="cuda") -> sg.SurrogateState:
    return _state_from(np.load(_npz(path), allow_pickle=False), device)


def save_bo_checkpoint(path: str, state: sg.SurrogateState, *, iteration: int,
                       metrics: dict | None = None) -> None:
    """Snapshot the surrogate + loop position + metric arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = _state_payload(state)
    payload["iteration"] = np.asarray(iteration)
    for k, v in (metrics or {}).items():
        payload["metric_" + k] = np.asarray(v)
    np.savez(path, **payload)


def load_bo_checkpoint(path: str, capacity: int | None = None, *, device="cuda"):
    """Returns (state, iteration, metrics dict), the state on `device` in
    the dtype it was saved in.

    `capacity` re-fits the surrogate's fixed-size buffers to a different
    capacity (exact refactorization of the active observations), needed
    when a snapshot taken under one budget resumes under a larger one:
    `condition` at full capacity would silently drop new observations.
    """
    z = np.load(_npz(path), allow_pickle=False)
    metrics = {k[len("metric_"):]: z[k] for k in z.files if k.startswith("metric_")}
    return _state_from(z, device, capacity), int(z["iteration"]), metrics
