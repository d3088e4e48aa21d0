"""Observable mechanisms for trajectories: draw-function factories.

Port of `rollout_bo_tpu/rollout/observables.py` (reference
`observables.jl`). A draw function `draw(st_view, x, step) -> (y, grad_y)`
is what `rollout_core` consumes; x carries the lane axes, and whatever
differs from lane to lane (the normals, the quadrature nodes) carries the
lanes' last axis.

- stochastic_observable: joint (f, grad f) draws from the fantasy posterior
  with a fixed normal column per step (observables.jl:83-124);
- gauss_hermite_observable: y = mu + sqrt(2) sigma nu_step
  (observables.jl:32-81), fully differentiable;
- deterministic_observable: ground-truth f / grad f (observables.jl:126-152).
"""

from __future__ import annotations

import math

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import small_chol
from rollout_bo_tpu_torch.rollout.trajectory import sample_path_draw

__all__ = [
    "stochastic_observable",
    "gauss_hermite_observable",
    "deterministic_observable",
]

_SQRT2 = math.sqrt(2.0)


def stochastic_observable(zstream, mode: str = "reparam"):
    """Joint (f, grad f) posterior draws with fixed normals.

    zstream: (..., d+1, h+1) standard normals, one column per step,
    broadcast against the lane axes (the rollout passes the whole
    (M, d+1, h+1) stream, whose M axis is the lanes' last).

    mode "reparam" (default): the draw y = [dmu(x) + chol(S(x)) z]_0 is
    differentiated exactly with the z's held fixed, which makes the
    gradient of the MC estimator the exact gradient of the fixed-stream
    estimate. Its value only involves row 0 of chol(S), which is
    sqrt(S[0, 0]), so only that scalar is differentiated; the full factor
    (needed only for the reported gradient rows) stays detached, avoiding
    the fragile Cholesky backward on marginally-PD covariances in float32.

    mode "sample_path": the reference's coupling (observables.jl:106-124,
    rollout.jl:164): the trajectory is read off a fixed GP sample path,
    dy/dx is the drawn gradient, and the draw's dependence on the
    conditioning state is dropped. Also unbiased, but not the derivative
    of the fixed-z MC value.
    """
    if mode not in ("reparam", "sample_path"):
        raise ValueError(f"unknown draw mode {mode!r}")

    def draw(st: sg.SurrogateState, x, j: int):
        z = zstream[..., j]
        if mode == "sample_path":
            return sample_path_draw(st, x, z)
        dmu, S = sg.joint_posterior_cov(st, x)
        y = dmu[..., 0] + S[..., 0, 0].sqrt() * z[..., 0]
        Ld = small_chol.chol_small(S.detach())
        gy = (dmu.detach() + (Ld @ z[..., None])[..., 0])[..., 1:]
        return y, gy

    return draw


def gauss_hermite_observable(nodes):
    """nodes: (..., h+1) Gauss-Hermite nodes, one index tuple per lane of
    the lanes' last axis."""

    def draw(st: sg.SurrogateState, x, j: int):
        nu = nodes[..., j]
        p = sg.posterior(st, x)
        y = p.mu + _SQRT2 * p.sigma * nu
        gy = p.grad_mu + _SQRT2 * p.grad_sigma * nu[..., None]
        return y, gy

    return draw


def deterministic_observable(f):
    """Ground-truth observations of f (..., d) -> (...). The value is
    differentiated by autograd through f; the reported gradient rows are
    values only (nothing differentiates them again)."""

    def draw(st: sg.SurrogateState, x, j: int):
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            (gy,) = torch.autograd.grad(f(xd).sum(), xd)
        return f(x), gy

    return draw
