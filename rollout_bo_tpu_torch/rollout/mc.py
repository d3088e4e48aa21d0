"""Monte-Carlo rollout-acquisition estimator.

Port of `rollout_bo_tpu/rollout/mc.py::simulate_trajectory_mc` (reference
`rollout.jl:279-340`), batch-first: the lanes are (..., M) for x0 of shape
(..., d) and M = mc_iters trajectories, all rolled in one pass. Per-lane
gradients come from ONE backward pass of the summed rewards, with x0 and
theta expanded to one leaf per lane: lanes do not interact, so the sum's
gradient with respect to a lane's leaf is that lane's own gradient.

Statistics use the sample standard deviation (ddof=1), matching Julia's
Distributions.std (rollout.jl:328-339).
"""

from __future__ import annotations

import torch

from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.rollout import observables as obs
from rollout_bo_tpu_torch.rollout.trajectory import (
    ExpectedTrajectoryOutput,
    TrajectoryParams,
    base_fmini,
    rollout_core,
)

__all__ = ["simulate_trajectory_mc"]


def _stats(v, dim):
    mu = torch.mean(v, dim=dim)
    if v.shape[dim] > 1:
        return mu, torch.std(v, dim=dim, correction=1)
    return mu, torch.zeros_like(mu)


def simulate_trajectory_mc(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, *,
                           with_gradients: bool = True,
                           iterations: int = 12) -> ExpectedTrajectoryOutput:
    """MC rollout-acquisition estimate at every tp.x0 (..., d).

    Returns mu / std_mu of shape (...) and, with gradients, grad_x /
    std_grad_x (..., d) and grad_theta / std_grad_theta (..., p).
    """
    fs0 = fant.make_fantasy(state, tp.horizon)
    M = tp.mc_iters
    d, p = tp.x0.shape[-1], tp.theta.shape[-1]
    lanes = tp.x0.shape[:-1] + (M,)
    x0 = tp.x0.detach()[..., None, :].expand(lanes + (d,)).clone()
    theta = tp.theta.detach().expand(lanes + (p,)).clone()
    draw_fn = obs.stochastic_observable(tp.rnstream)

    def rewards():
        fmini = base_fmini(fs0)
        _, rec = rollout_core(fs0, x0, theta, tp.lbs, tp.ubs, xstarts, rule,
                              draw_fn, tp.horizon, iterations=iterations)
        # maximum, not clamp: a tie splits its gradient as jnp.maximum does
        return torch.maximum(fmini - torch.amin(rec.ys, dim=-1),
                             torch.zeros((), dtype=x0.dtype, device=x0.device))

    if not with_gradients:
        with torch.no_grad():
            mu, smu = _stats(rewards(), -1)
        return ExpectedTrajectoryOutput(mu=mu, std_mu=smu)

    x0.requires_grad_(True)
    theta.requires_grad_(True)
    with torch.enable_grad():
        r = rewards()
        gx, gth = torch.autograd.grad(r.sum(), (x0, theta), allow_unused=True,
                                      materialize_grads=True)
    r = r.detach()
    mu, smu = _stats(r, -1)
    gxm, sgx = _stats(gx, -2)
    gthm, sgth = _stats(gth, -2)
    return ExpectedTrajectoryOutput(mu=mu, std_mu=smu, grad_x=gxm, std_grad_x=sgx,
                                    grad_theta=gthm, std_grad_theta=sgth)
