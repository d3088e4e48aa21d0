"""Monte-Carlo / Gauss-Hermite rollout-acquisition estimators.

Port of `rollout_bo_tpu/rollout/mc.py` (reference `rollout.jl:279-467`),
batch-first: the lanes are (..., N) for x0 of shape (..., d) and N
trajectories per start (the MC samples, or the num_nodes^(h+1) quadrature
index tuples), all rolled in one pass. Per-lane gradients come from ONE
backward pass of the summed rewards, with x0 and theta expanded to one
leaf per lane: lanes do not interact, so the sum's gradient with respect
to a lane's leaf is that lane's own gradient.

Statistics use the sample standard deviation (ddof=1), matching Julia's
Distributions.std (rollout.jl:328-339). `simulate_trajectory_mc` also
takes the trajectories split over the ranks of a process group (the 'mc'
axis of `parallel.mesh`): its statistics are then taken over all of them.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import quadrature
from rollout_bo_tpu_torch.rollout import observables as obs
from rollout_bo_tpu_torch.rollout.trajectory import (
    ExpectedTrajectoryOutput,
    TrajectoryParams,
    base_fmini,
    rollout_core,
)

__all__ = [
    "simulate_trajectory_mc",
    "simulate_trajectory_ghq",
    "simulate_trajectory_deterministic",
    "ghq_tables",
]


def _stats(v, dim):
    mu = torch.mean(v, dim=dim)
    if v.shape[dim] > 1:
        return mu, torch.std(v, dim=dim, correction=1)
    return mu, torch.zeros_like(mu)


def _group_stats(vs, group):
    """(mean, ddof-1 std) over the last axis of each v in vs, across the
    ranks of `group`, each holding an equal share of the M trajectories:
    two passes, one all-reduce each (the sums, then the squared deviations
    from the mean over all M), every v packed into one buffer."""
    m = vs[0].shape[-1] * dist.get_world_size(group)
    shapes = [v.shape[:-1] for v in vs]
    sizes = [v[..., 0].numel() for v in vs]

    def summed(parts):
        buf = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(buf, group=group)
        return [b.reshape(s) for b, s in zip(buf.split(sizes), shapes)]

    means = [s / m for s in summed([v.sum(dim=-1) for v in vs])]
    if m == 1:
        return [(mu, torch.zeros_like(mu)) for mu in means]
    sq = summed([((v - mu[..., None]) ** 2).sum(dim=-1) for v, mu in zip(vs, means)])
    return [(mu, torch.sqrt(s / (m - 1))) for mu, s in zip(means, sq)]


def _lane_rewards(state, x0, theta, lbs, ubs, xstarts, rule, draw_fn, horizon,
                  n_lanes, *, with_gradients, iterations, weigh=None):
    """Rewards max(fmini - min_j y_j, 0) of n_lanes trajectories from every
    x0 (..., d): r (..., n_lanes) and, with gradients, the per-lane
    d r / d x0 (..., n_lanes, d) and d r / d theta (..., n_lanes, p), else
    None for both. `weigh(r, ys)` rescales a lane's reward before it is
    differentiated."""
    fs0 = fant.make_fantasy(state, horizon)
    d, p = x0.shape[-1], theta.shape[-1]
    lanes = x0.shape[:-1] + (n_lanes,)
    x0 = x0.detach()[..., None, :].expand(lanes + (d,)).clone()
    theta = theta.detach().expand(lanes + (p,)).clone()

    def rewards():
        fmini = base_fmini(fs0)
        _, rec = rollout_core(fs0, x0, theta, lbs, ubs, xstarts, rule,
                              draw_fn, horizon, iterations=iterations)
        # maximum, not clamp: a tie splits its gradient as jnp.maximum does
        r = torch.maximum(fmini - torch.amin(rec.ys, dim=-1),
                          torch.zeros((), dtype=x0.dtype, device=x0.device))
        return r if weigh is None else weigh(r, rec.ys)

    if not with_gradients:
        with torch.no_grad():
            return rewards(), None, None
    x0.requires_grad_(True)
    theta.requires_grad_(True)
    with torch.enable_grad():
        r = rewards()
        gx, gth = torch.autograd.grad(r.sum(), (x0, theta), allow_unused=True,
                                      materialize_grads=True)
    return r.detach(), gx, gth


def simulate_trajectory_mc(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, *,
                           with_gradients: bool = True,
                           iterations: int = 12,
                           draw_mode: str = "reparam",
                           group=None) -> ExpectedTrajectoryOutput:
    """MC rollout-acquisition estimate at every tp.x0 (..., d) (reference
    rollout.jl:279-340).

    Returns mu / std_mu of shape (...) and, with gradients, grad_x /
    std_grad_x (..., d) and grad_theta / std_grad_theta (..., p).
    draw_mode: "reparam" (exact pathwise gradients, default) or
    "sample_path" (reference coupling); see
    `observables.stochastic_observable`.

    `group`: a process group whose ranks each hold an equal share of the
    trajectories in tp.rnstream; the statistics are then over all of them
    (every rank gets the same), from two all-reduces.
    """
    r, gx, gth = _lane_rewards(
        state, tp.x0, tp.theta, tp.lbs, tp.ubs, xstarts, rule,
        obs.stochastic_observable(tp.rnstream, mode=draw_mode), tp.horizon,
        tp.mc_iters, with_gradients=with_gradients, iterations=iterations)
    if group is not None:
        if not with_gradients:
            ((mu, smu),) = _group_stats([r], group)
            return ExpectedTrajectoryOutput(mu=mu, std_mu=smu)
        (mu, smu), (gxm, sgx), (gthm, sgth) = _group_stats(
            [r, gx.transpose(-1, -2), gth.transpose(-1, -2)], group)
        return ExpectedTrajectoryOutput(mu=mu, std_mu=smu, grad_x=gxm, std_grad_x=sgx,
                                        grad_theta=gthm, std_grad_theta=sgth)
    mu, smu = _stats(r, -1)
    if not with_gradients:
        return ExpectedTrajectoryOutput(mu=mu, std_mu=smu)
    gxm, sgx = _stats(gx, -2)
    gthm, sgth = _stats(gth, -2)
    return ExpectedTrajectoryOutput(mu=mu, std_mu=smu, grad_x=gxm, std_grad_x=sgx,
                                    grad_theta=gthm, std_grad_theta=sgth)


def ghq_tables(num_nodes: int, horizon: int, node_scale: float = 1.0, *, dtype, device):
    """(nodes, weights), each (num_nodes^(h+1), h+1): the Gauss-Hermite node
    and weight of every tensor-product index tuple, node_scale applied to
    the nodes, as tensors on `device` copied from the host."""
    nodes_np, weights_np = quadrature.gauss_hermite(num_nodes)
    idx = torch.as_tensor(quadrature.tensor_product_indices(num_nodes, horizon + 1),
                          device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return as_t(nodes_np * node_scale)[idx], as_t(weights_np)[idx]


def simulate_trajectory_ghq(state: sg.SurrogateState, x0, theta, lbs, ubs, xstarts,
                            rule: DecisionRule, *, horizon: int, num_nodes: int = 8,
                            with_gradients: bool = True, iterations: int = 12,
                            resolve_mode: str = "quadrature",
                            node_scale: float = 1.0,
                            tables=None) -> ExpectedTrajectoryOutput:
    """Gauss-Hermite (SAA / deterministic) rollout estimate at every x0
    (..., d): reference simulate_trajectory_ghq (rollout.jl:409-467) with
    tensor-product index sets (utils.jl:217-221). The num_nodes^(h+1) index
    tuples are the lane axis.

    resolve_mode:
    - "quadrature": tensor-product GH quadrature: each trajectory weighted
      by prod_j w_j / pi^((h+1)/2) and summed.
    - "reference": the reference's scheme (observables.jl:66-72 + mean over
      samples): only the best step's weight, normalized 1/sqrt(pi), then
      the *mean* over the index set.

    node_scale multiplies the quadrature nodes: sqrt(log10 e) ~ 0.659
    integrates against the understated fantasy-noise distribution that the
    reference's log10 Box-Muller quirk (utils.jl:33-35) draws from in its
    stochastic runs, for comparisons against those archives.

    `tables`: `ghq_tables(num_nodes, horizon, node_scale, ...)` made by the
    caller, which it must be inside a CUDA graph's capture (making them
    copies from the host).
    """
    if resolve_mode not in ("quadrature", "reference"):
        raise ValueError(f"unknown resolve mode {resolve_mode!r}")
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    if tables is None:
        tables = ghq_tables(num_nodes, horizon, node_scale, dtype=dt, device=dev)
    nodes, weights = tables                                # (S, h+1) each
    x0, theta = as_t(x0), as_t(theta)

    weigh = None
    if resolve_mode == "reference":
        def weigh(r, ys):
            best = torch.argmin(ys, dim=-1, keepdim=True)
            wt = torch.gather(weights.expand(ys.shape), -1, best)[..., 0]
            return wt * r / math.sqrt(math.pi)

    r, gx, gth = _lane_rewards(
        state, x0, theta, as_t(lbs), as_t(ubs), as_t(xstarts), rule,
        obs.gauss_hermite_observable(nodes), horizon, nodes.shape[0],
        with_gradients=with_gradients, iterations=iterations, weigh=weigh)

    if resolve_mode == "reference":
        stats = _stats
    else:
        W = torch.prod(weights, dim=-1) / math.pi ** ((horizon + 1) / 2.0)

        def stats(v, dim):
            w = W if dim == -1 else W[:, None]
            mean = torch.sum(w * v, dim=dim)
            var = torch.sum(w * (v - mean.unsqueeze(dim)) ** 2, dim=dim)
            return mean, torch.sqrt(torch.clamp(var, min=0.0))

    mu, smu = stats(r, -1)
    if not with_gradients:
        return ExpectedTrajectoryOutput(mu=mu, std_mu=smu)
    gxm, sgx = stats(gx, -2)
    gthm, sgth = stats(gth, -2)
    return ExpectedTrajectoryOutput(mu=mu, std_mu=smu, grad_x=gxm, std_grad_x=sgx,
                                    grad_theta=gthm, std_grad_theta=sgth)


def simulate_trajectory_deterministic(state: sg.SurrogateState, x0, theta, lbs, ubs,
                                      xstarts, rule: DecisionRule, f, *, horizon: int,
                                      with_gradients: bool = True,
                                      iterations: int = 12) -> ExpectedTrajectoryOutput:
    """Ground-truth-observable rollout from every x0 (..., d) (reference
    DeterministicObservable); f maps (..., d) to (...)."""
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    r, gx, gth = _lane_rewards(
        state, as_t(x0), as_t(theta), as_t(lbs), as_t(ubs), as_t(xstarts), rule,
        obs.deterministic_observable(f), horizon, 1,
        with_gradients=with_gradients, iterations=iterations)
    r = r[..., 0]
    if not with_gradients:
        return ExpectedTrajectoryOutput(mu=r, std_mu=torch.zeros_like(r))
    gx, gth = gx[..., 0, :], gth[..., 0, :]
    z = torch.zeros_like
    return ExpectedTrajectoryOutput(r, z(r), gx, z(gx), gth, z(gth))
