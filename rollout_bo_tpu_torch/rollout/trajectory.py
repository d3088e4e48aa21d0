"""Rollout trajectories: h-step fantasized BO, differentiable end to end.

Port of `rollout_bo_tpu/rollout/trajectory.py` (reference `rollout.jl`,
`trajectory.jl`). The trajectory is a Python loop over the h steps; every
tensor carries the lane axes (restart x MC trajectory), so one call rolls
every lane at once and each step makes ONE solver call for all lanes.

The gradient to x0 and theta comes from autograd, given the
implicit-function-theorem rule of `argmax_with_ift`: the solver runs on
detached inputs, and the linearization x* - H^{-1}(g - g.detach()) has
primal x* and derivative -H^{-1} dg/dp (reference rollout.jl:150-191).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import small_chol
from rollout_bo_tpu_torch.ops.kernels import RBFKernel
from rollout_bo_tpu_torch.rollout import solvers

__all__ = [
    "TrajectoryParams",
    "TrajectoryRecord",
    "ExpectedTrajectoryOutput",
    "base_fmini",
    "sample_path_draw",
    "argmax_with_ift",
    "rollout_core",
    "rollout_trajectory",
    "trajectory_reward",
]


class TrajectoryParams(NamedTuple):
    """Mirror of reference TrajectoryParameters (trajectory.jl:43-106).

    x0: (..., d) start points (one per outer restart); theta: (p,) rule
    parameters; rnstream: (mc_iters, d+1, horizon+1) standard normals, one
    (f, grad f) joint-draw column per step, fixed for common random numbers.
    """

    x0: torch.Tensor
    theta: torch.Tensor
    lbs: torch.Tensor
    ubs: torch.Tensor
    rnstream: torch.Tensor

    @property
    def horizon(self) -> int:
        return self.rnstream.shape[-1] - 1

    @property
    def mc_iters(self) -> int:
        return self.rnstream.shape[0]


class TrajectoryRecord(NamedTuple):
    """Rolled-out trajectories (reference `sample(T)`, rollout.jl:85-98)."""

    xs: torch.Tensor      # (..., h+1, d) sampled locations, x0 first
    ys: torch.Tensor      # (..., h+1) fantasy observations
    grads: torch.Tensor   # (..., h+1, d) sample-path gradients


class ExpectedTrajectoryOutput(NamedTuple):
    """MC-averaged trajectory outcome (reference trajectory.jl:112-134)."""

    mu: torch.Tensor
    std_mu: torch.Tensor
    grad_x: torch.Tensor | None = None
    std_grad_x: torch.Tensor | None = None
    grad_theta: torch.Tensor | None = None
    std_grad_theta: torch.Tensor | None = None


def base_fmini(fs: fant.FantasyState):
    """Incumbent: min over the *base* observations (reference rollout.jl:109,
    with the active minimum instead of the padded vector's)."""
    rows = torch.arange(fs.capacity, device=fs.y.device)
    big = torch.finfo(fs.y.dtype).max
    return torch.amin(torch.where(rows < fs.n_base[..., None], fs.y, big), dim=-1)


def sample_path_draw(st: sg.SurrogateState, x, z):
    """Joint (f, grad f) fantasy draw with sample-path derivative semantics.

    Returns (y, grad_y). Primal: y = [dmu + chol(joint cov) z]_0, the
    reference gp_draw with gradient (rbs.jl:588-611). Derivative: dy/dx =
    grad_y, the drawn gradient rows; none with respect to the surrogate
    state or z: the sample path is a fixed function, as in the reference
    adjoint's use of observable gradients (observables.jl:124,
    rollout.jl:164).
    """
    draw = sg.gp_draw_joint(st, x, z).detach()
    gy = draw[..., 1:]
    y = draw[..., 0] + torch.sum(gy * (x - x.detach()), dim=-1)
    return y, gy


def _detached(st: sg.SurrogateState) -> sg.SurrogateState:
    kernel = RBFKernel(st.kernel.theta.detach(), st.kernel.kind)
    return sg.SurrogateState(kernel, *(t.detach() for t in st[1:]))


def argmax_with_ift(fs: fant.FantasyState, fi: int, rule: DecisionRule, theta,
                    lbs, ubs, xstarts, *, iterations: int = 12,
                    htol: float = 1e-4, boundary_tol: float = 1e-8):
    """Inner acquisition argmax per lane, differentiable via the IFT.

    Forward: the multistart Newton solve on the detached fantasy view.
    Backward: x_out = x* - H^{-1}(g(p) - g(p).detach()). The derivative is
    zeroed where -H is not PD with relative margin `htol` on the free
    block, and pinned coordinates (at the box) are held fixed.
    """
    st = fant.view(fs, fi)
    st_sg = _detached(st)
    xstar, _ = solvers.maximize_hot(st_sg, rule, theta.detach(), lbs, ubs, xstarts,
                                    iterations=iterations)

    # differentiable stationarity residual g(fs, theta) at fixed xstar
    _, g = sg.acquisition_grad(st, rule, xstar, theta)
    # fixed Hessian at the solution
    _, _, H = sg.acquisition_value_grad_hess(st_sg, rule, xstar, theta.detach())

    dt = H.dtype
    free = ((xstar > lbs + boundary_tol) & (xstar < ubs - boundary_tol)).to(dt)
    eye = torch.eye(H.shape[-1], dtype=dt, device=H.device)
    # pinned rows get -1 on the diagonal: -Hm is PD iff the free block of -H is
    Hm = H * free[..., :, None] * free[..., None, :] - torch.diag_embed(1.0 - free)
    gm = g * free
    A = -Hm
    s = torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    # PD-with-margin test on the free block (not the reference's
    # det(H) < htol, which is dimension-unaware and sign-wrong for odd d)
    L_test = small_chol.chol_small(A - htol * s[..., None, None] * torch.diag_embed(free))
    ok_h = torch.all(torch.isfinite(L_test), dim=-1).all(dim=-1) & (s > 1e-12)
    # sanitize BEFORE the solve: a singular solve poisons the backward pass
    # with NaN even where the primal result is masked out
    A_safe = torch.where(ok_h[..., None, None], A, eye)
    rhs = -(gm - gm.detach())
    delta = small_chol.spd_solve_small(A_safe, rhs) * free
    keep = torch.all(torch.isfinite(delta), dim=-1) & ok_h
    delta = torch.where(keep[..., None], delta, 0.0)
    return xstar - delta


def rollout_core(fs: fant.FantasyState, x0, theta, lbs, ubs, xstarts,
                 rule: DecisionRule, draw_fn, horizon: int, *, iterations: int = 12):
    """Roll out the trajectories of every lane (reference rollout!, rollout.jl:39-74).

    draw_fn(st_view, x, step) -> (y, grad_y) is the observable. Step 0
    draws at the given x0 (no solve); steps 1..h alternate {argmax at
    fantasy index j-1 -> draw -> rank-1 condition}. Returns the final
    FantasyState and the TrajectoryRecord.
    """
    y0, g0 = draw_fn(fant.view(fs, -1), x0, 0)
    fs = fant.fantasy_condition(fs, x0, y0)
    xs, ys, gs = [x0], [y0], [g0]
    for j in range(1, horizon + 1):
        fi = fs.m - 1
        xj = argmax_with_ift(fs, fi, rule, theta, lbs, ubs, xstarts,
                             iterations=iterations)
        yj, gj = draw_fn(fant.view(fs, fi), xj, j)
        fs = fant.fantasy_condition(fs, xj, yj)
        xs.append(xj)
        ys.append(yj)
        gs.append(gj)
    rec = TrajectoryRecord(torch.stack(xs, dim=-2), torch.stack(ys, dim=-1),
                           torch.stack(gs, dim=-2))
    return fs, rec


def rollout_trajectory(fs: fant.FantasyState, x0, theta, lbs, ubs, xstarts, zstream,
                       rule: DecisionRule, *, iterations: int = 12,
                       draw_mode: str = "reparam"):
    """Stochastic rollout: `rollout_core` with the fixed normals zstream
    (..., d+1, h+1), broadcast against the lanes of x0 (one trajectory per
    lane). draw_mode: see `observables.stochastic_observable`. Returns the
    final FantasyState and the TrajectoryRecord."""
    from rollout_bo_tpu_torch.rollout import observables  # it imports this module

    return rollout_core(fs, x0, theta, lbs, ubs, xstarts, rule,
                        observables.stochastic_observable(zstream, mode=draw_mode),
                        zstream.shape[-1] - 1, iterations=iterations)


def trajectory_reward(fs: fant.FantasyState, x0, theta, lbs, ubs, xstarts, zstream,
                      rule: DecisionRule, *, iterations: int = 12,
                      draw_mode: str = "reparam"):
    """Reward of the rolled-out trajectory, max(fmini - min_j y_j, 0)
    (reference resolve(T), rollout.jl:108-111). Differentiable in x0 and
    theta by autograd: in draw_mode="sample_path" its gradient is the
    reference's adjoint `gradient(T)` (rollout.jl:233-277), in "reparam"
    the exact fixed-stream pathwise gradient."""
    fmini = base_fmini(fs)
    _, rec = rollout_trajectory(fs, x0, theta, lbs, ubs, xstarts, zstream, rule,
                                iterations=iterations, draw_mode=draw_mode)
    # maximum, not clamp: a tie splits its gradient as jnp.maximum does
    return torch.maximum(fmini - torch.amin(rec.ys, dim=-1),
                         torch.zeros((), dtype=rec.ys.dtype, device=rec.ys.device))
