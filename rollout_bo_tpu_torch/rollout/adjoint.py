"""Explicit adjoint (reverse) differentiation of a rolled-out trajectory.

Port of `rollout_bo_tpu/rollout/adjoint.py`: the reference's trajectory
adjoint `gradient(T)` (rollout.jl:126-277; math in
`docs/adjoint_mode_response.tex:35-171`), independent of autograd through
the rollout. The production gradient is autograd through
`trajectory.rollout_core` with the IFT rule of `argmax_with_ift`; this
module is the independent check of it (the two agree in
draw_mode="sample_path" on trajectories whose inner solves are interior).

- The three cases of best(T) (rollout.jl:236-249): no improvement -> 0;
  best at step 0 -> -grad y_0; otherwise the back-substitution below.
- solve_dual_x (rollout.jl:150-191): the per-step dual
  x_bar_j = -H_j^{-T} rhs, zeroed where -H_j is not positive definite with
  a Cholesky margin (`_constraint_dual`; the forward IFT's test, not the
  reference's dimension-unaware `det(H) < htol`).
- The (dr_i/dx_j)^T x_bar_i products and the value-channel terms of
  solve_dual_y / gather_g / gather_q: ONE `torch.func.vjp` per constraint
  against the refactorized posterior, with the same cotangents as the JAX
  package's `jax.vjp`.

Sample-path semantics: a fantasy observation y_j is an evaluation of a
fixed GP sample path, so dy_j/dx_j is the drawn gradient row and the draw
carries no derivative with respect to the conditioning state (reference
observables.jl:106-124, tex:167-171).

The refactorized view differentiates K(X, X) with respect to X; the port's
`kernels.eval_KXX` has a finite gradient on K's diagonal. The JAX
package's takes sqrt at distance 0 there, which makes its vjp, and so its
result whenever the best step is t >= 1, NaN.
"""

from __future__ import annotations

import torch

from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as kern
from rollout_bo_tpu_torch.ops import small_chol
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryRecord, base_fmini

__all__ = ["gradient_adjoint"]


def _refactor_view(fs: fant.FantasyState, X, y, n) -> sg.SurrogateState:
    """Differentiable posterior view at active count n from raw (X, y): a
    full masked refactorization (like the perturbation surrogates' refit,
    reference rbs.jl:652-694), so that derivatives through it are exact."""
    K = kern.eval_KXX(fs.kernel, X, noise=fs.noise)
    L = chol_ops.masked_cholesky(K, n)
    Li = chol_ops.tri_inv_padded(L)
    m = chol_ops.active_mask(X.shape[-2], n, dtype=X.dtype, device=X.device)
    return sg.SurrogateState(fs.kernel, X, y, L, chol_ops.psd_apply(Li, y * m), n,
                             fs.noise, Li)


def _constraint_dual(H, rhs, *, htol: float):
    """lam = -H^{-T} rhs with the singularity guard: 0 unless -H is
    positive definite with relative margin htol (reference solve_dual_x's
    final solve, rollout.jl:188, and its guard, rollout.jl:159-161)."""
    d = H.shape[-1]
    A = -0.5 * (H + H.transpose(-1, -2))   # an exact Hessian up to roundoff
    s = torch.clamp(torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1),
                    min=1e-300)
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    ok = torch.all(torch.isfinite(small_chol.chol_small(A - htol * s * eye)))
    lam = small_chol.spd_solve_small(torch.where(ok, A, eye), rhs)
    return torch.where(ok, lam, 0.0), ok


def gradient_adjoint(fs: fant.FantasyState, rec: TrajectoryRecord, rule: DecisionRule,
                     theta, *, htol: float = 1e-4):
    """(grad_x0, grad_theta) of one trajectory's reward by back-substitution.

    fs: the (unbatched) FantasyState after the rollout, all h + 1 fantasies
    conditioned (rows n_base .. n_base + h hold the trajectory); rec: its
    TrajectoryRecord (xs (h+1, d), ys (h+1,), drawn grads (h+1, d)).
    Reference gradient(T) (rollout.jl:233-277): the gradient of
    max(fmini - min_j y_j, 0) with respect to the start x0 and the rule's
    theta, under sample-path draw semantics.
    """
    dt, dev = fs.X.dtype, fs.X.device
    xs, ys, grads = rec.xs.detach(), rec.ys.detach(), rec.grads.detach()
    h, d = xs.shape[0] - 1, xs.shape[1]
    theta = torch.as_tensor(theta, dtype=dt, device=dev).detach()
    p = theta.shape[0]

    fmini = base_fmini(fs)
    t = torch.argmin(ys)
    improved = fmini > torch.amin(ys)
    case2_gx = -grads[0]                      # best at step 0 (rollout.jl:249)

    # case 3: reverse sweep over the implicit constraints j = h..1; the
    # reward fmini - y_t seeds ybar[t] = -1, and steps beyond t contribute
    # nothing (their duals are masked out: the reference's optimal_index)
    steps = torch.arange(h + 1, device=dev)
    xbar = torch.zeros((h + 1, d), dtype=dt, device=dev)
    ybar = torch.where(steps == t, -1.0, 0.0).to(dt)
    theta_bar = torch.zeros((p,), dtype=dt, device=dev)
    rows_all = torch.arange(fs.capacity, device=dev)

    for j in range(h, 0, -1):
        active = (j <= t) & improved
        # fold the y_j -> x_j sample-path channel (dy_j = grad_y_j . dx_j)
        xc = xbar[j] + grads[j] * ybar[j]
        # Hessian of step j's inner solve at its argmax, on the posterior
        # conditioned through fantasy j - 1 (recover_policy_solve,
        # rollout.jl:114-124)
        _, _, H = sg.acquisition_value_grad_hess(fant.view(fs, j - 1), rule, xs[j], theta)
        lam, _ = _constraint_dual(H, xc, htol=htol)
        lam = torch.where(active, lam, 0.0)

        # lam through the constraint r_j = grad alpha_j = 0 to every
        # upstream input (fantasy rows 0..j-1: covariates and values, and
        # theta), in ONE vjp
        frows = fs.n_base + torch.arange(j, device=dev)
        sel = (rows_all[:, None] == frows[None, :])               # (cap, j)
        hit = torch.any(sel, dim=1)
        self_ = sel.to(dt)

        def r_j(rows, yvals, th, j=j, self_=self_, hit=hit):
            X = torch.where(hit[:, None], self_ @ rows, fs.X)
            y = torch.where(hit, self_ @ yvals, fs.y)
            st = _refactor_view(fs, X, y, fs.n_base + j)
            return sg.acquisition_grad(st, rule, xs[j], th)[1]

        _, vjp_fn = torch.func.vjp(r_j, fs.X[frows], fs.y[frows], theta)
        rbar, ybar_in, thbar = vjp_fn(lam)
        xbar = torch.cat([xbar[:j] + rbar, xbar[j:]])            # fantasy i is step i
        ybar = torch.cat([ybar[:j] + ybar_in, ybar[j:]])
        theta_bar = theta_bar + thbar

    # the x_0 node: its covariate cotangent and its sample-path value channel
    case3_gx = xbar[0] + grads[0] * ybar[0]
    gx = torch.where(improved, torch.where(t == 0, case2_gx, case3_gx), 0.0)
    gth = torch.where(improved & (t > 0), theta_bar, 0.0)
    return gx, gth
