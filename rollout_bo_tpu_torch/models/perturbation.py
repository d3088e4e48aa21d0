"""Perturbation "surrogates": directional derivatives of the posterior.

Port of `rollout_bo_tpu/models/perturbation.py` (reference perturbation
surrogates, `radial_basis_surrogates.jl:633-764`). The reference
hand-derives how posterior quantities and the acquisition gradient vary
when one fantasy covariate moves (SpatialPerturbationSurrogate: delta-K,
delta-c, delta-mu, delta-sigma, delta-grad-alpha; rbs.jl:652-694) or when
the covariate and, through grad y, the observed value move
(DataPerturbationSurrogate; rbs.jl:711-760). Here each is one
`torch.func.jvp` of {perturbed fantasy point -> refactorized fantasy
posterior -> quantities}, as `jax.jvp` in the JAX package.

Deviation (as in the JAX package): the reference DataPerturbationSurrogate
omits the direct K^{-1} delta-y term in delta-c (its delta-y thunk,
rbs.jl:734-738, reads an undefined field and is never forced); here the
value perturbation is propagated exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as kern

__all__ = ["PerturbationResult", "refantasize", "spatial_perturbation", "data_perturbation"]


class PerturbationResult(NamedTuple):
    """Directional derivatives of posterior and acquisition quantities."""

    d_mu: torch.Tensor
    d_sigma: torch.Tensor
    d_grad_mu: torch.Tensor
    d_grad_sigma: torch.Tensor
    d_grad_alpha: torch.Tensor  # delta(grad alpha): what the adjoint consumes


def _cho_solve_padded(L, b):
    """(L L^T)^{-1} b by two triangular solves."""
    z = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)[..., 0]


def refantasize(fs: fant.FantasyState) -> fant.FantasyState:
    """Recompute L, Li and the whole coefficient history from (X, y): the
    differentiable constructor of an (unbatched) fantasy state, equal to
    replaying fantasy_condition for every recorded fantasy point, so that
    tangents on X / y rows reach the factors (the reference's
    delta-K -> delta-c back-substitution, rbs.jl:675)."""
    K = kern.eval_KXX(fs.kernel, fs.X, noise=fs.noise)
    L = chol_ops.masked_cholesky(K, fs.n_base + fs.m)
    Li = chol_ops.tri_inv_padded(L)
    rows = torch.arange(fs.capacity, device=fs.X.device)
    eye = torch.eye(fs.capacity, dtype=L.dtype, device=L.device)
    cs = []
    for slot in range(fs.cs.shape[-2]):
        # slot 0 = base (n_base active); slot i >= 1 = fantasy i - 1 observed
        n_i = fs.n_base + slot
        L_i = torch.where(rows[:, None] >= n_i, eye, L)
        cs.append(_cho_solve_padded(L_i, fs.y * (rows < n_i).to(fs.y.dtype)))
    return fs._replace(L=L, Li=Li, cs=torch.stack(cs))


def _quantities(st: sg.SurrogateState, rule: DecisionRule, x, theta):
    if getattr(rule, "cost", None) is not None:
        # this mirror of the reference's hand-assembled grad-alpha chain
        # has no 1/c(x) channel; unweighted sensitivities would disagree
        # with surrogate.acquisition_grad, which the autograd IFT route uses
        raise NotImplementedError(
            "perturbation surrogates do not support cost-aware rules; "
            "use the autograd trajectory gradients instead")
    p = sg.posterior(st, x)
    gmu, gsig = rule.partials(p.mu, p.sigma, theta, sg.get_active_minimum(st))[:2]
    grad_alpha = gmu[..., None] * p.grad_mu + gsig[..., None] * p.grad_sigma
    return p.mu, p.sigma, p.grad_mu, p.grad_sigma, grad_alpha


def _as_tensors(fs, x, theta, *vs):
    as_t = lambda a: torch.as_tensor(a, dtype=fs.X.dtype, device=fs.X.device)
    return tuple(as_t(a) for a in (x, theta) + vs)


def spatial_perturbation(fs: fant.FantasyState, fantasy_index: int, rule: DecisionRule,
                         x, theta, dx, sample_index: int) -> PerturbationResult:
    """d(posterior / grad-alpha at x) / d(fantasy covariate `sample_index`) . dx.

    Reference SpatialPerturbationSurrogate (rbs.jl:652-694); the perturbed
    row is X[n_base + sample_index] (the reference's
    `observed + sample_index + 1`, rbs.jl:664).
    """
    x, theta, dx = _as_tensors(fs, x, theta, dx)
    at = (torch.arange(fs.capacity, device=fs.X.device) == fs.n_base + sample_index)

    def f(xrow):
        fs_ = refantasize(fs._replace(X=torch.where(at[:, None], xrow, fs.X)))
        return _quantities(fant.view(fs_, fantasy_index), rule, x, theta)

    _, tangents = torch.func.jvp(f, (fs.X[fs.n_base + sample_index],), (dx,))
    return PerturbationResult(*tangents)


def data_perturbation(fs: fant.FantasyState, fantasy_index: int, rule: DecisionRule,
                      x, theta, dx, grad_y, sample_index: int) -> PerturbationResult:
    """The perturbation entering through the covariate AND the observed
    value, dy = grad_y . dx (the sample-path view of moving fantasy
    `sample_index`). Reference DataPerturbationSurrogate (rbs.jl:711-760)."""
    x, theta, dx, grad_y = _as_tensors(fs, x, theta, dx, grad_y)
    row = fs.n_base + sample_index
    at = torch.arange(fs.capacity, device=fs.X.device) == row

    def f(xrow, yrow):
        fs_ = refantasize(fs._replace(X=torch.where(at[:, None], xrow, fs.X),
                                      y=torch.where(at, yrow, fs.y)))
        return _quantities(fant.view(fs_, fantasy_index), rule, x, theta)

    _, tangents = torch.func.jvp(f, (fs.X[row], fs.y[row]), (dx, torch.dot(grad_y, dx)))
    return PerturbationResult(*tangents)
