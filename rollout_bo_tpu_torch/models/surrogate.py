"""GP (RBF) surrogate as a fixed-capacity state with pure-functional updates.

Port of `rollout_bo_tpu/models/surrogate.py` (reference
`radial_basis_surrogates.jl:30-317`). Buffers are (capacity, ...) tensors
with an active count `n`, and the Cholesky factor L and its explicit
inverse Li keep the identity-padding invariant of `ops/chol.py`. Every
field may carry leading lane axes: a rollout holds one state per
(restart, trajectory) lane, with `n` an integer tensor of the lane shape.

MLE and the cost-aware rules are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rollout_bo_tpu_torch.constants import DEFAULT_CAPACITY
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as kern
from rollout_bo_tpu_torch.ops.kernels import RBFKernel

__all__ = [
    "SurrogateState",
    "Posterior",
    "fit",
    "from_numpy_state",
    "condition",
    "get_active_minimum",
    "posterior",
    "joint_posterior_cov",
    "acquisition",
    "acquisition_grad",
    "acquisition_value_grad_hess",
    "DEFAULT_CAPACITY",
]

_SIGMA_FLOOR = 1e-10


class SurrogateState(NamedTuple):
    """Fixed-capacity GP state (reference Surrogate struct, rbs.jl:30-41).

    X: (..., cap, d) covariates, rows >= n are zeros.
    y: (..., cap) observations, zero-padded.
    L: (..., cap, cap) lower Cholesky of K_active + noise I, identity-padded.
    c: (..., cap) K^{-1} y coefficients, zero-padded.
    n: (...) int64 active observation count.
    noise: () observation noise sigma_n^2.
    Li: (..., cap, cap) explicit L^{-1}, identity-padded.
    """

    kernel: RBFKernel
    X: torch.Tensor
    y: torch.Tensor
    L: torch.Tensor
    c: torch.Tensor
    n: torch.Tensor
    noise: torch.Tensor
    Li: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        rows = torch.arange(self.capacity, device=self.X.device)
        return rows < self.n[..., None]


def _refactor(kernel: RBFKernel, X, y, n, noise):
    """Full masked refactorization: K -> L, L^{-1} -> c."""
    K = kern.eval_KXX(kernel, X, noise=noise)
    L = chol_ops.masked_cholesky(K, n)
    Li = chol_ops.tri_inv_padded(L)
    m = chol_ops.active_mask(X.shape[-2], n, dtype=X.dtype, device=X.device)
    return L, Li, chol_ops.psd_apply(Li, y * m)


def fit(kernel: RBFKernel, X, y, *, capacity: int = DEFAULT_CAPACITY,
        noise: float = 1e-6, device="cuda", dtype=torch.float64) -> SurrogateState:
    """Surrogate from (..., N, d) data padded to `capacity` (rbs.jl:77-118)."""
    X = torch.as_tensor(X, dtype=dtype, device=device)
    y = torch.as_tensor(y, dtype=dtype, device=device)
    nobs, d = X.shape[-2:]
    if nobs > capacity:
        raise ValueError("capacity must be >= number of observations")
    lead = X.shape[:-2]
    Xp = torch.zeros(lead + (capacity, d), dtype=dtype, device=device)
    Xp[..., :nobs, :] = X
    yp = torch.zeros(lead + (capacity,), dtype=dtype, device=device)
    yp[..., :nobs] = y
    n = torch.full(lead, nobs, dtype=torch.int64, device=device)
    noise = torch.as_tensor(noise, dtype=dtype, device=device)
    kernel = kernel.to(device=device, dtype=dtype)
    L, Li, c = _refactor(kernel, Xp, yp, n, noise)
    return SurrogateState(kernel, Xp, yp, L, c, n, noise, Li)


def from_numpy_state(kind: str, theta, X, y, L, Li, c, n, noise, *,
                     device, dtype) -> SurrogateState:
    """Build a state from another implementation's arrays (e.g. the JAX
    package's `SurrogateState` fields as numpy arrays), unchanged."""
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return SurrogateState(
        RBFKernel(as_t(theta), kind), as_t(X), as_t(y), as_t(L), as_t(c),
        torch.tensor(np.asarray(n), dtype=torch.int64, device=device),
        as_t(noise), as_t(Li))


def condition(state: SurrogateState, xnew, ynew) -> SurrogateState:
    """Rank-1 conditioning on one new observation per lane (rbs.jl:166-222)."""
    n = state.n
    dt = state.X.dtype
    kvec = kern.eval_KxX(state.kernel, xnew, state.X)
    k0 = state.kernel.psi(torch.zeros((), dtype=dt, device=state.X.device)) + state.noise
    L, Li = chol_ops.chol_append_row_with_inv(state.L, state.Li, kvec, k0, n)
    rows = torch.arange(state.capacity, device=state.X.device)
    at = rows == n[..., None]
    X = torch.where(at[..., None], xnew[..., None, :], state.X)
    y = torch.where(at, ynew[..., None], state.y)
    c = chol_ops.psd_apply(Li, y * (rows < n[..., None] + 1).to(dt))
    return state._replace(X=X, y=y, L=L, Li=Li, c=c, n=n + 1)


def get_active_minimum(state: SurrogateState):
    """min over active observations (the EI incumbent f_mini)."""
    big = torch.finfo(state.y.dtype).max
    return torch.amin(torch.where(state.mask, state.y, big), dim=-1)


# --------------------------------------------------------------------------
# Posterior evaluation
# --------------------------------------------------------------------------


class Posterior(NamedTuple):
    """Posterior quantities at a point (reference rbs.jl:224-310 `sx`)."""

    mu: torch.Tensor          # (...)
    grad_mu: torch.Tensor     # (..., d)
    hess_mu: torch.Tensor     # (..., d, d)
    sigma: torch.Tensor
    grad_sigma: torch.Tensor
    hess_sigma: torch.Tensor
    kx: torch.Tensor          # (..., cap) masked covariance vector
    grad_kx: torch.Tensor     # (..., cap, d) masked
    w: torch.Tensor           # K^{-1} kx


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _k0(state):
    return state.kernel.psi(torch.zeros((), dtype=state.X.dtype,
                                        device=state.X.device))


def posterior(state: SurrogateState, x) -> Posterior:
    """Every posterior quantity at x (..., d)."""
    m = state.mask.to(state.X.dtype)
    kx = kern.eval_KxX(state.kernel, x, state.X) * m
    gkx = kern.eval_grad_KxX(state.kernel, x, state.X) * m[..., None]
    gkxT = gkx.transpose(-1, -2)
    LiT = state.Li.transpose(-1, -2)

    mu = torch.sum(kx * state.c, dim=-1)
    grad_mu = _mv(gkxT, state.c)
    hess_mu = kern.hess_contraction(state.kernel, x, state.X, state.c * m)

    v = _mv(state.Li, kx)
    w = _mv(LiT, v)
    Dw = LiT @ (state.Li @ gkx)                          # (..., cap, d)
    var = torch.clamp(_k0(state) - torch.sum(v * v, dim=-1), min=_SIGMA_FLOOR**2)
    sigma = torch.sqrt(var)
    ssafe = torch.clamp(sigma, min=_SIGMA_FLOOR)
    grad_sigma = -_mv(gkxT, w) / ssafe[..., None]
    hess_sigma = (
        -grad_sigma[..., :, None] * grad_sigma[..., None, :]
        - gkxT @ Dw
        - kern.hess_contraction(state.kernel, x, state.X, w * m)
    ) / ssafe[..., None, None]
    return Posterior(mu, grad_mu, hess_mu, sigma, grad_sigma, hess_sigma,
                     kx, gkx, w)


def joint_posterior_cov(state: SurrogateState, x):
    """Joint (f, grad f) predictive mean (..., d+1) and covariance
    (..., d+1, d+1), symmetrized with dtype-aware jitter (rbs.jl:261-267)."""
    dt = state.X.dtype
    d = state.dim
    m = state.mask.to(dt)
    kx = kern.eval_KxX(state.kernel, x, state.X) * m
    gkx = kern.eval_grad_KxX(state.kernel, x, state.X) * m[..., None]
    kxX = torch.cat([kx[..., None, :], gkx.transpose(-1, -2)], dim=-2)
    kxx = kern.kernel_joint_block(state.kernel,
                                  torch.zeros((d,), dtype=dt, device=x.device))
    A = state.Li @ kxX.transpose(-1, -2)                 # (..., cap, d+1)
    S = kxx - A.transpose(-1, -2) @ A
    jitter = 1e-10 if dt == torch.float64 else 1e-6
    eye = torch.eye(d + 1, dtype=dt, device=x.device)
    S = 0.5 * (S + S.transpose(-1, -2)) + jitter * eye
    dmu = torch.cat([torch.sum(kx * state.c, dim=-1)[..., None],
                     _mv(gkx.transpose(-1, -2), state.c)], dim=-1)
    return dmu, S


# --------------------------------------------------------------------------
# Acquisition values and derivatives at a point
# --------------------------------------------------------------------------


def acquisition(state: SurrogateState, rule: DecisionRule, x, theta):
    """alpha(x) = g(mu(x), sigma(x), theta, fmini) (reference sx.αxθ)."""
    p = posterior(state, x)
    return rule(p.mu, p.sigma, theta, get_active_minimum(state))


def acquisition_grad(state: SurrogateState, rule: DecisionRule, x, theta):
    """(alpha, d alpha/dx) by the chain rule (reference sx.∇αx)."""
    p = posterior(state, x)
    args = (p.mu, p.sigma, theta, get_active_minimum(state))
    gmu, gsig = rule.partials(*args)[:2]
    grad = gmu[..., None] * p.grad_mu + gsig[..., None] * p.grad_sigma
    return rule(*args), grad


def acquisition_value_grad_hess(state: SurrogateState, rule: DecisionRule, x, theta):
    """(alpha, grad, hess) with the exact Hessian, including the
    d2g/dmu dsigma cross term the reference omits (rbs.jl:297) — required
    for the implicit-function-theorem gradient to match finite differences."""
    p = posterior(state, x)
    args = (p.mu, p.sigma, theta, get_active_minimum(state))
    gmu, gsig, gmumu, gsigsig, gmusig = (
        t[..., None, None] for t in rule.partials(*args))
    gm, gs = p.grad_mu, p.grad_sigma
    grad = gmu[..., 0] * gm + gsig[..., 0] * gs
    cross = gm[..., :, None] * gs[..., None, :]
    hess = (
        gmumu * gm[..., :, None] * gm[..., None, :]
        + gmu * p.hess_mu
        + gsigsig * gs[..., :, None] * gs[..., None, :]
        + gsig * p.hess_sigma
        + gmusig * (cross + cross.transpose(-1, -2))
    )
    return rule(*args), grad, hess
