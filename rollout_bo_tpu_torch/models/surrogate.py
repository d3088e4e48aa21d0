"""GP (RBF) surrogate as a fixed-capacity state with pure-functional updates.

Port of `rollout_bo_tpu/models/surrogate.py` (reference
`radial_basis_surrogates.jl:30-317`). Buffers are (capacity, ...) tensors
with an active count `n`, and the Cholesky factor L and its explicit
inverse Li keep the identity-padding invariant of `ops/chol.py`. Every
field may carry leading lane axes: a rollout holds one state per
(restart, trajectory) lane, with `n` an integer tensor of the lane shape.

The hyperparameter MLE (`optimize_hypers`) takes the closed-form gradient
of the log-likelihood over the active block (`ops/gp_mle.py`): on the card
all its Adam steps run in one launch of the kernel `csrc/gp_mle.cu`, on the
CPU in the plain version; the JAX package differentiates through its
Cholesky with `jax.grad`. `grad_log_likelihood` differentiates through the
masked Cholesky with `torch.autograd`. A cost-aware rule (`models/cost_functions.py`) carries
an x-dependent cost c(x): the acquisition functions divide by it (EI, POI)
or subtract log c (LogEI, LogPOI), with the quotient-rule gradient and
Hessian, over the same lane axes as x.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from rollout_bo_tpu_torch.constants import DEFAULT_CAPACITY
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import gp_mle
from rollout_bo_tpu_torch.ops import kernels as kern
from rollout_bo_tpu_torch.ops import small_chol
from rollout_bo_tpu_torch.ops.kernels import RBFKernel

__all__ = [
    "SurrogateState",
    "Posterior",
    "fit",
    "refit",
    "from_numpy",
    "from_numpy_state",
    "condition",
    "reset",
    "set_kernel",
    "get_active_minimum",
    "posterior",
    "joint_posterior_cov",
    "joint_posterior_chol",
    "gp_draw",
    "gp_draw_joint",
    "acquisition",
    "acquisition_grad",
    "acquisition_value_grad_hess",
    "lazy_posterior",
    "log_likelihood",
    "dlog_likelihood",
    "grad_log_likelihood",
    "optimize_hypers",
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


def _refactor(kernel: RBFKernel, X, y, n, noise, *, nan_if_not_pd: bool = False):
    """Full masked refactorization: K -> L, L^{-1} -> c."""
    K = kern.eval_KXX(kernel, X, noise=noise)
    L = chol_ops.masked_cholesky(K, n, nan_if_not_pd=nan_if_not_pd)
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


def from_numpy(X, y, *, device="cuda", dtype=torch.float64, **kw) -> SurrogateState:
    """`fit` with the default Matern-5/2 kernel; `kw` as for `fit`."""
    return fit(kern.matern52(device=device, dtype=dtype), X, y, device=device,
               dtype=dtype, **kw)


def refit(state: SurrogateState, *, nan_if_not_pd: bool = False) -> SurrogateState:
    """Re-factorize on the same data; used after hyperparameter moves."""
    L, Li, c = _refactor(state.kernel, state.X, state.y, state.n, state.noise,
                         nan_if_not_pd=nan_if_not_pd)
    return state._replace(L=L, Li=Li, c=c)


def set_kernel(state: SurrogateState, kernel: RBFKernel) -> SurrogateState:
    """Swap the kernel and refactorize (reference set_kernel!, rbs.jl:123-135)."""
    return refit(state._replace(kernel=kernel))


def reset(state: SurrogateState, X, y) -> SurrogateState:
    """Re-fit on new data in buffers of the same capacity (reference reset!,
    rbs.jl:147-164)."""
    return fit(state.kernel, X, y, capacity=state.capacity, noise=state.noise,
               device=state.X.device, dtype=state.X.dtype)


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


def joint_posterior_chol(state: SurrogateState, x):
    """Joint mean [mu; grad mu] (..., d+1) and the Cholesky factor of the
    joint (f, grad f) predictive covariance (..., d+1, d+1), NaN where the
    covariance is not PD (reference `sx.dsigma`, rbs.jl:261-267, 530-539).
    The Cholesky backward is fragile for a marginally-PD S in float32; the
    rollout's "reparam" draw differentiates only sqrt(S[0, 0])."""
    dmu, S = joint_posterior_cov(state, x)
    return dmu, small_chol.chol_small(S)


def gp_draw(state: SurrogateState, x, z):
    """Scalar posterior draw mu + sigma z (reference gp_draw, rbs.jl:588-611)."""
    p = posterior(state, x)
    return p.mu + p.sigma * z


def gp_draw_joint(state: SurrogateState, x, z):
    """Joint (f, grad f) draw dmu + chol(joint cov) z, for z (..., d+1)."""
    dmu, Ld = joint_posterior_chol(state, x)
    return dmu + _mv(Ld, z)


# --------------------------------------------------------------------------
# Acquisition values and derivatives at a point
# --------------------------------------------------------------------------


_COST_FLOOR = 1e-12


def _rule_cost(rule, x, order: int):
    """(mode, c, grad c, hess c)[:order + 2] for a cost-aware rule, else None.

    Mode "divide" maximizes alpha / c (nonnegative rules: EI, POI); mode
    "subtract_log" maximizes alpha - log c (LogEI, LogPOI): dividing a
    negative log value by the cost would invert the cost preference.
    Only the derivatives up to `order` are evaluated.
    """
    cost = getattr(rule, "cost", None)
    if cost is None:
        return None
    mode = "subtract_log" if rule.name in ("LogEI", "LogPOI") else "divide"
    c, *derivs = cost.derivatives(x, order)
    return (mode, torch.clamp(c, min=_COST_FLOOR), *derivs)


def acquisition(state: SurrogateState, rule: DecisionRule, x, theta):
    """alpha(x) = g(mu(x), sigma(x), theta, fmini) (reference sx.αxθ); for a
    cost-aware rule alpha / c or alpha - log c (see _rule_cost)."""
    p = posterior(state, x)
    a = rule(p.mu, p.sigma, theta, get_active_minimum(state))
    cq = _rule_cost(rule, x, 0)
    if cq is not None:
        mode, c = cq
        a = a - torch.log(c) if mode == "subtract_log" else a / c
    return a


def acquisition_grad(state: SurrogateState, rule: DecisionRule, x, theta):
    """(alpha, d alpha/dx) by the chain rule (reference sx.∇αx)."""
    p = posterior(state, x)
    args = (p.mu, p.sigma, theta, get_active_minimum(state))
    gmu, gsig = rule.partials(*args)[:2]
    a = rule(*args)
    grad = gmu[..., None] * p.grad_mu + gsig[..., None] * p.grad_sigma
    cq = _rule_cost(rule, x, 1)
    if cq is not None:
        mode, c, gc = cq
        if mode == "subtract_log":          # (a - log c)' = a' - c'/c
            a, grad = a - torch.log(c), grad - gc / c[..., None]
        else:                               # (a/c)' = a'/c - a c'/c^2
            a, grad = a / c, grad / c[..., None] - (a / c**2)[..., None] * gc
    return a, grad


def acquisition_value_grad_hess(state: SurrogateState, rule: DecisionRule, x, theta):
    """(alpha, grad, hess) with the exact Hessian, including the
    d2g/dmu dsigma cross term the reference omits (rbs.jl:297) — required
    for the implicit-function-theorem gradient to match finite differences."""
    p = posterior(state, x)
    args = (p.mu, p.sigma, theta, get_active_minimum(state))
    gmu, gsig, gmumu, gsigsig, gmusig = (
        t[..., None, None] for t in rule.partials(*args))
    gm, gs = p.grad_mu, p.grad_sigma
    a = rule(*args)
    grad = gmu[..., 0] * gm + gsig[..., 0] * gs
    cross = gm[..., :, None] * gs[..., None, :]
    hess = (
        gmumu * gm[..., :, None] * gm[..., None, :]
        + gmu * p.hess_mu
        + gsigsig * gs[..., :, None] * gs[..., None, :]
        + gsig * p.hess_sigma
        + gmusig * (cross + cross.transpose(-1, -2))
    )
    cq = _rule_cost(rule, x, 2)
    if cq is not None:
        mode, c, gc, Hc = cq
        c1, c2 = c[..., None], c[..., None, None]
        gcgc = gc[..., :, None] * gc[..., None, :]
        if mode == "subtract_log":
            # A = a - log c: HA = Ha - Hc/c + grad c grad c^T / c^2
            hess = hess - Hc / c2 + gcgc / c2**2
            a, grad = a - torch.log(c), grad - gc / c1
        else:
            # A = a/c: HA = Ha/c - (grad a grad c^T + grad c grad a^T)/c^2
            #               - a Hc/c^2 + 2 a grad c grad c^T / c^3
            xgc = grad[..., :, None] * gc[..., None, :]
            a2 = a[..., None, None]
            hess = (hess / c2 - (xgc + xgc.transpose(-1, -2)) / c2**2
                    - (a2 / c2**2) * Hc + (2.0 * a2 / c2**3) * gcgc)
            a, grad = a / c, grad / c1 - (a / c**2)[..., None] * gc
    return a, grad, hess


def lazy_posterior(state: SurrogateState, x, rule: DecisionRule | None = None,
                   theta=None):
    """Lazily forced posterior record (reference `sx`, rbs.jl:224-310).

    A `utils.lazy.LazyStruct` with the reference's field names: mu,
    grad_mu, hess_mu, sigma, grad_sigma, hess_sigma, dsigma (the joint
    (f, grad f) predictive Cholesky) and, given a rule, alpha, grad_alpha,
    hess_alpha. The posterior fields share ONE `posterior` call and the
    acquisition fields ONE `acquisition_value_grad_hess` call, each made
    when a field of its group is first read.
    """
    from rollout_bo_tpu_torch.utils.lazy import LazyStruct

    s = LazyStruct()
    s.p = lambda: posterior(state, x)
    for name in ("mu", "grad_mu", "hess_mu", "sigma", "grad_sigma", "hess_sigma"):
        s.set(name, lambda name=name: getattr(s.p, name))
    s.dmu_dsigma = lambda: joint_posterior_chol(state, x)
    s.dsigma = lambda: s.dmu_dsigma[1]
    if rule is not None:
        th = torch.zeros((1,), dtype=state.X.dtype, device=state.X.device) \
            if theta is None else theta
        s.avgh = lambda: acquisition_value_grad_hess(state, rule, x, th)
        s.alpha = lambda: s.avgh[0]
        s.grad_alpha = lambda: s.avgh[1]
        s.hess_alpha = lambda: s.avgh[2]
    return s


# --------------------------------------------------------------------------
# Hyperparameter MLE (reference rbs.jl:770-829)
# --------------------------------------------------------------------------


def log_likelihood(state: SurrogateState):
    """Closed-form GP log-marginal-likelihood of the active block:
    -y^T c / 2 - sum(log diag L) - n log(2 pi) / 2 (rbs.jl:770-776). The
    identity padding contributes log 1 = 0 to the log-determinant."""
    dt = state.y.dtype
    return (-torch.sum(state.y * state.mask.to(dt) * state.c, dim=-1) / 2.0
            - torch.sum(torch.log(torch.diagonal(state.L, dim1=-2, dim2=-1)), dim=-1)
            - state.n.to(dt) * math.log(2.0 * math.pi) / 2.0)


def _ll_of_theta(theta, state: SurrogateState):
    """log-likelihood of the state's data under kernel hyperparameters
    `theta`; NaN (never an exception) where K(theta) is not PD."""
    return log_likelihood(refit(state._replace(kernel=state.kernel.replace_theta(theta)),
                                nan_if_not_pd=True))


def _detached(state: SurrogateState) -> SurrogateState:
    return SurrogateState(state.kernel.replace_theta(state.kernel.theta.detach()),
                          *(t.detach() for t in state[1:]))


def grad_log_likelihood(state: SurrogateState):
    """d log-lik / d theta, by autograd through the masked Cholesky; equals
    the reference's directional-trace formula (rbs.jl:778-799). NaN, like
    the likelihood itself, where K(theta) is not positive definite."""
    state = _detached(state)
    with torch.enable_grad():
        theta = state.kernel.theta.clone().requires_grad_(True)
        ll = _ll_of_theta(theta, state)
        (g,) = torch.autograd.grad(ll, theta)
    return torch.where(torch.isfinite(ll.detach()), g, torch.nan)


def dlog_likelihood(state: SurrogateState, dtheta):
    """Directional derivative of the log-likelihood along dtheta (reference
    delta-log_likelihood, rbs.jl:778-785)."""
    g = grad_log_likelihood(state)
    return torch.sum(g * torch.as_tensor(dtheta, dtype=g.dtype, device=g.device))


def optimize_hypers(state: SurrogateState, lowerbounds, upperbounds, *,
                    iterations: int = 60, lr: float = 0.1) -> SurrogateState:
    """Box-constrained MLE of the kernel hyperparameters; returns the refit
    state.

    The reference uses Optim.Fminbox(LBFGS) with 30 iterations
    (rbs.jl:805-829); here, as in the JAX package: a fixed number of
    projected Adam iterations on log(theta) (all hypers are positive
    scales), by `ops.gp_mle.gp_mle`: the closed-form gradient of the
    log-likelihood over the active block, every step in one kernel launch
    on CUDA tensors, the plain version on CPU tensors. A trial theta at
    which K is not positive definite has gradient 0, so that step only
    decays the momentum. The loop makes no host synchronization. The state
    is refit once at the final theta; if that theta is outside the PD cone
    the returned factors are NaN, as in the JAX package, not an exception.
    One surrogate: a state with lane axes raises.
    """
    if state.n.dim():
        raise ValueError("optimize_hypers: one surrogate (n must be a scalar), got a state "
                         f"with lane axes {tuple(state.n.shape)}")
    state = _detached(state)
    dt, dev = state.X.dtype, state.X.device
    lb = torch.as_tensor(lowerbounds, dtype=dt, device=dev)
    ub = torch.as_tensor(upperbounds, dtype=dt, device=dev)
    theta = gp_mle.gp_mle(state.kernel.kind, state.X, state.y, state.n, state.noise,
                          state.kernel.theta, lb, ub, iterations=iterations, lr=lr)
    return refit(state._replace(kernel=state.kernel.replace_theta(theta)),
                 nan_if_not_pd=True)
