"""Plain Gaussian-process arithmetic of the benchmark's reference.

A zero-mean GP with the Matern-5/2 kernel k(r) = (1 + s + s^2 / 3) e^{-s},
s = sqrt(5) r / ell, and observation noise `noise` on the diagonal. The
tensors have exact sizes (no capacity padding): every lane of a rollout
holds the same number n of observations at a given step, so a state is
(X (..., n, d), y (..., n), Li (..., n, n), c (..., n)) with leading lane
axes, Li the inverse of the Cholesky factor of K + noise I and
c = K^{-1} y. The derivatives of the posterior are written out in closed
form; the expected-improvement rule and its partials keep the guards of
the rule as the configuration states it (sigma_tol, the z clamp at 30).

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SQRT5 = math.sqrt(5.0)
SIGMA_TOL = 1e-8        # EI is 0 where sigma < SIGMA_TOL
SIGMA_FLOOR = 1e-10     # the posterior sd is floored here
Z_CLAMP = 30.0
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


class GP(NamedTuple):
    X: torch.Tensor     # (..., n, d)
    y: torch.Tensor     # (..., n)
    Li: torch.Tensor    # (..., n, n) lower-triangular inverse Cholesky factor
    c: torch.Tensor     # (..., n) K^{-1} y
    ell: float
    noise: float


def profile(r, ell):
    """(psi, a, b) of Matern-5/2 at distances r: psi the kernel, and its
    Hessian in x is a I + b (x - X)(x - X)^T, its gradient a (x - X)."""
    c = SQRT5 / ell
    s = c * r
    e = torch.exp(-s)
    psi = (1.0 + s + s * s / 3.0) * e
    a = -(c * c / 3.0) * (1.0 + s) * e
    b = (c ** 4 / 3.0) * e
    return psi, a, b


def _dist(sq):
    # r = sqrt(sq), with a floor under the root whose gradient is 0 at a
    # coincident point (where x - X is exactly 0) instead of 0 * inf
    return torch.sqrt(torch.clamp(sq, min=torch.finfo(sq.dtype).tiny))


def kernel_matrix(X, ell, noise):
    """K(X, X) + noise I, with k(0) = 1 exactly on the diagonal."""
    R = X[..., :, None, :] - X[..., None, :, :]
    K = profile(_dist(torch.sum(R * R, dim=-1)), ell)[0]
    eye = torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)
    return torch.where(eye.bool(), torch.ones((), dtype=X.dtype, device=X.device), K) \
        + noise * eye


def fit(X, y, ell, noise) -> GP:
    """The GP of data X (..., n, d), y (..., n)."""
    L = torch.linalg.cholesky(kernel_matrix(X, ell, noise))
    eye = torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return GP(X, y, Li, _coef(Li, y), ell, noise)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _coef(Li, y):
    return _mv(Li.transpose(-1, -2), _mv(Li, y))


def append(gp: GP, xn, yn) -> GP:
    """The GP conditioned on one more observation (xn (..., d), yn (...)):
    the Cholesky factor grows by one row, l = Li k, l22 = sqrt(k0 - |l|^2)
    floored at 1e-6, and the inverse factor by the row [-l^T Li / l22, 1 / l22]."""
    R = xn[..., None, :] - gp.X
    kv = profile(_dist(torch.sum(R * R, dim=-1)), gp.ell)[0]
    lv = _mv(gp.Li, kv)
    l22 = torch.sqrt(torch.clamp(1.0 + gp.noise - torch.sum(lv * lv, dim=-1), min=1e-12))
    row = -_mv(gp.Li.transpose(-1, -2), lv) / l22[..., None]
    top = torch.cat([gp.Li, torch.zeros_like(gp.Li[..., :1])], dim=-1)
    bottom = torch.cat([row, (1.0 / l22)[..., None]], dim=-1)[..., None, :]
    Li = torch.cat([top, bottom], dim=-2)
    X = torch.cat([gp.X, xn[..., None, :]], dim=-2)
    y = torch.cat([gp.y, yn[..., None]], dim=-1)
    return GP(X, y, Li, _coef(Li, y), gp.ell, gp.noise)


def _lanes(gp: GP, extra: int):
    """gp's tensors with `extra` unit axes after the lane axes, so that they
    broadcast against points of shape lanes + extra axes + (d,)."""
    def at(t, tail):
        i = t.dim() - tail
        return t.reshape(t.shape[:i] + (1,) * extra + t.shape[i:])
    return at(gp.X, 2), at(gp.Li, 2), at(gp.c, 1)


def posterior_value(gp: GP, x, extra: int):
    """(mu, sigma) at x (lanes + extra axes + (d,))."""
    X, Li, c = _lanes(gp, extra)
    R = x[..., None, :] - X
    kx = profile(_dist(torch.sum(R * R, dim=-1)), gp.ell)[0]
    v = _mv(Li, kx)
    var = torch.clamp(1.0 - torch.sum(v * v, dim=-1), min=SIGMA_FLOOR ** 2)
    return torch.sum(kx * c, dim=-1), torch.sqrt(var)


def draw(gp: GP, x, z, jitter):
    """The fantasy observation mu(x) + sqrt(var_f(x) + jitter) z of the
    latent f at x (lanes + (d,)), z (lanes)."""
    X, Li, c = _lanes(gp, 0)
    R = x[..., None, :] - X
    kx = profile(_dist(torch.sum(R * R, dim=-1)), gp.ell)[0]
    v = _mv(Li, kx)
    return torch.sum(kx * c, dim=-1) + torch.sqrt(1.0 - torch.sum(v * v, dim=-1) + jitter) * z


def posterior_full(gp: GP, x, extra: int, hessians: bool = True):
    """mu, grad mu, sigma, grad sigma and, with `hessians`, hess mu and
    hess sigma at x (lanes + extra axes + (d,)). The variance is
    1 - |Li k|^2; the data term of the sd's Hessian is (Li G)^T (Li G)."""
    X, Li, c = _lanes(gp, extra)
    d = x.shape[-1]
    R = x[..., None, :] - X                                   # (..., n, d)
    sq = torch.sum(R * R, dim=-1)
    kx, a, b = profile(_dist(sq), gp.ell)
    G = a[..., None] * R                                      # grad k_i
    v = _mv(Li, kx)
    w = _mv(Li.transpose(-1, -2), v)
    var = torch.clamp(1.0 - torch.sum(v * v, dim=-1), min=SIGMA_FLOOR ** 2)
    sigma = torch.sqrt(var)
    ss = torch.clamp(sigma, min=SIGMA_FLOOR)
    mu = torch.sum(kx * c, dim=-1)
    gmu = torch.sum(c[..., None] * G, dim=-2)
    gsig = -torch.sum(w[..., None] * G, dim=-2) / ss[..., None]
    if not hessians:
        return mu, gmu, sigma, gsig
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    RT = R.transpose(-1, -2)
    Hmu = (torch.sum(c * a, dim=-1)[..., None, None] * eye
           + RT @ (R * (c * b)[..., None]))
    P = Li @ G
    Hsig = (-gsig[..., :, None] * gsig[..., None, :]
            - P.transpose(-1, -2) @ P
            - RT @ (R * (w * b)[..., None])
            - torch.sum(w * a, dim=-1)[..., None, None] * eye) / ss[..., None, None]
    return mu, gmu, Hmu, sigma, gsig, Hsig


def _cdf(z):
    return 0.5 * torch.special.erfc(-z * _INV_SQRT2)


def _pdf(z):
    return _INV_SQRT2PI * torch.exp(-0.5 * z * z)


def ei(mu, sigma, fmini):
    """Expected improvement below fmini: imp Phi(z) + s phi(z), imp =
    fmini - mu, s = max(sigma, SIGMA_TOL), z = imp / s clamped to +-30;
    0 where sigma < SIGMA_TOL."""
    s = torch.clamp(sigma, min=SIGMA_TOL)
    imp = fmini - mu
    z = torch.clamp(imp / s, -Z_CLAMP, Z_CLAMP)
    val = imp * _cdf(z) + s * _pdf(z)
    return torch.where(sigma < SIGMA_TOL, torch.zeros_like(val), val)


def ei_partials(mu, sigma, fmini):
    """(d/dmu, d/dsigma, d2/dmu2, d2/dsigma2, d2/dmu dsigma) of `ei`, each
    of its guarded pieces differentiated as written: past the z clamp only
    imp's own term is live, below SIGMA_TOL the sigma terms are 0."""
    s = torch.clamp(sigma, min=SIGMA_TOL)
    dt = mu.dtype
    dsig = (sigma > SIGMA_TOL).to(dt)
    guard = (sigma >= SIGMA_TOL).to(dt)
    zraw = (fmini - mu) / s
    z = torch.clamp(zraw, -Z_CLAMP, Z_CLAMP)
    live = (torch.abs(zraw) < Z_CLAMP).to(dt)
    phi = _pdf(z)
    parts = (-_cdf(z), phi * dsig, live * phi / s, live * z * z * phi / s * dsig * dsig,
             live * z * phi / s * dsig)
    return tuple(p * guard for p in parts)


def ei_grad(gp: GP, x, fmini, extra: int):
    """(EI, its gradient in x) at x; differentiable in gp and fmini."""
    mu, gmu, sigma, gsig = posterior_full(gp, x, extra, hessians=False)
    pm, ps = ei_partials(mu, sigma, fmini)[:2]
    return ei(mu, sigma, fmini), pm[..., None] * gmu + ps[..., None] * gsig


def ei_grad_hess(gp: GP, x, fmini, extra: int):
    """(EI, gradient, Hessian) at x, by the chain rule through (mu, sigma)."""
    mu, gmu, Hmu, sigma, gsig, Hsig = posterior_full(gp, x, extra)
    pm, ps, pmm, pss, pms = (p[..., None, None] for p in ei_partials(mu, sigma, fmini))
    cross = gmu[..., :, None] * gsig[..., None, :]
    H = (pmm * gmu[..., :, None] * gmu[..., None, :] + pm * Hmu
         + pss * gsig[..., :, None] * gsig[..., None, :] + ps * Hsig
         + pms * (cross + cross.transpose(-1, -2)))
    g = pm[..., 0] * gmu + ps[..., 0] * gsig
    return ei(mu, sigma, fmini), g, H


# --------------------------------------------------------------------------
# The lengthscale's maximum-likelihood fit
# --------------------------------------------------------------------------


def log_likelihood(X, y, ell, noise):
    """-y^T K^{-1} y / 2 - log det(L) - n log(2 pi) / 2; NaN where K is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(kernel_matrix(X, ell, noise))
    bad = info != 0
    L = torch.where(bad[..., None, None], torch.eye(X.shape[-2], dtype=X.dtype,
                                                    device=X.device), L)
    u = torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]
    ll = (-0.5 * torch.sum(u * u, dim=-1)
          - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
          - X.shape[-2] * math.log(2.0 * math.pi) / 2.0)
    return torch.where(bad, torch.nan, ll)


def fit_lengthscale(X, y, ell0, lb, ub, noise, *, iterations=60, lr=0.1):
    """The lengthscale the configuration's MLE gives: `iterations` projected
    Adam steps (0.9, 0.999, 1e-8) on log(ell) from ell0, held in [lb, ub],
    minimizing the negative log-likelihood; a NaN gradient counts as 0."""
    dt = X.dtype
    llb = math.log(lb)
    lub = math.log(ub)
    lt = torch.clamp(torch.log(torch.as_tensor(ell0, dtype=dt, device=X.device)), llb, lub)
    m = torch.zeros_like(lt)
    v = torch.zeros_like(lt)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(iterations):
        leaf = lt.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(-log_likelihood(X, y, torch.exp(leaf), noise), leaf)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** (i + 1))
        vhat = v / (1 - b2 ** (i + 1))
        lt = torch.clamp(lt - lr * mhat / (torch.sqrt(vhat) + eps), llb, lub)
    return float(torch.exp(lt))
