"""Stationary RBF kernel families and batched kernel-matrix assembly.

Port of `rollout_bo_tpu/ops/kernels.py` (reference
`radial_basis_functions.jl`). Each family is a scalar profile psi(rho,
theta). The JAX package derives psi' and psi'' with `jax.grad`; here they
are written out in closed form, so the factored Hessian contraction needs
no autograd and autograd through the closed forms still gives the exact
higher derivatives where the rollout differentiates them.

Points are row-major `(N, d)`. Every function takes any number of leading
lane axes: `x (..., d)` against `X (..., N, d)`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "RBFKernel",
    "matern52",
    "matern32",
    "matern12",
    "squared_exponential",
    "periodic",
    "kernel_value",
    "kernel_grad",
    "kernel_hess",
    "kernel_joint_block",
    "hess_contraction",
    "eval_KXX",
    "eval_KxX",
    "eval_grad_KxX",
    "eval_dKXX",
    "eval_dKxX",
    "eval_dgrad_KxX",
    "eval_Dtheta_KXX",
]

_EPS = 1e-14
_SQRT5 = math.sqrt(5.0)
_SQRT3 = math.sqrt(3.0)


# --------------------------------------------------------------------------
# Scalar profiles psi(rho, theta) and their rho-derivatives, closed form
# (reference radial_basis_functions.jl:60-103)
# --------------------------------------------------------------------------


def _profile(kind: str, rho, theta, order: int):
    """psi (order 0), psi' (1) or psi'' (2) of `kind` at rho."""
    ell = theta[0]
    if kind == "matern52":
        c = _SQRT5 / ell
        s = c * rho
        e = torch.exp(-s)
        if order == 0:
            return (1.0 + s * (1.0 + s / 3.0)) * e
        if order == 1:
            return -(c / 3.0) * s * (1.0 + s) * e
        return -(c * c / 3.0) * (1.0 + s - s * s) * e
    if kind == "matern32":
        c = _SQRT3 / ell
        s = c * rho
        e = torch.exp(-s)
        if order == 0:
            return (1.0 + s) * e
        if order == 1:
            return -c * s * e
        return c * c * (s - 1.0) * e
    if kind == "matern12":
        e = torch.exp(-rho / ell)
        return e if order == 0 else (-e / ell if order == 1 else e / (ell * ell))
    if kind == "squared_exponential":
        l2 = ell * ell
        psi = torch.exp(-(rho * rho) / (2.0 * l2))
        if order == 0:
            return psi
        if order == 1:
            return -(rho / l2) * psi
        return (rho * rho / (l2 * l2) - 1.0 / l2) * psi
    if kind == "periodic":
        c1 = 2.0 / (ell * ell)
        w = math.pi / theta[1]
        u = w * rho
        psi = torch.exp(-c1 * torch.sin(u) ** 2)
        if order == 0:
            return psi
        s2u = torch.sin(2.0 * u)
        if order == 1:
            return -c1 * w * s2u * psi
        return (-2.0 * c1 * w * w * torch.cos(2.0 * u)
                + c1 * c1 * w * w * s2u * s2u) * psi
    raise ValueError(f"unsupported kernel kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    """A stationary RBF kernel: profile name + hyperparameter tensor.

    theta is (lengthscale,) for every kind but "periodic", whose theta is
    (lengthscale, period) (reference radial_basis_functions.jl:7-14).
    """

    theta: torch.Tensor
    kind: str = "matern52"

    def psi(self, rho):
        return _profile(self.kind, rho, self.theta, 0)

    def dpsi(self, rho):
        return _profile(self.kind, rho, self.theta, 1)

    def d2psi(self, rho):
        return _profile(self.kind, rho, self.theta, 2)

    def replace_theta(self, theta) -> "RBFKernel":
        return RBFKernel(theta, self.kind)

    def to(self, *, device, dtype) -> "RBFKernel":
        return RBFKernel(self.theta.to(device=device, dtype=dtype), self.kind)


def _make(kind, theta, device, dtype):
    return RBFKernel(torch.as_tensor(theta, dtype=dtype, device=device), kind)


def matern52(theta=(1.0,), *, device="cuda", dtype=torch.float64) -> RBFKernel:
    return _make("matern52", theta, device, dtype)


def matern32(theta=(1.0,), *, device="cuda", dtype=torch.float64) -> RBFKernel:
    return _make("matern32", theta, device, dtype)


def matern12(theta=(1.0,), *, device="cuda", dtype=torch.float64) -> RBFKernel:
    return _make("matern12", theta, device, dtype)


def squared_exponential(theta=(1.0,), *, device="cuda",
                        dtype=torch.float64) -> RBFKernel:
    return _make("squared_exponential", theta, device, dtype)


def periodic(theta=(1.0, 1.0), *, device="cuda", dtype=torch.float64) -> RBFKernel:
    return _make("periodic", theta, device, dtype)


# --------------------------------------------------------------------------
# Pointwise evaluations at a displacement r (..., d)
# --------------------------------------------------------------------------


def _safe_norm(r):
    """norm(r) over the last axis with a NaN-free gradient at r = 0.

    Double `where`: the gradient of sqrt at 0 is inf, and `where` routes
    0 * inf = NaN into the unselected branch's gradient unless the
    argument of sqrt itself is made safe first.
    """
    sq = torch.sum(r * r, dim=-1)
    pos = sq > 0.0
    return torch.sqrt(torch.where(pos, sq, 1.0)) * torch.where(pos, 1.0, 0.0)


def _radial_terms(k: RBFKernel, rho):
    """(safe rho, psi'(rho)/rho) with 0 at rho <= _EPS."""
    pos = rho > _EPS
    safe = torch.where(pos, rho, 1.0)
    return pos, safe, torch.where(pos, k.dpsi(safe) / safe, 0.0)


def kernel_value(k: RBFKernel, r):
    """psi(||r||) (reference eval_k, radial_basis_functions.jl:120)."""
    return k.psi(_safe_norm(r))


def kernel_grad(k: RBFKernel, r):
    """d/dr psi(||r||) = psi'(rho) r / rho, 0 at rho = 0 (eval_∇k)."""
    _, _, a = _radial_terms(k, _safe_norm(r))
    return a[..., None] * r


def kernel_hess(k: RBFKernel, r):
    """Hessian of psi(||r||); psi''(0) I at rho = 0 (eval_Hk)."""
    d = r.shape[-1]
    eye = torch.eye(d, dtype=r.dtype, device=r.device)
    pos, safe, a = _radial_terms(k, _safe_norm(r))
    rhat = r / safe[..., None]
    d2 = k.d2psi(safe)
    away = ((d2 - a)[..., None, None] * rhat[..., :, None] * rhat[..., None, :]
            + a[..., None, None] * eye)
    at0 = k.d2psi(torch.zeros((), dtype=r.dtype, device=r.device)) * eye
    return torch.where(pos[..., None, None], away, at0)


def hess_contraction(k: RBFKernel, x, X, coeff):
    """sum_n coeff_n Hess_x k(x - X_n), without an (N, d, d) tensor.

    Hess k(r) = b(rho) r r^T + a(rho) I with a = psi'/rho and
    b = (psi'' - a)/rho^2: one scalar reduction plus an (d, N) @ (N, d)
    product. x (..., d), X (..., N, d), coeff (..., N) -> (..., d, d).
    """
    R = x[..., None, :] - X
    sq = torch.sum(R * R, dim=-1)
    rho = torch.sqrt(torch.where(sq > 0.0, sq, 1.0)) * (sq > 0.0)
    pos, safe, a = _radial_terms(k, rho)
    b = torch.where(pos, (k.d2psi(safe) - a) / (safe * safe), 0.0)
    iso0 = k.d2psi(torch.zeros((), dtype=X.dtype, device=X.device))
    iso = torch.where(pos, a, iso0)
    d = X.shape[-1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    return (torch.sum(coeff * iso, dim=-1)[..., None, None] * eye
            + R.transpose(-1, -2) @ (R * (coeff * b)[..., None]))


def kernel_joint_block(k: RBFKernel, r):
    """Joint (f, grad f) prior covariance block [[k, -gk^T], [gk, -Hk]]
    (reference eval_Dk, radial_basis_functions.jl:152-159)."""
    kv = kernel_value(k, r)
    gk = kernel_grad(k, r)
    Hk = kernel_hess(k, r)
    top = torch.cat([kv[..., None], -gk], dim=-1)[..., None, :]
    bot = torch.cat([gk[..., :, None], -Hk], dim=-1)
    return torch.cat([top, bot], dim=-2)


# --------------------------------------------------------------------------
# Kernel-matrix assembly
# --------------------------------------------------------------------------


def eval_KXX(k: RBFKernel, X, noise=1e-6):
    """K(X, X) + noise I for X (..., N, d) (reference eval_KXX). The
    distances use `_safe_norm`: the same values, and a gradient with
    respect to X that is finite on the diagonal (a plain sqrt there gives
    0 * inf = NaN, which the explicit adjoint's vjp through X would carry)."""
    n = X.shape[-2]
    K = k.psi(_safe_norm(X[..., :, None, :] - X[..., None, :, :]))
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    # exact psi(0) on the diagonal (avoids sqrt-at-zero noise)
    K = torch.where(eye.bool(), k.psi(torch.zeros((), dtype=X.dtype,
                                                  device=X.device)), K)
    return K + noise * eye


def eval_KxX(k: RBFKernel, x, X):
    """k(x, X): x (..., d), X (..., N, d) -> (..., N) (reference eval_KxX)."""
    return kernel_value(k, x[..., None, :] - X)


def eval_grad_KxX(k: RBFKernel, x, X):
    """d/dx k(x, X): (..., N, d) (reference eval_∇KxX, transposed)."""
    return kernel_grad(k, x[..., None, :] - X)


# --------------------------------------------------------------------------
# Directional derivatives under perturbations of the data and of theta
# --------------------------------------------------------------------------


def eval_dKXX(k: RBFKernel, X, dX):
    """Directional derivative of K(X, X) for perturbations dX (..., N, d)
    of the points (reference eval_δKXX, radial_basis_functions.jl:210-228):
    grad k(X_i - X_j) . (dX_i - dX_j); 0 on the diagonal."""
    M = torch.sum(kernel_grad(k, X[..., :, None, :] - X[..., None, :, :])
                  * (dX[..., :, None, :] - dX[..., None, :, :]), dim=-1)
    eye = torch.eye(X.shape[-2], dtype=torch.bool, device=X.device)
    return torch.where(eye, 0.0, M)


def eval_dKxX(k: RBFKernel, x, X, dX):
    """Directional derivative of k(x, X) (..., N) when only X moves by dX
    (reference eval_δKxX, radial_basis_functions.jl:230-245)."""
    return torch.sum(kernel_grad(k, x[..., None, :] - X) * -dX, dim=-1)


def eval_dgrad_KxX(k: RBFKernel, x, X, dX):
    """Directional derivative of grad_x k(x, X) (..., N, d) when only X
    moves by dX (reference eval_δ∇KxX, radial_basis_functions.jl:247-262)."""
    return (kernel_hess(k, x[..., None, :] - X) @ -dX[..., None])[..., 0]


def eval_Dtheta_KXX(k: RBFKernel, X, dtheta):
    """Directional derivative of K(X, X) (no noise term) in the kernel
    hyperparameters, along dtheta (reference eval_Dθ_KXX,
    radial_basis_functions.jl:264-284): a forward-mode derivative of the
    profile at every pairwise distance (the diagonal's is at rho = 0)."""
    rho = _safe_norm(X[..., :, None, :] - X[..., None, :, :])
    dtheta = torch.as_tensor(dtheta, dtype=k.theta.dtype, device=k.theta.device)
    return torch.func.jvp(lambda th: _profile(k.kind, rho, th, 0), (k.theta,), (dtheta,))[1]
