"""Base acquisition decision rules g(mu, sigma, theta, fmini) and partials.

Port of `rollout_bo_tpu/models/decision_rules.py` (reference
`decision_rules.jl`). The JAX package derives every partial with
`jax.grad`; the TPU kernel (`rollout_bo_tpu/ops/pallas_newton.py:261-381`)
writes the value and the five partials the Newton solver needs (d/dmu,
d/dsigma, d2/dmu2, d2/dsigma2, d2/dmu dsigma) in closed form, with the
masks that `jax.grad` of the guarded forms produces. Those closed forms
live here, once: the surrogate's acquisition derivatives, the solver's
plain version (`ops/newton_lanes.py`) and, line for line, the CUDA kernel
(`csrc/newton_lanes.cu`) use them. Autograd through the first partials
gives the second-order terms the implicit-function-theorem gradient needs.

All rules are *maximized*. Every function is elementwise over any lane
shape; `th` is theta[..., 0] per lane.

LogEI / LogPOI: the direct forms cancel for z < -1, so their tails are
built from two Mills-ratio corrections in t = 1/|z|,

    c(t) = log(|z| Phi(z)/phi(z)),   q(t) = log((1 - |z| Phi/phi)/t^2),

each a degree-12 polynomial on t in (0.1, 1] and an asymptotic series
below (coefficients from the JAX kernel, max abs error ~3e-7 / 1.6e-6).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["DecisionRule", "EI", "LogEI", "POI", "LogPOI", "LCB",
           "RandomAcquisition", "RULES", "rule_value", "rule_partials"]

# |z| beyond this is saturated (tails < 1e-190); keeps the autodiff chains
# finite in float32 on huge-range surfaces such as trid10d (|f| ~ 1e5)
_Z_CLAMP = 30.0
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

_C_COEF = (
    7.357126067616959e-05, -0.003030332555429463, -0.9460333971085013,
    -0.5452875891075231, 5.917213284650515, -13.330680039626309,
    16.136072259524276, -9.091448506887286, -3.269217078293205,
    10.285783857545367, -8.302420084484648, 3.252465210828019,
    -0.5255742944808028,
)
_Q_COEF = (
    0.0003553685708074239, -0.015378764422016716, -2.7095052943101523,
    -3.149139485836574, 31.99608533256913, -93.6622237838578,
    170.23164452827305, -214.17068623084106, 190.2244261160476,
    -117.22290850693899, 47.60922667911587, -11.413227140771019,
    1.2151486419508726,
)


def _cdf(z):
    # erfc keeps the lower tail's relative digits; torch.special.ndtr on the
    # CPU is accurate only to ~1e-16 absolute there (2e-6 relative at
    # z = -7) and returns 0 below z ~ -8.3, where the JAX package's norm.cdf
    # and the kernel's normcdf still resolve Phi(z) ~ 1e-17
    return 0.5 * torch.special.erfc(-z * _INV_SQRT2)


def _pdf(z):
    return _INV_SQRT2PI * torch.exp(-0.5 * z * z)


def _poly(t, coef):
    acc = torch.full_like(t, coef[-1])
    for cf in coef[-2::-1]:
        acc = acc * t + cf
    return acc


def _mills_c(t):
    t2 = t * t
    series = torch.log1p(t2 * (-1.0 + t2 * (3.0 + t2 * (-15.0 + t2 * 105.0))))
    return torch.where(t > 0.1, _poly(t, _C_COEF), series)


def _mills_q(t):
    t2 = t * t
    series = torch.log1p(t2 * (-3.0 + t2 * (15.0 + t2 * (-105.0 + t2 * 945.0))))
    return torch.where(t > 0.1, _poly(t, _Q_COEF), series)


def rule_value(name: str, mu, sigma, th, fmini, sigma_tol: float):
    """g(mu, sigma) of rule `name` (reference decision_rules.jl:84-135)."""
    if name == "LCB":
        return th * sigma - mu
    if name == "Random":
        # dispatched by name in the solver (reference decision_rules.jl:129-135)
        return torch.zeros_like(mu)
    s = torch.clamp(sigma, min=sigma_tol)
    imp = fmini - mu - th
    if name in ("EI", "POI"):
        z = torch.clamp(imp / s, -_Z_CLAMP, _Z_CLAMP)
        val = imp * _cdf(z) + s * _pdf(z) if name == "EI" else _cdf(z)
        return torch.where(sigma < sigma_tol, 0.0, val)
    z = imp / s  # the log rules are unclamped
    nz = torch.clamp(-z, min=1.0)
    t = 1.0 / nz
    log_phi = -0.5 * z * z - _HALF_LOG_2PI
    if name == "LogPOI":
        direct = torch.log(torch.clamp(_cdf(z), min=1e-30))
        tail = log_phi - torch.log(nz) + _mills_c(t)
        val = torch.where(z >= -1.0, direct, tail)
        # below any representable candidate (decision_rules._logpoi)
        guard = -0.25 * torch.finfo(mu.dtype).max
        return torch.where(sigma < sigma_tol, guard, val)
    if name == "LogEI":
        # log s + log g(z), g = z Phi + phi; no sigma branch: s == sigma_tol
        zs = torch.clamp(z, min=-1.0)
        g_direct = zs * _cdf(zs) + _pdf(zs)
        direct = torch.log(torch.clamp(g_direct, min=torch.finfo(mu.dtype).tiny))
        tail = log_phi + 2.0 * torch.log(t) + _mills_q(t)
        return torch.log(s) + torch.where(z >= -1.0, direct, tail)
    raise ValueError(f"unsupported decision rule {name!r}")


def rule_partials(name: str, mu, sigma, th, fmini, sigma_tol: float):
    """(gmu, gsig, gmumu, gsigsig, gmusig) with the guard masks of
    `jax.grad` through the JAX package's rules: beyond the z clamp the
    z-chains die, below sigma_tol the s-chains die."""
    if name == "LCB":
        one = torch.ones_like(mu)
        zero = torch.zeros_like(mu)
        return -one, th * one, zero, zero, zero
    if name == "Random":
        zero = torch.zeros_like(mu)
        return zero, zero, zero, zero, zero
    s = torch.clamp(sigma, min=sigma_tol)
    s2 = s * s
    dsig = (sigma > sigma_tol).to(mu.dtype)
    guard = (sigma >= sigma_tol).to(mu.dtype)
    zraw = (fmini - mu - th) / s
    if name in ("EI", "POI"):
        z = torch.clamp(zraw, -_Z_CLAMP, _Z_CLAMP)
        live = (torch.abs(zraw) < _Z_CLAMP).to(mu.dtype)
        phi = _pdf(z)
        if name == "EI":
            # d/dmu = -Phi(z) inside and outside the clamp; d/ds = phi(z)
            parts = (-_cdf(z), phi * dsig, live * phi / s,
                     live * z * z * phi / s * dsig * dsig,
                     live * z * phi / s * dsig)
        else:
            parts = (-live * phi / s, -live * z * phi / s * dsig,
                     -live * z * phi / s2,
                     live * z * (2.0 - z * z) * phi / s2 * dsig * dsig,
                     live * (1.0 - z * z) * phi / s2 * dsig)
        return tuple(p * guard for p in parts)
    z = zraw
    direct = z >= -1.0
    nz = torch.clamp(-z, min=1.0)
    t = 1.0 / nz
    c = _mills_c(t)
    if name == "LogPOI":
        # r = phi/Phi = d/dz log Phi; r' = -z r - r^2 = r z expm1(-c) in
        # the tail (factored: no cancellation of ~z^2 terms)
        r_direct = _pdf(z) / torch.clamp(_cdf(z), min=1e-30)
        r = torch.where(direct, r_direct, nz * torch.exp(-c))
        rp = torch.where(direct, -z * r - r * r, r * z * torch.expm1(-c))
        parts = (-r / s, -z * r / s * dsig, rp / s2,
                 (2.0 * z * r + z * z * rp) / s2 * dsig * dsig,
                 (z * rp + r) / s2 * dsig)
        return tuple(p * guard for p in parts)
    if name == "LogEI":
        # u = Phi/g, w = phi/g, u' = w - u^2; the value has no sigma guard
        # branch, so only the s-chains freeze below sigma_tol
        zs = torch.clamp(z, min=-1.0)
        g_direct = torch.clamp(zs * _cdf(zs) + _pdf(zs), min=1e-30)
        u_direct = _cdf(zs) / g_direct
        w_direct = _pdf(zs) / g_direct
        q = _mills_q(t)
        u = torch.where(direct, u_direct, torch.exp(c - q) / t)
        up = torch.where(direct, w_direct - u_direct * u_direct,
                         -torch.exp(-q) / (t * t) * torch.expm1(2.0 * c - q))
        return (-u / s, (1.0 - z * u) / s * dsig, up / s2,
                (2.0 * z * u + z * z * up - 1.0) / s2 * dsig * dsig,
                (z * up + u) / s2 * dsig)
    raise ValueError(f"unsupported decision rule {name!r}")


@dataclasses.dataclass(frozen=True)
class DecisionRule:
    """A named acquisition rule (reference DecisionRule, decision_rules.jl:4-34).

    `solve_f_tol` / `solve_x_tol` request IPNewton-style loose acceptance
    from the inner Newton solver (reference rbf_optim.jl:26-30): a start
    freezes once its relative value improvement or its step norm drops
    below tolerance. 0.0 runs every iteration. POI defaults to the
    reference's 1e-3 because its regret depends on the loose stop
    (PARITY.md "POI saturation").
    """

    name: str = "EI"
    sigma_tol: float = 1e-8
    solve_f_tol: float = 0.0
    solve_x_tol: float = 0.0

    def __call__(self, mu, sigma, theta, fmini):
        return rule_value(self.name, mu, sigma, theta[..., 0], fmini,
                          self.sigma_tol)

    def partials(self, mu, sigma, theta, fmini):
        """(dg/dmu, dg/dsigma, d2g/dmu2, d2g/dsigma2, d2g/dmu dsigma)."""
        return rule_partials(self.name, mu, sigma, theta[..., 0], fmini,
                             self.sigma_tol)


def EI(sigma_tol: float = 1e-8) -> DecisionRule:
    return DecisionRule("EI", sigma_tol)


def LogEI(sigma_tol: float = 1e-8) -> DecisionRule:
    return DecisionRule("LogEI", sigma_tol)


def POI(sigma_tol: float = 1e-8, *, solve_f_tol: float = 1e-3,
        solve_x_tol: float = 1e-3) -> DecisionRule:
    return DecisionRule("POI", sigma_tol, solve_f_tol, solve_x_tol)


def LogPOI(sigma_tol: float = 1e-8) -> DecisionRule:
    return DecisionRule("LogPOI", sigma_tol)


def LCB() -> DecisionRule:
    return DecisionRule("LCB")


def RandomAcquisition() -> DecisionRule:
    """Random search: `solvers.multistart_maximize` draws a uniform point
    for it instead of solving (reference rbf_optim.jl:76-79)."""
    return DecisionRule("Random")


RULES = {"EI": EI, "LogEI": LogEI, "POI": POI, "LogPOI": LogPOI, "LCB": LCB,
         "Random": RandomAcquisition}
