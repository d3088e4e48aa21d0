"""Trust-region Newton solvers with a fixed number of iterations.

Port of `rollout_bo_tpu/rollout/trust_region.py`, the reference's dormant
trust-region layer (`optim.jl`): `solve_tr` (:9-51, the Gander / Golub /
Von Matt eigen-based subproblem with the hard case), `tr_newton`
(:68-114) and `tr_SR1` (:127-185). The live inner solver is the
projected Newton of `rollout/solvers.py`, as in the reference
(Optim.IPNewton); these exist for algorithm parity and as an alternative.
Every loop runs a fixed number of iterations with masked acceptance, and
the subproblem's Lagrange multiplier is found by bisection, so nothing
reads a value back to the host. Functions take one point (d,).
"""

from __future__ import annotations

import torch

__all__ = ["solve_tr", "tr_newton", "tr_sr1"]


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


def solve_tr(g, H, delta, *, bisect_iters: int = 40):
    """argmin_p g.p + p.H.p / 2 subject to ||p|| <= delta, via eigh.
    Returns (p, hit_boundary). Reference optim.jl:9-51."""
    d = g.shape[0]
    w, V = torch.linalg.eigh(H)
    gt = V.T @ g
    delta = torch.as_tensor(delta, dtype=g.dtype, device=g.device)

    def p_of(lam):
        return -(gt / (w + lam))

    # interior solution if H is PD and ||p(0)|| <= delta
    lam_min = w[0]
    p0 = p_of(0.0)
    interior_ok = (lam_min > 0.0) & (_norm(p0) <= delta)

    # otherwise bisection on lam in (max(0, -lam_min), hi]
    lo = torch.clamp(-lam_min, min=0.0) + 1e-12
    hi = lo + _norm(g) / torch.clamp(delta, min=1e-12) + torch.abs(w).max() + 1.0
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        too_long = _norm(p_of(mid)) > delta
        lo, hi = torch.where(too_long, mid, lo), torch.where(too_long, hi, mid)
    p_boundary = p_of(0.5 * (lo + hi))
    # Hard case (optim.jl:41-47): g is numerically orthogonal to the lowest
    # eigendirection, ||p(lam)|| stays below delta for every lam > -lam_min
    # and the bisection does not reach the boundary. Take the min-norm
    # limit at lam* = -lam_min (a pseudo-inverse over the other
    # eigendirections; like the reference, multiplicity > 1 uses only the
    # first) and add tau along the first eigenvector so that ||p|| = delta.
    denom = w - lam_min
    scale = torch.clamp(torch.abs(w).max(), min=1.0)
    safe = torch.where(torch.abs(denom) > 1e-10 * scale, denom, torch.inf)
    p_min_norm = -(gt / safe)
    tau = torch.sqrt(torch.clamp(delta**2 - torch.sum(p_min_norm**2), min=0.0))
    e1 = (torch.arange(d, device=g.device) == 0).to(g.dtype)
    hard = _norm(p_boundary) < 0.99 * delta
    p_boundary = torch.where(hard, p_min_norm + tau * e1, p_boundary)
    return V @ torch.where(interior_ok, p0, p_boundary), ~interior_ok


def _clip(x, lbs, ubs):
    if lbs is None:
        return x
    as_t = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return torch.clamp(x, as_t(lbs), as_t(ubs))


def tr_newton(value_grad_hess, x0, *, delta0=1.0, delta_max=10.0, iterations: int = 30,
              eta=0.1, lbs=None, ubs=None):
    """Trust-region Newton minimization (reference tr_newton, optim.jl:68-114).
    value_grad_hess(x) -> (f, g, H); box bounds by clipping. Returns (x, f)."""
    x = x0
    delta = torch.as_tensor(delta0, dtype=x0.dtype, device=x0.device)
    f = value_grad_hess(x0)[0]
    for _ in range(iterations):
        fx, g, H = value_grad_hess(x)
        p, _ = solve_tr(g, H, delta)
        xn = _clip(x + p, lbs, ubs)
        fn = value_grad_hess(xn)[0]
        pred = -(torch.dot(g, p) + 0.5 * torch.dot(p, H @ p))
        rho = (fx - fn) / torch.clamp(pred, min=1e-300)
        grow = (rho > 0.75) & (_norm(p) > 0.9 * delta)
        delta = torch.where(rho < 0.25, 0.25 * delta,
                            torch.where(grow, torch.clamp(2.0 * delta, max=delta_max), delta))
        accept = (rho > eta) & torch.isfinite(fn)
        x = torch.where(accept, xn, x)
        f = torch.where(accept, fn, fx)
    return x, f


def tr_sr1(value_grad, x0, *, delta0=1.0, iterations: int = 40, eta=1e-4,
           lbs=None, ubs=None):
    """SR1 quasi-Newton trust-region minimization (optim.jl:127-185).
    value_grad(x) -> (f, g); the Hessian is a symmetric-rank-1 estimate."""
    d = x0.shape[0]
    x = x0
    B = torch.eye(d, dtype=x0.dtype, device=x0.device)
    delta = torch.as_tensor(delta0, dtype=x0.dtype, device=x0.device)
    f, g = value_grad(x0)
    for _ in range(iterations):
        p, _ = solve_tr(g, B, delta)
        xn = x + p
        if lbs is not None:
            xn = _clip(xn, lbs, ubs)
            p = xn - x
        fn, gn = value_grad(xn)
        pred = -(torch.dot(g, p) + 0.5 * torch.dot(p, B @ p))
        rho = (f - fn) / torch.clamp(pred, min=1e-300)
        # the SR1 update with the standard safeguard
        r = (gn - g) - B @ p
        denom = torch.dot(r, p)
        ok = torch.abs(denom) > 1e-8 * _norm(r) * _norm(p)
        B = torch.where(ok, B + torch.outer(r, r) / torch.where(ok, denom, 1.0), B)
        delta = torch.where(rho < 0.25, 0.25 * delta,
                            torch.where(rho > 0.75, 2.0 * delta, delta))
        accept = (rho > eta) & torch.isfinite(fn)
        x = torch.where(accept, xn, x)
        f = torch.where(accept, fn, f)
        g = torch.where(accept, gn, g)
    return x, f
