"""The benchmark's plain reference of the rollout acquisition and its solve.

What the configuration states, written out in plain PyTorch on the
reference's own GP (`gp.py`), over lanes of exact-size tensors:

- the inner solve: a projected-Newton ascent of EI from every start of
  every lane (the active set at the box faces, a damped Newton direction,
  nine halvings along it and along a gradient step, a strictly better
  candidate only), `iterations` times; the best start per lane, the first
  of tied ones;
- a trajectory: the fantasy draw at x0, then h times the inner argmax on
  the conditioned GP, its draw, the condition; the reward
  max(f_min - min_j y_j, 0) with f_min over the base observations;
- its gradient in x0 by autograd, each inner argmax entering through the
  implicit-function-theorem step x* - H^{-1}(g - g.detach()) on its free
  coordinates, where -H is positive definite with margin;
- the Monte-Carlo estimate (mean, and the ddof-1 sd over the trajectories)
  at each of R points, M trajectories each;
- the outer solve: Adam ascent from every restart with the eswavs stop,
  the values at the final points, and the first best restart.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import gp as G

BACKTRACK = 9
HTOL = 1e-4
IFT_BOUNDARY_TOL = 1e-8


def _jitter(dtype):
    return 1e-10 if dtype == torch.float64 else 1e-6


def _spd_solve(A, b):
    """A^{-1} b for symmetric A by Cholesky, NaN where A is not PD."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = info != 0
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    x = torch.cholesky_solve(b[..., None], torch.where(bad[..., None, None], eye, L))[..., 0]
    return torch.where(bad[..., None], torch.nan, x)


def _finite_or_neg_inf(v):
    return torch.where(torch.isfinite(v), v, -math.inf)


def inner_solve(gp: G.GP, fmini, xstarts, lbs, ubs, *, iterations: int, ridge: float = 1e-8):
    """(x (L, d), value (L,)): the multistart projected-Newton argmax of EI
    on each lane's GP (lanes L), from the starts xstarts (S, d)."""
    dt, dev = xstarts.dtype, xstarts.device
    L = gp.X.shape[0]
    S, d = xstarts.shape
    scale = torch.max(ubs - lbs)
    btol = 1e-9 * scale
    eye = torch.eye(d, dtype=dt, device=dev)
    fm1, fm2 = fmini[:, None], fmini[:, None, None]
    steps = 0.5 ** torch.arange(BACKTRACK, dtype=dt, device=dev)

    x = torch.clamp(xstarts, lbs, ubs).expand(L, S, d)
    for _ in range(iterations):
        a0, g, H = G.ei_grad_hess(gp, x, fm1, 1)
        lo = (x <= lbs + btol) & (g < 0.0)
        hi = (x >= ubs - btol) & (g > 0.0)
        free = (~(lo | hi)).to(dt)
        gf = g * free
        A = -(H * free[..., :, None] * free[..., None, :]) + eye * (1.0 - free)[..., :, None]
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        smax = torch.clamp(torch.amax(torch.abs(diag), dim=-1), min=ridge)
        off = torch.sum(torch.abs(A), dim=-1) - torch.abs(diag)
        tau = torch.clamp(torch.amax(off - diag, dim=-1), min=0.0) + ridge + 1e-6 * smax

        def attempt(t):
            p = _spd_solve(A + t[..., None, None] * eye, gf)
            return p, torch.all(torch.isfinite(p), dim=-1) & (torch.sum(p * gf, dim=-1) > 0.0)

        p1, ok1 = attempt(torch.full_like(tau, ridge))
        p2, ok2 = attempt(tau)
        p = torch.where(ok1[..., None], p1, torch.where(ok2[..., None], p2, gf / smax[..., None]))
        p = p * free
        bad = (~torch.all(torch.isfinite(p), dim=-1)) | (torch.sum(p * gf, dim=-1) <= 0.0)
        gstep = gf / torch.clamp(torch.linalg.vector_norm(gf, dim=-1), min=1e-12)[..., None] \
            * (0.1 * scale)
        p = torch.where(bad[..., None], gstep, p)
        pn = torch.linalg.vector_norm(p, dim=-1)
        p = p * torch.clamp(scale / torch.clamp(pn, min=1e-30), max=1.0)[..., None]
        cands = torch.cat([x[..., None, :] + steps[:, None] * p[..., None, :],
                           x[..., None, :] + steps[:, None] * gstep[..., None, :]], dim=-2)
        cands = torch.clamp(cands, lbs, ubs)                       # (L, S, 18, d)
        vals = _finite_or_neg_inf(G.ei(*G.posterior_value(gp, cands, 2), fm2))
        best = torch.argmax(vals, dim=-1, keepdim=True)            # the first of tied ones
        vbest = torch.gather(vals, -1, best)[..., 0]
        xbest = torch.gather(cands, -2, best[..., None].expand(L, S, 1, d))[..., 0, :]
        x = torch.where((vbest > _finite_or_neg_inf(a0))[..., None], xbest, x)
    v = _finite_or_neg_inf(G.ei(*G.posterior_value(gp, x, 1), fm1))
    j = torch.argmax(v, dim=-1, keepdim=True)
    xb = torch.gather(x, 1, j[..., None].expand(L, 1, d))[:, 0]
    vb = torch.gather(v, 1, j)[:, 0]
    return torch.where(torch.isfinite(vb)[:, None], xb, torch.zeros_like(xb)), vb


def _detached(gp: G.GP) -> G.GP:
    return G.GP(gp.X.detach(), gp.y.detach(), gp.Li.detach(), gp.c.detach(), gp.ell, gp.noise)


def _ift(gp: G.GP, fmini, xstar, lbs, ubs):
    """xstar with the derivative the implicit function theorem gives it
    through gp and fmini (its value is xstar's)."""
    _, g = G.ei_grad(gp, xstar, fmini, 0)
    _, _, H = G.ei_grad_hess(_detached(gp), xstar, fmini.detach(), 0)
    dt = H.dtype
    free = ((xstar > lbs + IFT_BOUNDARY_TOL) & (xstar < ubs - IFT_BOUNDARY_TOL)).to(dt)
    eye = torch.eye(H.shape[-1], dtype=dt, device=H.device)
    A = -(H * free[..., :, None] * free[..., None, :]) + torch.diag_embed(1.0 - free)
    s = torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    _, info = torch.linalg.cholesky_ex(A - HTOL * s[..., None, None] * torch.diag_embed(free))
    ok = (info == 0) & (s > 1e-12)
    A = torch.where(ok[..., None, None], A, eye)
    gm = g * free
    delta = _spd_solve(A, -(gm - gm.detach())) * free
    keep = torch.all(torch.isfinite(delta), dim=-1) & ok
    return xstar - torch.where(keep[..., None], delta, torch.zeros_like(delta))


class Problem(NamedTuple):
    """One acquisition's inputs, in the reference's dtype and device."""

    X: torch.Tensor          # (n, d) observations
    y: torch.Tensor          # (n,)
    ell: float
    noise: float
    lbs: torch.Tensor        # (d,)
    ubs: torch.Tensor
    xstarts: torch.Tensor    # (S, d) inner starts
    z: torch.Tensor          # (M, d + 1, h + 1) normals; column 0 drives the draws
    iterations: int          # inner Newton iterations

    @property
    def horizon(self) -> int:
        return self.z.shape[-1] - 1


def rewards(prob: Problem, x0, z0s):
    """The reward of the trajectory of each lane from x0 (L, d), with the
    normals z0s (L, h + 1) of its draws."""
    base = G.fit(prob.X, prob.y, prob.ell, prob.noise)
    L = x0.shape[0]
    gp = G.GP(base.X.expand(L, *base.X.shape), base.y.expand(L, *base.y.shape),
              base.Li.expand(L, *base.Li.shape), base.c.expand(L, *base.c.shape),
              base.ell, base.noise)
    fbase = torch.amin(prob.y)
    jit = _jitter(x0.dtype)
    y = G.draw(gp, x0, z0s[:, 0], jit)
    ys = [y]
    gp = G.append(gp, x0, y)
    fview = torch.minimum(fbase, y)
    for j in range(1, prob.horizon + 1):
        xstar, _ = inner_solve(_detached(gp), fview.detach(), prob.xstarts, prob.lbs, prob.ubs,
                               iterations=prob.iterations)
        xj = _ift(gp, fview, xstar, prob.lbs, prob.ubs) if x0.requires_grad else xstar
        y = G.draw(gp, xj, z0s[:, j], jit)
        ys.append(y)
        gp = G.append(gp, xj, y)
        fview = torch.minimum(fview, y)
    best = torch.amin(torch.stack(ys, dim=-1), dim=-1)
    return torch.maximum(fbase - best, torch.zeros((), dtype=x0.dtype, device=x0.device))


class Estimate(NamedTuple):
    mu: torch.Tensor                 # (R,)
    std: torch.Tensor                # (R,)
    grad: torch.Tensor | None        # (R, d)
    std_grad: torch.Tensor | None    # (R, d)
    count: int                       # M, the trajectories of each point


def estimate(prob: Problem, xs, *, with_gradients: bool) -> Estimate:
    """The Monte-Carlo rollout acquisition at each point of xs (R, d): the
    M trajectories of prob.z from each."""
    R, d = xs.shape
    M = prob.z.shape[0]
    x0 = xs.detach()[:, None, :].expand(R, M, d).reshape(R * M, d).clone()
    z0s = prob.z[:, 0, :][None].expand(R, M, prob.horizon + 1).reshape(R * M, -1)
    if not with_gradients:
        with torch.no_grad():
            r = rewards(prob, x0, z0s).reshape(R, M)
        return Estimate(r.mean(-1), r.std(-1, correction=1), None, None, M)
    x0.requires_grad_(True)
    with torch.enable_grad():
        r = rewards(prob, x0, z0s)
        (gx,) = torch.autograd.grad(r.sum(), x0)
    r, gx = r.detach().reshape(R, M), gx.reshape(R, M, d)
    return Estimate(r.mean(-1), r.std(-1, correction=1), gx.mean(1), gx.std(1, correction=1),
                    M)


def eswavs(grad, var_grad, sample_size: int):
    """True where the eswavs statistic stops a restart."""
    ratio = torch.sum(grad ** 2 / torch.clamp(var_grad, min=torch.finfo(var_grad.dtype).tiny),
                      dim=-1)
    return (1.0 - (sample_size / grad.shape[-1]) * ratio) > 0.0


class Solve(NamedTuple):
    x: torch.Tensor          # (d,) the winner
    value: torch.Tensor      # () its value
    iterations: int


def solve(prob: Problem, restarts, *, max_iters: int, lr: float) -> Solve:
    """Adam ascent (0.9, 0.999, 1e-8) of the estimate from every restart,
    each frozen once eswavs stops it and kept in the box; at most
    max_iters iterations, fewer once every restart has stopped; then the
    values at the final points and the first best restart."""
    xs = restarts.clone()
    m = torch.zeros_like(xs)
    v = torch.zeros_like(xs)
    done = torch.zeros(xs.shape[0], dtype=torch.bool, device=xs.device)
    M = prob.z.shape[0]
    it = 0
    while it < max_iters:
        est = estimate(prob, xs, with_gradients=True)
        done = done | eswavs(est.grad, est.std_grad ** 2, M)
        it += 1
        m = 0.9 * m + 0.1 * est.grad
        v = 0.999 * v + 0.001 * est.grad * est.grad
        step = lr * (m / (1 - 0.9 ** it)) / (torch.sqrt(v / (1 - 0.999 ** it)) + 1e-8)
        xs = torch.where(done[:, None], xs, torch.clamp(xs + step, prob.lbs, prob.ubs))
        if bool(done.all()):
            break
    vals = estimate(prob, xs, with_gradients=False).mu
    j = int(torch.argmax(vals))
    return Solve(xs[j], vals[j], it)
