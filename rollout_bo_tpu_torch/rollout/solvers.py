"""Inner (myopic) acquisition maximization on the rollout hot path.

Port of `rollout_bo_tpu/rollout/solvers.py::maximize_hot`. Every lane of
the rollout (restart x MC trajectory) carries its own fantasy GP; the
lanes are flattened into one batch and solved by one call of
`ops/newton_lanes.py::newton_solve_lanes`: the CUDA kernel for tensors on
the card, its plain version for CPU tensors. Each lane passes its state's
Li = L^{-1} as it is; the lane solver picks the form of the variance from
the dtype, as the JAX package routes it (`newton_lanes._lane_matrix`):
float32 forms K^{-1} = Li^T Li once per call with one batched matmul, as
the JAX package's `pallas_newton.get_solver.flat_impl` does, and float64
computes k0 - |Li k|^2, as its XLA solver does.

`multistart_maximize`, the BO loops' solver on one surrogate, is the same
lane solver called with ONE lane and S starts. The lane solver returns
each lane's best start only; the per-start `xs` / `values` of the JAX
package's `SolveResult` are solved when first read, one start per call.

A cost-aware rule (`rule.cost` is not None) never reaches the lane solver,
which has no cost channel: it goes to `newton_solve_batch`, the JAX
package's Li-formulated solver, written here as batched torch over
lanes + (S,) starts and evaluating the acquisition (cost included) through
`surrogate.acquisition_value_grad_hess`. The routing checks `rule.cost`
before the rule's name: a `CostAwareRule` keeps its base rule's name.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import newton_lanes, small_chol

__all__ = ["supported", "newton_solve_batch", "maximize_hot", "multistart_maximize",
           "random_point", "SolveResult"]

_BACKTRACK_STEPS = 9  # trial step sizes 1, 1/2, ..., 1/2^8 along each direction


class SolveResult:
    """`multistart_maximize`'s result, with the fields of the JAX package's:
    x (d,) the argmax over the starts, value () the acquisition there, xs
    (S, d) each start's solution and values (S,) its value (non-finite ->
    -inf). Where the lane solver took the solve, xs and values are solved
    on first read by `per_start()` (S more solver calls, one start each),
    so that a caller that reads only x and value, as the BO loops do, makes
    one solver call."""

    def __init__(self, x, value, per_start: Callable[[], tuple]):
        self.x, self.value = x, value
        self._per_start = per_start

    @functools.cached_property
    def _xs_values(self):
        return self._per_start()

    @property
    def xs(self) -> torch.Tensor:
        return self._xs_values[0]

    @property
    def values(self) -> torch.Tensor:
        return self._xs_values[1]


def supported(kind: str, rule: DecisionRule) -> bool:
    """Whether the lane solver covers this kernel family and rule."""
    return getattr(rule, "cost", None) is None and newton_lanes.supported(kind, rule.name)


def _lead(state: sg.SurrogateState, theta):
    return torch.broadcast_shapes(state.X.shape[:-2], state.Li.shape[:-2],
                                  state.c.shape[:-1], state.n.shape, theta.shape[:-1])


def _insert_axes(state: sg.SurrogateState, k: int) -> sg.SurrogateState:
    """The state with k unit axes after its lane axes, so that it
    broadcasts against points of shape lanes + (k axes) + (d,)."""
    def at(t, tail):
        i = t.dim() - tail
        return t.reshape(t.shape[:i] + (1,) * k + t.shape[i:])
    return state._replace(X=at(state.X, 2), y=at(state.y, 1), L=at(state.L, 2),
                          c=at(state.c, 1), n=at(state.n, 0), Li=at(state.Li, 2))


def _clipped_newton_direction(g, H, ridge):
    """Ascent direction from damped -H, batched over the leading axes.

    Two Cholesky attempts: the undamped system -H + ridge I, then a
    Gershgorin-certified shift tau_g = max(0, max_i(offdiag row sum -
    diag)) that makes -H + tau_g I positive definite. The least damped
    finite ascent direction wins; a scaled gradient is the last resort.
    """
    d = g.shape[-1]
    A = -H
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.clamp(torch.amax(torch.abs(diag), dim=-1), min=ridge)
    off = torch.sum(torch.abs(A), dim=-1) - torch.abs(diag)
    tau_g = torch.clamp(torch.amax(off - diag, dim=-1), min=0.0) + ridge + 1e-6 * s
    eye = torch.eye(d, dtype=g.dtype, device=g.device)

    def solve(tau):
        p = small_chol.spd_solve_small(A + tau[..., None, None] * eye, g)
        return p, torch.all(torch.isfinite(p), dim=-1) & (torch.sum(p * g, dim=-1) > 0.0)

    p1, ok1 = solve(torch.full_like(tau_g, ridge))
    p2, ok2 = solve(tau_g)
    return torch.where(ok1[..., None], p1,
                       torch.where(ok2[..., None], p2, g / s[..., None]))


def newton_solve_batch(state: sg.SurrogateState, rule: DecisionRule, theta, lbs, ubs,
                       xstarts, *, iterations: int = 12, ridge: float = 1e-8):
    """Projected-Newton ascent from every start of every lane at once (the
    JAX package's `newton_solve_batch`, its vmap over starts and lanes
    written as broadcasting).

    `state` and `theta` (..., p) carry the lane axes; xstarts (S, d) are
    shared by the lanes. Returns (xs (..., S, d), values (..., S)): each
    start's solution and acquisition value, non-finite values mapped to
    -inf. Per iteration: the value, gradient and Hessian; the active-set
    reduction at the box faces; the Gershgorin-damped Newton direction and
    a gradient step, the step capped at the box width; 9 backtracking
    sizes along each direction, all 18 candidates evaluated in one call;
    a start moves only to a strictly better candidate. `rule.solve_f_tol`
    / `solve_x_tol` > 0 freeze a start once its relative improvement or
    step falls below them (reference rbf_optim.jl:26-30).
    """
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    lbs, ubs, theta, xstarts = as_t(lbs), as_t(ubs), as_t(theta), as_t(xstarts)
    S, d = xstarts.shape[-2:]
    lead = _lead(state, theta)
    st1, st2 = _insert_axes(state, 1), _insert_axes(state, 2)
    th1, th2 = theta[..., None, :], theta[..., None, None, :]
    scale = torch.max(ubs - lbs)
    boundary_tol = 1e-9 * scale
    f_tol = float(getattr(rule, "solve_f_tol", 0.0) or 0.0)
    x_tol = float(getattr(rule, "solve_x_tol", 0.0) or 0.0)
    loose = f_tol > 0.0 or x_tol > 0.0
    eye = torch.eye(d, dtype=dt, device=dev)
    ts = 0.5 ** torch.arange(_BACKTRACK_STEPS, dtype=dt, device=dev)

    def one_iteration(x):
        a, g, H = sg.acquisition_value_grad_hess(st1, rule, x, th1)
        act_lo = (x <= lbs + boundary_tol) & (g < 0.0)
        act_hi = (x >= ubs - boundary_tol) & (g > 0.0)
        free = (~(act_lo | act_hi)).to(dt)
        gf = g * free
        Hf = H * free[..., :, None] * free[..., None, :] - eye * (1.0 - free)[..., :, None]
        p = _clipped_newton_direction(gf, Hf, ridge) * free
        bad = (~torch.all(torch.isfinite(p), dim=-1)) | (torch.sum(p * gf, dim=-1) <= 0.0)
        gnorm = torch.sqrt(torch.sum(gf * gf, dim=-1))
        gstep = gf / torch.clamp(gnorm, min=1e-12)[..., None] * (0.1 * scale)
        p = torch.where(bad[..., None], gstep, p)
        pnorm = torch.sqrt(torch.sum(p * p, dim=-1))
        p = p * torch.clamp(scale / torch.clamp(pnorm, min=1e-300), max=1.0)[..., None]
        steps = ts[:, None]
        cands = torch.cat([x[..., None, :] + steps * p[..., None, :],
                           x[..., None, :] + steps * gstep[..., None, :]], dim=-2)
        cands = torch.clamp(cands, lbs, ubs)                 # (..., S, 18, d)
        vals = newton_lanes._neg_inf_nonfinite(sg.acquisition(st2, rule, cands, th2))
        a0 = newton_lanes._neg_inf_nonfinite(a)
        best = torch.argmax(vals, dim=-1, keepdim=True)
        vbest = torch.gather(vals, -1, best)[..., 0]
        xbest = torch.gather(cands, -2, best[..., None].expand(best.shape + (d,)))[..., 0, :]
        xn = torch.where((vbest > a0)[..., None], xbest, x)
        return xn, a0, vbest

    x = torch.clamp(xstarts, lbs, ubs).expand(lead + (S, d))
    frozen = torch.zeros(lead + (S,), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        xn, a0, vbest = one_iteration(x)
        if loose:
            improvement = torch.clamp(vbest - a0, min=0.0)
            small_f = improvement <= f_tol * (torch.abs(a0) + f_tol)
            small_x = torch.sqrt(torch.sum((xn - x) ** 2, dim=-1)) <= x_tol
            xn = torch.where(frozen[..., None], x, xn)
            frozen = frozen | small_f | small_x
        x = xn
    return x, newton_lanes._neg_inf_nonfinite(sg.acquisition(st1, rule, x, th1))


def maximize_hot(state: sg.SurrogateState, rule: DecisionRule, theta, lbs, ubs,
                 xstarts, *, iterations: int = 12):
    """(xstar (..., d), value (...)) multistart argmax for every lane.

    `state` and `theta` (..., p) carry the lane axes; the bounds and the
    S starts (S, d) are shared. Nothing here is differentiated. A rule with
    a cost goes to `newton_solve_batch`, whatever its name; every other
    rule to the lane solver (the CUDA kernel for CUDA tensors), which takes
    each lane's Li as the state holds it.
    """
    if getattr(rule, "cost", None) is not None:
        with torch.no_grad():
            xs, vs = newton_solve_batch(state, rule, theta.detach(), lbs, ubs, xstarts,
                                        iterations=iterations)
            best = torch.argmax(vs, dim=-1, keepdim=True)      # first start wins a tie
            x = torch.gather(xs, -2, best[..., None].expand(best.shape + xs.shape[-1:]))
            return x[..., 0, :], torch.gather(vs, -1, best)[..., 0]
    kind = state.kernel.kind
    if not supported(kind, rule):
        raise NotImplementedError(f"no lane solver for ({kind!r}, {rule.name!r})")
    cap, d = state.capacity, state.dim
    lead = _lead(state, theta)

    def flat(t, tail=()):
        return t.detach().expand(lead + tail).reshape((-1,) + tail).contiguous()

    with torch.no_grad():
        kth = state.kernel.theta.detach()
        period = kth[1] if kind == "periodic" else torch.ones_like(kth[0])
        xs, vs = newton_lanes.newton_solve_lanes(
            flat(state.X, (cap, d)), flat(state.Li, (cap, cap)), flat(state.c, (cap,)),
            flat(state.n), flat(sg.get_active_minimum(state)), flat(theta[..., 0]),
            kth[0], lbs, ubs, xstarts, period,
            kind=kind, rule=rule.name, iterations=iterations,
            sigma_tol=rule.sigma_tol, f_tol=float(rule.solve_f_tol),
            x_tol=float(rule.solve_x_tol),
        )
    return xs.reshape(lead + (d,)), vs.reshape(lead)


def random_point(lbs, ubs, u):
    """The Random rule's point in the box [lbs, ubs] for the uniform draw
    `u` (d,) in [0, 1)."""
    return lbs + (ubs - lbs) * u


def multistart_maximize(state: sg.SurrogateState, rule: DecisionRule, theta, lbs,
                        ubs, xstarts, *, iterations: int = 12,
                        generator: torch.Generator | None = None) -> SolveResult:
    """Multistart acquisition maximization on one (unbatched) surrogate
    (reference multistart_base_solve!): one lane, S starts, through the
    lane solver (the kernel on the card, its plain version on the CPU), or
    `newton_solve_batch` for a cost-aware rule.

    For the "Random" rule it returns a uniform sample from the box
    (reference rbf_optim.jl:76-79, 110-113), drawn on the host from
    `generator` (a CPU `torch.Generator`) so that one seed gives one stream
    whichever device the surrogate lives on; its xs is that sample as one
    start (S = 1) with value 0.

    The per-start `xs` / `values` of a lane-solver solve come from one
    lane-solver call per start when first read; a start whose value is
    -inf there reports x = 0, as the lane solver does for such a lane.
    """
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    lbs, ubs = as_t(lbs), as_t(ubs)
    if rule.name == "Random":
        if generator is None:
            raise ValueError("Random acquisition requires a torch.Generator")
        u = torch.rand(state.dim, generator=generator, dtype=dt).to(dev)
        x, v = random_point(lbs, ubs, u), torch.zeros((), dtype=dt, device=dev)
        return SolveResult(x, v, lambda: (x[None], v[None]))
    if state.X.dim() != 2:
        raise ValueError("multistart_maximize takes one surrogate; maximize_hot "
                         "solves a batch of lanes")
    theta, xstarts = as_t(theta), as_t(xstarts)
    if getattr(rule, "cost", None) is not None:
        with torch.no_grad():
            xs, vs = newton_solve_batch(state, rule, theta, lbs, ubs, xstarts,
                                        iterations=iterations)
        # first start wins a tie; selected on the device (indexing with the
        # index tensor reads it on the host, which a capture refuses)
        j = torch.argmax(vs).reshape(1)
        return SolveResult(xs.index_select(0, j)[0], vs.index_select(0, j)[0],
                           lambda: (xs, vs))
    x, v = maximize_hot(state, rule, theta, lbs, ubs, xstarts, iterations=iterations)

    def per_start():
        solved = [maximize_hot(state, rule, theta, lbs, ubs, xstarts[s:s + 1],
                               iterations=iterations) for s in range(xstarts.shape[0])]
        return torch.stack([xs for xs, _ in solved]), torch.stack([vs for _, vs in solved])

    return SolveResult(x, v, per_start)
