"""Inner (myopic) acquisition maximization on the rollout hot path.

Port of `rollout_bo_tpu/rollout/solvers.py::maximize_hot`. Every lane of
the rollout (restart x MC trajectory) carries its own fantasy GP; the
lanes are flattened into one batch and solved by one call of
`ops/newton_lanes.py::newton_solve_lanes`: the CUDA kernel for tensors on
the card, its plain version for CPU tensors. K^{-1} = Li^T Li is formed
once per call with one batched matmul, as the JAX package's
`pallas_newton.get_solver.flat_impl` does.

`multistart_maximize`, the BO loops' solver on one surrogate, is the same
lane solver called with ONE lane and S starts. The lane solver returns
each lane's best start only, so `SolveResult` holds `x` and `value` and
not the JAX package's per-start `xs` / `values`, which nothing in the
package reads.

The Li-formulated `newton_solve_batch` of the JAX package is not ported:
the kernel's plain version is the CPU solver. It returns with the
cost-aware channel, which the lane solver does not cover.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.ops import newton_lanes

__all__ = ["supported", "maximize_hot", "multistart_maximize", "SolveResult"]


class SolveResult(NamedTuple):
    x: torch.Tensor        # (d,) argmax over the starts
    value: torch.Tensor    # () acquisition value there


def supported(kind: str, rule: DecisionRule) -> bool:
    """Whether the lane solver covers this kernel family and rule."""
    return newton_lanes.supported(kind, rule.name)


def maximize_hot(state: sg.SurrogateState, rule: DecisionRule, theta, lbs, ubs,
                 xstarts, *, iterations: int = 12):
    """(xstar (..., d), value (...)) multistart argmax for every lane.

    `state` and `theta` (..., p) carry the lane axes; the bounds and the
    S starts (S, d) are shared. Nothing here is differentiated.
    """
    kind = state.kernel.kind
    if not supported(kind, rule):
        raise NotImplementedError(f"no lane solver for ({kind!r}, {rule.name!r})")
    cap, d = state.capacity, state.dim
    lead = torch.broadcast_shapes(state.X.shape[:-2], state.Li.shape[:-2],
                                  state.c.shape[:-1], state.n.shape, theta.shape[:-1])

    def flat(t, tail=()):
        return t.detach().expand(lead + tail).reshape((-1,) + tail).contiguous()

    with torch.no_grad():
        Li = flat(state.Li, (cap, cap))
        W = Li.transpose(-1, -2) @ Li
        kth = state.kernel.theta.detach()
        period = kth[1] if kind == "periodic" else torch.ones_like(kth[0])
        xs, vs = newton_lanes.newton_solve_lanes(
            flat(state.X, (cap, d)), W, flat(state.c, (cap,)), flat(state.n),
            flat(sg.get_active_minimum(state)), flat(theta[..., 0]),
            kth[0], lbs, ubs, xstarts, period,
            kind=kind, rule=rule.name, iterations=iterations,
            sigma_tol=rule.sigma_tol, f_tol=float(rule.solve_f_tol),
            x_tol=float(rule.solve_x_tol),
        )
    return xs.reshape(lead + (d,)), vs.reshape(lead)


def multistart_maximize(state: sg.SurrogateState, rule: DecisionRule, theta, lbs,
                        ubs, xstarts, *, iterations: int = 12,
                        generator: torch.Generator | None = None) -> SolveResult:
    """Multistart acquisition maximization on one (unbatched) surrogate
    (reference multistart_base_solve!): one lane, S starts, through the
    lane solver: the kernel on the card, its plain version on the CPU.

    For the "Random" rule it returns a uniform sample from the box
    (reference rbf_optim.jl:76-79, 110-113), drawn on the host from
    `generator` (a CPU `torch.Generator`) so that one seed gives one stream
    whichever device the surrogate lives on.
    """
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    lbs, ubs = as_t(lbs), as_t(ubs)
    if rule.name == "Random":
        if generator is None:
            raise ValueError("Random acquisition requires a torch.Generator")
        u = torch.rand(state.dim, generator=generator, dtype=dt).to(dev)
        return SolveResult(lbs + (ubs - lbs) * u, torch.zeros((), dtype=dt, device=dev))
    if state.X.dim() != 2:
        raise ValueError("multistart_maximize takes one surrogate; maximize_hot "
                         "solves a batch of lanes")
    x, v = maximize_hot(state, rule, as_t(theta), lbs, ubs, as_t(xstarts),
                        iterations=iterations)
    return SolveResult(x, v)
