"""Evaluation-cost models for cost-aware acquisition.

Port of `rollout_bo_tpu/models/cost_functions.py` (reference
`cost_functions.jl`). `CostAwareRule` weights a decision rule by 1/c(x) (or
subtracts log c(x) for the log-scale rules); the x-dependent corrections of
value, gradient and Hessian are applied in `models/surrogate.py`'s
acquisition functions, so every consumer of those (the inner solve, the IFT
gradient, the rollout) takes such a rule unchanged. The CUDA lane kernel
has no cost channel: `rollout/solvers.py` sends every rule with a cost to
`newton_solve_batch`.

A user's cost `f` maps ONE point (d,) to a scalar, as in the JAX package.
Here it is evaluated over any leading lane axes with `torch.func.vmap`, and
its gradient and Hessian come from `torch.func.grad` / `torch.func.hessian`
under the same vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from rollout_bo_tpu_torch.models.decision_rules import DecisionRule

__all__ = [
    "CostFunction",
    "UniformCost",
    "NonUniformCost",
    "UnitCost",
    "GaussianProcessCost",
    "CostAwareRule",
    "cost_aware",
    "cost_weighted_rule",
]


def _over_lanes(fn, x):
    """fn of one point (d,) mapped over the lane axes of x (..., d)."""
    lead, d = x.shape[:-1], x.shape[-1]
    out = torch.func.vmap(fn)(x.reshape(-1, d))
    return out.reshape(lead + out.shape[1:])


@dataclasses.dataclass(frozen=True)
class CostFunction:
    """c(x) with its gradient and Hessian (reference cost_functions.jl:5-40).

    Every method takes x (..., d) and returns (...), (..., d), (..., d, d).
    """

    f: Callable[[torch.Tensor], torch.Tensor]
    uniform: bool = False

    def __call__(self, x):
        if self.uniform:
            return self.f(x)
        return _over_lanes(self.f, x)

    def grad(self, x):
        if self.uniform:
            return torch.zeros_like(x)
        return _over_lanes(torch.func.grad(self.f), x).to(x.dtype)

    def hess(self, x):
        if self.uniform:
            return torch.zeros(x.shape + x.shape[-1:], dtype=x.dtype, device=x.device)
        return _over_lanes(torch.func.hessian(self.f), x).to(x.dtype)

    def derivatives(self, x, order: int):
        """(c, grad c, hess c)[:order + 1] at x."""
        return tuple(fn(x) for fn in (self.__call__, self.grad, self.hess)[:order + 1])


def NonUniformCost(f: Callable) -> CostFunction:
    return CostFunction(f=f, uniform=False)


def UniformCost(n: float = 1.0) -> CostFunction:
    return CostFunction(
        f=lambda x: torch.full(x.shape[:-1], n, dtype=x.dtype, device=x.device),
        uniform=True)


def UnitCost() -> CostFunction:
    return UniformCost(1.0)


_GP_COST_FLOOR = 1e-6


@dataclasses.dataclass(frozen=True)
class _GPCost(CostFunction):
    """max(mu(x), 1e-6) of a cost surrogate, with mu's closed-form gradient
    and Hessian masked to 0 where the floor is active (what jax.grad of
    jnp.maximum gives there)."""

    state: object = None

    def derivatives(self, x, order: int):
        from rollout_bo_tpu_torch.models import surrogate as sg

        p = sg.posterior(self.state, x.to(self.state.X.dtype))
        live = (p.mu > _GP_COST_FLOOR).to(x.dtype)
        out = (torch.clamp(p.mu, min=_GP_COST_FLOOR).to(x.dtype),
               p.grad_mu.to(x.dtype) * live[..., None],
               p.hess_mu.to(x.dtype) * live[..., None, None])
        return out[:order + 1]      # one posterior call, whatever the order

    def __call__(self, x):
        return self.derivatives(x, 0)[0]

    def grad(self, x):
        return self.derivatives(x, 1)[1]

    def hess(self, x):
        return self.derivatives(x, 2)[2]


def GaussianProcessCost(state) -> CostFunction:
    """Learned cost model: the posterior mean of a GP fit to observed costs,
    floored at 1e-6 so that cost-weighted acquisitions stay finite. The
    reference declares this as an empty struct (cost_functions.jl:46-47).
    `state` is a `surrogate.SurrogateState` on the device of the main
    surrogate."""
    from rollout_bo_tpu_torch.models import surrogate as sg

    return _GPCost(
        f=lambda x: torch.clamp(sg.posterior(state, x).mu, min=_GP_COST_FLOOR),
        uniform=False, state=state)


@dataclasses.dataclass(frozen=True)
class CostAwareRule(DecisionRule):
    """A decision rule maximized per unit evaluation cost.

    Nonnegative rules (EI, POI) maximize alpha(x) / c(x); the log-scale
    rules (LogEI, LogPOI) maximize log alpha - log c: dividing a negative
    log value by the cost would invert the preference. Signed, non-log
    rules (LCB) have no per-unit-cost form and are refused by `cost_aware`.

    It keeps the base rule's `name`, so code that dispatches on the name
    (Random, the fallback, the MLE gating) keeps working; anything that
    must not drop the cost checks `cost` first (`rollout/solvers.py`).
    """

    cost: CostFunction | None = None


_COST_COMPOSABLE = {"EI": "divide", "POI": "divide", "Random": "divide",
                    "LogEI": "subtract_log", "LogPOI": "subtract_log"}


def cost_aware(rule: DecisionRule, cost: CostFunction) -> CostAwareRule:
    """Wrap a rule so every solver maximizes it per unit evaluation cost."""
    if getattr(rule, "cost", None) is not None:
        raise ValueError("rule is already cost-aware; composing two cost "
                         "weightings would divide by the cost twice")
    if rule.name not in _COST_COMPOSABLE:
        raise ValueError(
            f"cost-aware form of rule {rule.name!r} is undefined (signed, "
            "non-log scale); supported: " + ", ".join(sorted(_COST_COMPOSABLE)))
    return CostAwareRule(name=rule.name, sigma_tol=rule.sigma_tol, cost=cost)


def cost_weighted_rule(rule, cost: CostFunction):
    """(state, x, theta) -> per-unit-cost acquisition value; a thin wrapper
    over `cost_aware` for custom solve loops (legacy functional form)."""
    from rollout_bo_tpu_torch.models import surrogate as sg

    caw = cost_aware(rule, cost)

    def alpha_per_cost(state, x, theta):
        return sg.acquisition(state, caw, x, theta)

    return alpha_per_cost
