"""Outer policy optimization: SGA/Adam on the rollout acquisition.

Port of `rollout_bo_tpu/rollout/outer.py` (reference `optimizers.jl`,
`utils.jl:114-265`). One solver is ported, `stochastic_solve_fused`, with
the semantics of the JAX package's `make_fused_sga_program`: every
restart is simulated in lock-step each iteration, a restart freezes when
the eswavs early-stopping statistic fires, and the loop ends when all have
stopped. The JAX package's stepped and scanned variants exist to hide
host<->TPU dispatch cost and are not ported; here the loop is a Python
loop with a host check of "all stopped" after each iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "eswavs",
    "FusedSolve",
    "stochastic_solve_fused",
]


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: int


def adam_init(x) -> AdamState:
    return AdamState(torch.zeros_like(x), torch.zeros_like(x), 0)


def adam_update(state: AdamState, x, grad, *, lr=0.01, b1=0.9, b2=0.999, eps=1e-8):
    """Adam ascent step (reference optimizers.jl:25-75)."""
    t = state.t + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad * grad
    mhat = m / (1 - b1**t)
    vhat = v / (1 - b2**t)
    return AdamState(m, v, t), x + lr * mhat / (torch.sqrt(vhat) + eps)


def eswavs(grad, var_grad, sample_size: int):
    """Early Stopping Without A Validation Set (Mahsereci et al.; reference
    utils.jl:114-123) over the last axis. True => stop.

    The variance floor is the dtype's smallest normal: a fixed 1e-300
    underflows to 0 in float32 and disarms the divide-by-zero guard (a
    zero-gradient, zero-std restart must freeze, not produce NaN).
    """
    dim = grad.shape[-1]
    floor = torch.finfo(var_grad.dtype).tiny
    ratio = torch.sum(grad**2 / torch.clamp(var_grad, min=floor), dim=-1)
    return (1.0 - (sample_size / dim) * ratio) > 0.0


class FusedSolve(NamedTuple):
    x: torch.Tensor        # (R, d) final points, or (d,) the winner
    value: torch.Tensor    # (R,) values at the final points, or () the winner's
    iterations: int        # SGA iterations run


def stochastic_solve_fused(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, restarts, *,
                           max_iters: int = 50, lr: float = 0.01,
                           inner_iterations: int = 12,
                           select_best: bool = False) -> FusedSolve:
    """Multi-restart SGA of the MC rollout acquisition from `restarts` (R, d).

    Each iteration simulates all restarts (gradients included), freezes the
    restarts whose eswavs statistic fires, and takes an Adam step clipped
    to the box for the others; it stops after `max_iters` or once every
    restart has stopped. A value-only evaluation then scores the final
    points; with `select_best` the argmax restart is returned.
    """
    xs = restarts
    opt = adam_init(xs)
    done = torch.zeros(xs.shape[:-1], dtype=torch.bool, device=xs.device)
    sample_size = tp.mc_iters
    it = 0
    while it < max_iters:
        eto = mc_mod.simulate_trajectory_mc(
            state, tp._replace(x0=xs), rule, xstarts,
            with_gradients=True, iterations=inner_iterations)
        done = done | eswavs(eto.grad_x, eto.std_grad_x**2, sample_size)
        opt, xs_new = adam_update(opt, xs, eto.grad_x, lr=lr)
        xs_new = torch.clamp(xs_new, tp.lbs, tp.ubs)
        xs = torch.where(done[..., None], xs, xs_new)
        it += 1
        if bool(done.all()):
            break
    vals = mc_mod.simulate_trajectory_mc(
        state, tp._replace(x0=xs), rule, xstarts,
        with_gradients=False, iterations=inner_iterations).mu
    if select_best:
        j = torch.argmax(vals)
        return FusedSolve(xs[j], vals[j], it)
    return FusedSolve(xs, vals, it)
