"""Outer policy optimization: SGA/Adam on the rollout acquisition.

Port of `rollout_bo_tpu/rollout/outer.py` (reference `optimizers.jl`,
`utils.jl:114-306`). The stochastic solver is `stochastic_solve_fused`,
with the semantics of the JAX package's `make_fused_sga_program`: every
restart is simulated in lock-step each iteration, a restart freezes when
the eswavs early-stopping statistic fires, and the loop ends when all have
stopped. Here the loop is a Python loop with a host check of "all
stopped" after each iteration, or after each window of `steps_per_call`
iterations. The JAX package's stepped and scanned solvers
(`stochastic_solve_stepped`, `stochastic_solve_scanned`) are the same loop
with that check every `sync_every` iterations, or after whole windows of
`steps_per_call`. `stochastic_solve` (one start) and
`stochastic_solve_batch` (no winner selection) are the same loop. The
deterministic (Gauss-Hermite) solver runs its restarts in lock-step the
same way, each with its own stop mask.

The program factories (`make_batched_grad_step`, `make_batched_sga_step`,
`make_scanned_sga_program`, `make_fused_sga_program`) are the JAX
package's, with its signatures: each returns a callable of (state,
rnstream, ...) that closes over the rest of the problem. On the card they
are CUDA graphs (`utils.graphs.GraphProgram`, the counterpart of `jax.jit`)
of the same steps the eager loop runs; elsewhere they run eagerly. The
fused program replays a graph of one SGA step until every restart has
stopped or `max_iters` is reached, with a host read of "all stopped"
between replays, then a graph of the value-only pass (and the argmax);
the JAX program does that loop on the device (`lax.while_loop`). The
solvers take a prebuilt program as the JAX ones do (`program=`,
`sga_step=`); without one they run the eager loop.
`make_deterministic_program` is the Gauss-Hermite solve that the JAX BO
loops jit, as a callable of (state, restarts): a graph of one Adam step
replayed until no restart is active (read on the host between replays),
then a graph of the value pass.

With a `mesh` (`parallel.mesh`), a solve splits its restarts over the
ranks of the 'restarts' axis and, for `stochastic_solve_fused`, the
trajectories over those of the 'mc' axis, and gathers the results: the
placements of the JAX package's `parallel/sharded.py`. Those solves run
eagerly: the factories take no mesh, as the JAX ones take none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams
from rollout_bo_tpu_torch.utils.graphs import GraphProgram

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "sga_update",
    "eswavs",
    "FusedSolve",
    "make_batched_grad_step",
    "make_batched_sga_step",
    "make_fused_sga_program",
    "make_scanned_sga_program",
    "stochastic_solve",
    "stochastic_solve_batch",
    "stochastic_solve_fused",
    "stochastic_solve_scanned",
    "stochastic_solve_stepped",
    "deterministic_solve",
    "deterministic_solve_batch",
    "make_deterministic_program",
]


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor     # () int32 step count, on the device of m


def adam_init(x) -> AdamState:
    return AdamState(torch.zeros_like(x), torch.zeros_like(x),
                     torch.zeros((), dtype=torch.int32, device=x.device))


def adam_update(state: AdamState, x, grad, *, lr=0.01, b1=0.9, b2=0.999, eps=1e-8):
    """Adam ascent step (reference optimizers.jl:25-75). The step count is
    a device tensor, as in the JAX package, so that a CUDA graph of a step
    corrects the bias of the step it replays, not of the one it captured."""
    t = state.t + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad * grad
    tf = t.to(x.dtype)
    mhat = m / (1 - b1**tf)
    vhat = v / (1 - b2**tf)
    return AdamState(m, v, t), x + lr * mhat / (torch.sqrt(vhat) + eps)


def sga_update(x, grad, *, lr=0.01):
    """Plain SGA ascent step (reference optimizers.jl:6-22)."""
    return x + lr * grad


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


def _best(xs, vals):
    """(xs[j], vals[j]) at j = argmax(vals), the first of tied ones (as
    `jnp.argmax`), selected on the device: indexing with the index tensor
    would read it on the host."""
    j = torch.argmax(vals).reshape(1)
    return xs.index_select(0, j)[0], vals.index_select(0, j)[0]


class FusedSolve(NamedTuple):
    x: torch.Tensor        # (R, d) final points, or (d,) the winner
    value: torch.Tensor    # (R,) values at the final points, or () the winner's
    iterations: int        # SGA iterations run


def _sga_carry(xs):
    """The SGA carry (xs, AdamState, done, vals) at the restarts xs (R, d)."""
    return (xs, adam_init(xs), torch.zeros(xs.shape[:-1], dtype=torch.bool, device=xs.device),
            torch.zeros(xs.shape[:-1], dtype=xs.dtype, device=xs.device))


def _sga_step(simulate, carry, lbs, ubs, sample_size, lr):
    """One SGA iteration over the carry (xs, opt, done, vals): simulate every
    restart (gradients included), freeze those whose eswavs statistic
    fires, and take an Adam step clipped to the box for the others. The
    new carry's vals are the values at the points before the step (the JAX
    package's `make_batched_sga_step`)."""
    xs, opt, done, _ = carry
    eto = simulate(xs, True)
    done = done | eswavs(eto.grad_x, eto.std_grad_x**2, sample_size)
    opt, xs_new = adam_update(opt, xs, eto.grad_x, lr=lr)
    xs = torch.where(done[..., None], xs, torch.clamp(xs_new, lbs, ubs))
    return xs, opt, done, eto.mu


def _sga(step, carry, *, max_steps, check_every=1, mesh=None):
    """The SGA loop of every route: carry = step(carry) over the SGA carry
    (xs, opt, done, vals), `max_steps` times unless "every restart has
    stopped" (done) ends it, tested after each window of `check_every`
    steps: on every rank of `mesh`, which sums the active restarts over the
    world (the JAX program's all-reduce(AND) of its all-stopped predicate).
    A step is one SGA iteration (`_sga_step` eagerly, or a replay of
    `make_batched_sga_step`'s graph) or a scanned program's window of
    them. Returns (carry, steps run)."""
    it = 0
    while it < max_steps:
        carry = step(carry)
        it += 1
        if it % check_every:
            continue
        done = carry[2]
        if mesh is None:
            if bool(done.all()):
                break
        elif int(mesh_mod.all_reduce_sum(torch.count_nonzero(~done).reshape(1), mesh)) == 0:
            break
    return carry, it


def _gather_restarts(xs, vals, mesh):
    """(xs, vals) of every restart on every rank of `mesh`, in the order of
    the restarts before `shard_leading` split them (one all-reduce)."""
    both = mesh_mod.gather_leading(torch.cat([xs, vals[:, None]], dim=-1), mesh, "restarts")
    return both[:, :-1], both[:, -1]


def _multi_restart(state, tp, rule, xstarts, restarts, *, max_iters, lr, inner_iterations,
                   draw_mode, mesh, shard_stream, check_every=1):
    """SGA from every restart, then a value-only evaluation at the final
    points: (xs (R, d), values (R,), iterations). With `mesh`, this rank
    takes its block of the restarts along 'restarts' and, with
    `shard_stream`, its block of the trajectories along 'mc' (whose ranks
    then reduce the statistics), and the results are gathered."""
    sample_size = tp.mc_iters
    group = None
    if mesh is not None:
        restarts = mesh_mod.shard_leading(restarts, mesh, "restarts")
        if shard_stream:
            tp = tp._replace(rnstream=mesh_mod.shard_leading(tp.rnstream, mesh, "mc"))
            group = mesh.group("mc")

    def simulate(xs, with_gradients):
        return mc_mod.simulate_trajectory_mc(
            state, tp._replace(x0=xs), rule, xstarts, with_gradients=with_gradients,
            iterations=inner_iterations, draw_mode=draw_mode, group=group)

    (xs, *_), it = _sga(
        lambda carry: _sga_step(simulate, carry, tp.lbs, tp.ubs, sample_size, lr),
        _sga_carry(restarts), max_steps=max_iters, check_every=check_every, mesh=mesh)
    vals = simulate(xs, False).mu
    if mesh is not None:
        xs, vals = _gather_restarts(xs, vals, mesh)
    return xs, vals, it


def _program_problem(state, tp, xstarts):
    """What a program closes over: tp's theta and box and the inner starts
    as tensors of the state's dtype on its device (made here, outside any
    capture), and that device."""
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    return tp._replace(theta=as_t(tp.theta), lbs=as_t(tp.lbs), ubs=as_t(tp.ubs)), as_t(xstarts), dev


def _program_simulator(st, rnstream, tp, rule, xstarts, inner_iterations, draw_mode):
    """simulate(xs, with_gradients) of every restart of xs on (st, rnstream)."""

    def simulate(xs, with_gradients):
        return mc_mod.simulate_trajectory_mc(
            st, tp._replace(x0=xs, rnstream=rnstream), rule, xstarts,
            with_gradients=with_gradients, iterations=inner_iterations, draw_mode=draw_mode)

    return simulate


def make_batched_grad_step(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, *, inner_iterations: int = 12,
                           draw_mode: str = "reparam"):
    """`step(st, rnstream, xs)` -> (values (R,), grads (R, d), stds (R, d)) of
    the MC rollout acquisition at the points xs (R, d), as one program: the
    JAX package's jitted building block of the stepped loop."""
    tp, xstarts, dev = _program_problem(state, tp, xstarts)

    def step(st, rnstream, xs):
        eto = _program_simulator(st, rnstream, tp, rule, xstarts, inner_iterations,
                                 draw_mode)(xs, True)
        return eto.mu, eto.grad_x, eto.std_grad_x

    return GraphProgram(step, device=dev)


def make_batched_sga_step(state: sg.SurrogateState, tp: TrajectoryParams,
                          rule: DecisionRule, xstarts, *, lr: float = 0.01,
                          inner_iterations: int = 12, draw_mode: str = "reparam"):
    """`step(st, rnstream, carry)` -> carry: one SGA iteration (`_sga_step`:
    simulate, eswavs freeze, Adam, clamp) over the carry (xs, AdamState,
    done, vals) as one program. The sample size is the stream's length;
    the new vals are the values at the points before the step."""
    tp, xstarts, dev = _program_problem(state, tp, xstarts)

    def step(st, rnstream, carry):
        simulate = _program_simulator(st, rnstream, tp, rule, xstarts, inner_iterations,
                                      draw_mode)
        return _sga_step(simulate, carry, tp.lbs, tp.ubs, rnstream.shape[0], lr)

    return GraphProgram(step, device=dev)


class _ScannedSGAProgram:
    """A scanned-SGA program with the number of steps it holds, which
    `stochastic_solve_scanned` reads in place of its own argument."""

    def __init__(self, fn, steps_per_call: int):
        self._fn = fn
        self.steps_per_call = int(steps_per_call)
        self.graphs = (fn,)

    def __call__(self, st, rnstream, carry):
        return self._fn(st, rnstream, carry)


def make_scanned_sga_program(state: sg.SurrogateState, tp: TrajectoryParams,
                             rule: DecisionRule, xstarts, *, steps_per_call: int = 10,
                             lr: float = 0.01, inner_iterations: int = 12,
                             draw_mode: str = "reparam"):
    """`program(st, rnstream, carry)` -> carry: `steps_per_call` k SGA
    iterations (`make_batched_sga_step`'s) and then the value-only pass at
    the final points, whose values are the new carry's vals, all as one
    program (one CUDA graph on the card). The JAX program scores the final
    points with a pass that also takes gradients; the values are the same.
    The returned program carries `steps_per_call`."""
    tp, xstarts, dev = _program_problem(state, tp, xstarts)

    def program(st, rnstream, carry):
        simulate = _program_simulator(st, rnstream, tp, rule, xstarts, inner_iterations,
                                      draw_mode)
        for _ in range(steps_per_call):
            carry = _sga_step(simulate, carry, tp.lbs, tp.ubs, rnstream.shape[0], lr)
        xs, opt, done, _ = carry
        return xs, opt, done, simulate(xs, False).mu

    return _ScannedSGAProgram(GraphProgram(program, device=dev), steps_per_call)


class _FusedSGAProgram:
    """The whole multi-restart SGA solve (`make_fused_sga_program`): the
    step program replayed until every restart has stopped or `max_iters`
    is reached, "all stopped" read on the host after each step, then the
    final program. `iterations` holds the SGA iterations of the last call."""

    def __init__(self, step, final, max_iters: int, select_best: bool):
        self.step, self.final = step, final
        self.max_iters, self.select_best = max_iters, select_best
        self.graphs = (step, final)
        self.iterations = 0

    def __call__(self, st, rnstream, xs0):
        carry, self.iterations = _sga(lambda c: self.step(st, rnstream, c), _sga_carry(xs0),
                                      max_steps=self.max_iters)
        return self.final(st, rnstream, carry[0])


def make_fused_sga_program(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, *, max_iters: int = 50,
                           lr: float = 0.01, inner_iterations: int = 12,
                           draw_mode: str = "reparam", select_best: bool = False):
    """`program(st, rnstream, xs0)` -> (xs (R, d), vals (R,)): the whole
    multi-restart SGA solve from xs0, with the semantics of
    `stochastic_solve_fused` (the all-stopped test after every iteration,
    as the JAX program's `while_loop`), the values from a value-only pass
    at the final points. With `select_best` the argmax restart (the first
    of tied ones) is returned instead: (x_best (d,), v_best ()). The
    program's `iterations` attribute holds the SGA iterations of its last
    call. On the card one SGA step and the final pass are CUDA graphs."""
    tp, xstarts, dev = _program_problem(state, tp, xstarts)
    step = make_batched_sga_step(state, tp, rule, xstarts, lr=lr,
                                 inner_iterations=inner_iterations, draw_mode=draw_mode)

    def final(st, rnstream, xs):
        vals = _program_simulator(st, rnstream, tp, rule, xstarts, inner_iterations,
                                  draw_mode)(xs, False).mu
        return _best(xs, vals) if select_best else (xs, vals)

    return _FusedSGAProgram(step, GraphProgram(final, device=dev), max_iters, select_best)


def stochastic_solve_fused(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, restarts, *,
                           max_iters: int = 50, lr: float = 0.01,
                           inner_iterations: int = 12,
                           draw_mode: str = "reparam",
                           select_best: bool = False, mesh=None,
                           steps_per_call: int = 1, program=None) -> FusedSolve:
    """Multi-restart SGA of the MC rollout acquisition from `restarts` (R, d).

    Each iteration simulates all restarts (gradients included), freezes the
    restarts whose eswavs statistic fires, and takes an Adam step clipped
    to the box for the others; it stops after `max_iters` or once every
    restart has stopped. A value-only evaluation then scores the final
    points; with `select_best` the argmax restart is returned (the first
    of tied ones, as `jnp.argmax`).

    `steps_per_call` k > 1 gives the JAX package's scanned solver
    (`stochastic_solve_scanned`): "every restart has stopped" is tested
    only after each window of k iterations, and ceil(max_iters / k) k
    iterations run unless that test ends the loop.

    `mesh` (`parallel.mesh.Mesh`): the restarts split over its 'restarts'
    axis and the trajectories of tp.rnstream over its 'mc' axis, as the JAX
    package's `sharded_stochastic_solve_fused` places them. Every rank
    simulates every iteration until all restarts everywhere have stopped,
    and returns the same result.

    `program`: a prebuilt `make_fused_sga_program`, run in place of the
    eager loop (its own max_iters, lr, inner iterations and draw mode hold,
    as in the JAX package); it takes no mesh and no `steps_per_call`, and
    its `select_best` must be this call's.
    """
    if program is not None:
        if mesh is not None or steps_per_call != 1 or program.select_best != select_best:
            raise ValueError("a fused program runs on one device, tests 'all stopped' "
                             "after every iteration and has its own select_best: "
                             f"mesh {mesh}, steps_per_call {steps_per_call}, select_best "
                             f"{select_best} (the program's {program.select_best})")
        x, value = program(state, tp.rnstream, restarts)
        return FusedSolve(x, value, program.iterations)
    xs, vals, it = _multi_restart(
        state, tp, rule, xstarts, restarts,
        max_iters=-(-max_iters // steps_per_call) * steps_per_call, lr=lr,
        inner_iterations=inner_iterations, draw_mode=draw_mode, mesh=mesh,
        shard_stream=True, check_every=steps_per_call)
    if select_best:
        return FusedSolve(*_best(xs, vals), it)
    return FusedSolve(xs, vals, it)


def stochastic_solve_scanned(state: sg.SurrogateState, tp: TrajectoryParams,
                             rule: DecisionRule, xstarts, starts, *,
                             max_iters: int = 50, steps_per_call: int = 10,
                             lr: float = 0.01, inner_iterations: int = 12,
                             draw_mode: str = "reparam", program=None):
    """The JAX package's `stochastic_solve_scanned`: the SGA loop in whole
    windows of `steps_per_call` k, "every restart has stopped" tested after
    each window, so ceil(max_iters / k) k iterations run unless that test
    ends the loop. Returns (xs (R, d), values (R,)), the values at the
    final points: `stochastic_solve_fused(steps_per_call=k)` without
    `select_best`. `program`: a prebuilt `make_scanned_sga_program`, one
    call per window; its own `steps_per_call` overrides the argument."""
    if program is None:
        fs = stochastic_solve_fused(state, tp, rule, xstarts, starts, max_iters=max_iters,
                                    lr=lr, inner_iterations=inner_iterations,
                                    draw_mode=draw_mode, steps_per_call=steps_per_call)
        return fs.x, fs.value
    fs = _scanned_program_solve(program, state, tp.rnstream, starts, max_iters)
    return fs.x, fs.value


def _scanned_program_solve(program, state, rnstream, starts, max_iters) -> FusedSolve:
    """`stochastic_solve_scanned` through a scanned program, one call per
    window: (xs, values at them, SGA iterations run)."""
    (xs, _, _, vals), calls = _sga(lambda c: program(state, rnstream, c), _sga_carry(starts),
                                   max_steps=-(-max_iters // program.steps_per_call))
    return FusedSolve(xs, vals, calls * program.steps_per_call)


def stochastic_solve_stepped(state: sg.SurrogateState, tp: TrajectoryParams,
                             rule: DecisionRule, xstarts, starts, *,
                             max_iters: int = 50, lr: float = 0.01,
                             inner_iterations: int = 12, draw_mode: str = "reparam",
                             grad_step=None, sga_step=None, sync_every: int = 10):
    """The JAX package's `stochastic_solve_stepped`: at most `max_iters` SGA
    iterations, "every restart has stopped" tested after every
    `sync_every`. A stopped restart keeps its point, so the points are
    those of `stochastic_solve_fused` for any `sync_every`, which sets only
    how many iterations run on after the last restart stopped. Returns
    (xs (R, d), values (R,)), the values at the final points.

    `sga_step`: a prebuilt `make_batched_sga_step`, one call per
    iteration and one more with every restart frozen for the values; as in
    the JAX package, `grad_step` is accepted and not used."""
    if sga_step is None:
        xs, vals, _ = _multi_restart(
            state, tp, rule, xstarts, starts, max_iters=max_iters, lr=lr,
            inner_iterations=inner_iterations, draw_mode=draw_mode, mesh=None,
            shard_stream=False, check_every=sync_every)
        return xs, vals
    (xs, opt, done, vals), _ = _sga(lambda c: sga_step(state, tp.rnstream, c),
                                    _sga_carry(starts), max_steps=max_iters,
                                    check_every=sync_every)
    _, _, _, vals = sga_step(state, tp.rnstream, (xs, opt, torch.ones_like(done), vals))
    return xs, vals


def stochastic_solve_batch(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, starts, *,
                           max_iters: int = 50, lr: float = 0.01,
                           inner_iterations: int = 12, draw_mode: str = "reparam",
                           mesh=None):
    """`stochastic_solve` from every row of starts (R, d): the fused solve
    without `select_best`. The restarts run in lock-step, each frozen once
    its eswavs statistic fires, which gives the points of the JAX package's
    per-restart `while_loop`s under `vmap`. Returns (xs (R, d), values
    (R,)), the values at the final points.

    `mesh`: the restarts split over its 'restarts' axis; every rank
    simulates the whole stream (the JAX `sharded_stochastic_solve_batch`
    replicates it)."""
    xs, vals, _ = _multi_restart(
        state, tp, rule, xstarts, starts, max_iters=max_iters, lr=lr,
        inner_iterations=inner_iterations, draw_mode=draw_mode, mesh=mesh,
        shard_stream=False)
    return xs, vals


def stochastic_solve(state: sg.SurrogateState, tp: TrajectoryParams, rule: DecisionRule,
                     xstarts, start, *, max_iters: int = 50, lr: float = 0.01,
                     inner_iterations: int = 12, draw_mode: str = "reparam"):
    """SGA (Adam) ascent of the MC rollout acquisition from one start (d,)
    (reference stochastic_solve, utils.jl:235-265): simulate -> eswavs stop
    -> Adam step clipped to the box, until the statistic fires or after
    `max_iters`. Returns (x_final, ExpectedTrajectoryOutput at x_final,
    gradients included)."""

    def simulate(x, with_gradients):
        return mc_mod.simulate_trajectory_mc(
            state, tp._replace(x0=x), rule, xstarts, with_gradients=with_gradients,
            iterations=inner_iterations, draw_mode=draw_mode)

    (xs, *_), _ = _sga(
        lambda carry: _sga_step(simulate, carry, tp.lbs, tp.ubs, tp.mc_iters, lr),
        _sga_carry(start[None]), max_steps=max_iters)
    return xs[0], simulate(xs[0], True)


def _ghq_carry(xs):
    """The ascent's carry (xs, AdamState, active) at the restarts xs (R, d)."""
    return xs, adam_init(xs), torch.ones(xs.shape[:-1], dtype=torch.bool, device=xs.device)


def _ghq_step(simulate, carry, lbs, ubs, *, lr, grad_tol):
    """One Adam iteration of the quadrature objective over the carry (xs,
    opt, active): a restart whose gradient norm falls below grad_tol keeps
    the point it had and takes no further part (the JAX package's
    per-restart `while_loop` under `vmap`)."""
    xs, opt, active = carry
    eto = simulate(xs, True)
    stop = torch.linalg.vector_norm(eto.grad_x, dim=-1) < grad_tol
    opt, xs_new = adam_update(opt, xs, eto.grad_x, lr=lr)
    xs_new = torch.clamp(xs_new, lbs, ubs)
    xs = torch.where((active & ~stop)[..., None], xs_new, xs)
    return xs, opt, active & ~stop


def _deterministic_ascent(step, xs, *, max_iters):
    """carry = step(carry) from the carry at xs (R, d), all restarts together
    (`_ghq_step` eagerly, or a replay of its graph), until none is active
    (read on the host after each step) or after `max_iters`. Returns the
    final points."""
    carry = _ghq_carry(xs)
    for _ in range(max_iters):
        carry = step(carry)
        if not bool(carry[2].any()):
            break
    return carry[0]


def _ghq_simulator(state, theta, lbs, ubs, xstarts, rule, *, horizon, num_nodes,
                   inner_iterations, node_scale):
    """(simulate(x, with_gradients), as_t, lbs, ubs) of the quadrature
    estimate on `state`, or on `st=` (a program's argument). The problem's
    tensors and the quadrature tables are made here, once, outside any
    capture."""
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    theta, lbs, ubs, xstarts = as_t(theta), as_t(lbs), as_t(ubs), as_t(xstarts)
    tables = mc_mod.ghq_tables(num_nodes, horizon, node_scale, dtype=dt, device=dev)

    def simulate(x, with_gradients, st=state):
        return mc_mod.simulate_trajectory_ghq(
            st, x, theta, lbs, ubs, xstarts, rule, horizon=horizon,
            num_nodes=num_nodes, with_gradients=with_gradients,
            iterations=inner_iterations, node_scale=node_scale, tables=tables)

    return simulate, as_t, lbs, ubs


def deterministic_solve(state: sg.SurrogateState, x0, theta, lbs, ubs, xstarts,
                        rule: DecisionRule, *, horizon: int, num_nodes: int = 8,
                        max_iters: int = 50, lr: float = 0.01, grad_tol: float = 1e-4,
                        inner_iterations: int = 12, node_scale: float = 1.0):
    """SAA (Gauss-Hermite) ascent of the rollout acquisition from one start
    x0 (d,): reference deterministic_solve (utils.jl:267-306), the Adam loop
    on the variance-free quadrature estimate, stopping on ||grad|| <
    grad_tol. Returns (x_final, ExpectedTrajectoryOutput at x_final)."""
    simulate, as_t, lbs, ubs = _ghq_simulator(
        state, theta, lbs, ubs, xstarts, rule, horizon=horizon, num_nodes=num_nodes,
        inner_iterations=inner_iterations, node_scale=node_scale)
    step = lambda c: _ghq_step(simulate, c, lbs, ubs, lr=lr, grad_tol=grad_tol)  # noqa: E731
    x = _deterministic_ascent(step, as_t(x0)[None], max_iters=max_iters)[0]
    return x, simulate(x, True)


def deterministic_solve_batch(state: sg.SurrogateState, theta, lbs, ubs, xstarts,
                              starts, rule: DecisionRule, *, horizon: int,
                              num_nodes: int = 8, max_iters: int = 50,
                              lr: float = 0.01, grad_tol: float = 1e-4,
                              inner_iterations: int = 12, node_scale: float = 1.0,
                              mesh=None):
    """`deterministic_solve` from every row of starts (R, d) in lock-step.
    Returns (xs (R, d), values (R,)), the values at the final points.
    `mesh`: the restarts split over its 'restarts' axis, the results
    gathered (no collective inside the ascent: its restarts are
    independent)."""
    simulate, as_t, lbs, ubs = _ghq_simulator(
        state, theta, lbs, ubs, xstarts, rule, horizon=horizon, num_nodes=num_nodes,
        inner_iterations=inner_iterations, node_scale=node_scale)
    starts = as_t(starts)
    if mesh is not None:
        starts = mesh_mod.shard_leading(starts, mesh, "restarts")
    step = lambda c: _ghq_step(simulate, c, lbs, ubs, lr=lr, grad_tol=grad_tol)  # noqa: E731
    xs = _deterministic_ascent(step, starts, max_iters=max_iters)
    vals = simulate(xs, False).mu
    if mesh is not None:
        xs, vals = _gather_restarts(xs, vals, mesh)
    return xs, vals


class _DeterministicProgram:
    """The Gauss-Hermite solve from every restart (`make_deterministic_program`):
    the step program through `_deterministic_ascent` (as `_FusedSGAProgram`
    runs its step through `_sga`), then the final program."""

    def __init__(self, step, final, max_iters: int):
        self.step, self.final, self.max_iters = step, final, max_iters
        self.graphs = (step, final)

    def __call__(self, st, starts):
        xs = _deterministic_ascent(lambda c: self.step(st, c), starts, max_iters=self.max_iters)
        return self.final(st, xs)


def make_deterministic_program(state: sg.SurrogateState, theta, lbs, ubs, xstarts,
                               rule: DecisionRule, *, horizon: int, num_nodes: int = 8,
                               max_iters: int = 50, lr: float = 0.01, grad_tol: float = 1e-4,
                               inner_iterations: int = 12, node_scale: float = 1.0,
                               select_best: bool = False):
    """`program(st, starts)` -> (xs (R, d), vals (R,)): `deterministic_solve_batch`
    from the restarts starts (R, d) on the state st, as a program (the JAX
    package jits that solve with its argmax). With `select_best` the argmax
    restart (the first of tied ones) is returned instead: (x_best (d,),
    v_best ()). On the card one Adam step and the final value pass are CUDA
    graphs; the quadrature tables are made here, outside their captures."""
    simulate, _, lbs, ubs = _ghq_simulator(
        state, theta, lbs, ubs, xstarts, rule, horizon=horizon, num_nodes=num_nodes,
        inner_iterations=inner_iterations, node_scale=node_scale)
    dev = state.X.device

    def step(st, carry):
        return _ghq_step(lambda x, g: simulate(x, g, st=st), carry, lbs, ubs, lr=lr,
                         grad_tol=grad_tol)

    def final(st, xs):
        vals = simulate(xs, False, st=st).mu
        return _best(xs, vals) if select_best else (xs, vals)

    return _DeterministicProgram(GraphProgram(step, device=dev), GraphProgram(final, device=dev),
                                 max_iters)
