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
placements of the JAX package's `parallel/sharded.py`. The factories take
the mesh too (`mesh=`), where the JAX ones read the placements of their
inputs: a program built for a mesh shards its inputs itself, and its graphs
hold the collectives (the 'mc' statistics, the world-summed count of the
restarts still active, the 'restarts' gather), which NCCL runs on the card.
The eager mesh route (`mesh=` and no program) runs the same step functions.
A gloo mesh runs its collectives on the host, so no graph can hold them: on
CUDA tensors such a mesh takes the eager route, and a factory refuses it
(`parallel.mesh.programs_run_on`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams
from rollout_bo_tpu_torch.utils import profiling
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


def _active_count(active, mesh):
    """The restarts still active (the bool mask `active`) summed over every
    rank of `mesh`: a (1,) int64 device tensor, the same on every rank, from
    one all-reduce (the JAX programs' all-reduced all-stopped predicate).
    A step computes it, so that a program's graph holds the collective and
    the host reads this one scalar between replays."""
    return mesh_mod.all_reduce_sum(torch.count_nonzero(active).reshape(1), mesh)


def _sga_step(simulate, carry, lbs, ubs, sample_size, lr, mesh=None):
    """One SGA iteration over the carry (xs, opt, done, vals): simulate every
    restart (gradients included), freeze those whose eswavs statistic
    fires, and take an Adam step clipped to the box for the others. The
    new carry's vals are the values at the points before the step (the JAX
    package's `make_batched_sga_step`). On a rank of `mesh` it returns
    (carry, `_active_count` of the new carry)."""
    xs, opt, done, _ = carry
    eto = simulate(xs, True)
    done = done | eswavs(eto.grad_x, eto.std_grad_x**2, sample_size)
    opt, xs_new = adam_update(opt, xs, eto.grad_x, lr=lr)
    xs = torch.where(done[..., None], xs, torch.clamp(xs_new, lbs, ubs))
    carry = (xs, opt, done, eto.mu)
    return carry if mesh is None else (carry, _active_count(~done, mesh))


def _sga(step, carry, *, max_steps, check_every=1, mesh=None,
         stopped=lambda carry: bool(carry[2].all())):
    """The loop of every route: carry = step(carry), `max_steps` times
    unless `stopped` ends it, tested after each window of `check_every`
    steps; by default "every restart has stopped" (the SGA carry's done). A
    step is one SGA iteration (`_sga_step` eagerly, or a replay of its
    graph), a scanned program's window of them, or a Gauss-Hermite Adam
    step (`_ghq_step`). On a rank of `mesh` a step returns (carry, active),
    the restarts still active over the world (`_active_count`), and the
    loop ends when it reads 0: one replicated scalar, so every rank takes
    as many steps as the others, as the JAX `while_loop` under its
    all-reduced predicate does. Each step and each read of the predicate is
    a span of the BO iteration's trace record (`outer.step`,
    `outer.stop_read`). Returns (carry, steps run)."""
    it = 0
    while it < max_steps:
        with profiling.span("outer.step"):
            carry = step(carry)
        if mesh is not None:
            carry, active = carry
        it += 1
        if it % check_every:
            continue
        with profiling.span("outer.stop_read"):
            done = int(active) == 0 if mesh is not None else stopped(carry)
        if done:
            break
    return carry, it


def _blocks(restarts, rnstream, mesh, shard_stream):
    """(restarts, rnstream, group): this rank's block of the restarts along
    the 'restarts' axis of `mesh` and, with `shard_stream`, its block of the
    trajectories along 'mc' and the group whose ranks reduce their
    statistics (the placements of the JAX package's `parallel/sharded.py`);
    the inputs themselves and no group without a mesh."""
    if mesh is None:
        return restarts, rnstream, None
    restarts = mesh_mod.shard_leading(restarts, mesh, "restarts")
    if not shard_stream:
        return restarts, rnstream, None
    return restarts, mesh_mod.shard_leading(rnstream, mesh, "mc"), mesh.group("mc")


def _gather_restarts(xs, vals, mesh):
    """(xs, vals) of every restart on every rank of `mesh`, in the order of
    the restarts before `shard_leading` split them (one all-reduce)."""
    both = mesh_mod.gather_leading(torch.cat([xs, vals[:, None]], dim=-1), mesh, "restarts")
    return both[:, :-1], both[:, -1]


def _final(simulate, xs, mesh, select_best):
    """The end of a solve at the final points xs: the values from a
    value-only pass, the restarts gathered over the 'restarts' axis of
    `mesh`, and with `select_best` the argmax restart (`_best`); a
    program's final graph and the eager route run it alike."""
    vals = simulate(xs, False).mu
    if mesh is not None:
        xs, vals = _gather_restarts(xs, vals, mesh)
    return _best(xs, vals) if select_best else (xs, vals)


def _multi_restart(state, tp, rule, xstarts, restarts, *, max_iters, lr, inner_iterations,
                   draw_mode, mesh, shard_stream, check_every=1, select_best=False):
    """SGA from every restart, then `_final`: (xs (R, d), values (R,),
    iterations), or the winner (x (d,), value ()) with `select_best`. With
    `mesh`, this rank takes its blocks (`_blocks`) and the steps run on the
    mesh: the eager mesh route, the same step functions as the programs'."""
    sample_size = tp.mc_iters
    restarts, rnstream, group = _blocks(restarts, tp.rnstream, mesh, shard_stream)
    tp = tp._replace(rnstream=rnstream)

    def simulate(xs, with_gradients):
        return mc_mod.simulate_trajectory_mc(
            state, tp._replace(x0=xs), rule, xstarts, with_gradients=with_gradients,
            iterations=inner_iterations, draw_mode=draw_mode, group=group)

    (xs, *_), it = _sga(
        lambda carry: _sga_step(simulate, carry, tp.lbs, tp.ubs, sample_size, lr, mesh),
        _sga_carry(restarts), max_steps=max_iters, check_every=check_every, mesh=mesh)
    with profiling.span("outer.final"):
        return (*_final(simulate, xs, mesh, select_best), it)


class _Problem(NamedTuple):
    """What a program reads of the problem besides the state and the
    stream: tp's theta and box and the inner starts."""

    theta: torch.Tensor
    lbs: torch.Tensor
    ubs: torch.Tensor
    xstarts: torch.Tensor


def _program_problem(state, tp, xstarts):
    """The `_Problem` of (tp, xstarts) as tensors of the state's dtype on its
    device (made here, outside any capture), and that device."""
    dt, dev = state.X.dtype, state.X.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    return _Problem(as_t(tp.theta), as_t(tp.lbs), as_t(tp.ubs), as_t(xstarts)), dev


def _program_simulator(st, rnstream, prob, rule, inner_iterations, draw_mode, group=None):
    """simulate(xs, with_gradients) of every restart of xs on (st, rnstream)
    and the `_Problem` prob, the statistics reduced over the ranks of
    `group`."""

    def simulate(xs, with_gradients):
        tp = TrajectoryParams(xs, prob.theta, prob.lbs, prob.ubs, rnstream)
        return mc_mod.simulate_trajectory_mc(
            st, tp, rule, prob.xstarts, with_gradients=with_gradients,
            iterations=inner_iterations, draw_mode=draw_mode, group=group)

    return simulate


def _program_mesh(mesh, dev, shard_stream=True):
    """(group, ranks) of a program built for `mesh` on `dev`: the group that
    reduces the statistics of the stream's blocks and the number of ranks
    along 'mc' whose blocks make the stream (None and 1 where the stream is
    whole). Raises where no graph can hold the mesh's collectives."""
    if not mesh_mod.programs_run_on(mesh, dev):
        raise ValueError(
            f"a program on {dev} cannot capture the collectives of a {mesh.backend} mesh "
            "(gloo runs them on the host): run the ranks with --backend nccl, one card per "
            "rank, or solve on the eager mesh route (no program)")
    if mesh is None or not shard_stream:
        return None, 1
    return mesh.group("mc"), mesh.coordinate("mc")[1]


def _graph(fn, dev, mesh):
    """fn as a `GraphProgram` on dev, marked as holding collectives where
    `mesh` has a process group (`utils.graphs.release_collectives`)."""
    return GraphProgram(fn, device=dev,
                        collectives=mesh is not None and mesh.group(mesh_mod.AXES) is not None)


def make_batched_grad_step(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, *, inner_iterations: int = 12,
                           draw_mode: str = "reparam"):
    """`step(st, rnstream, xs)` -> (values (R,), grads (R, d), stds (R, d)) of
    the MC rollout acquisition at the points xs (R, d), as one program: the
    JAX package's jitted building block of the stepped loop."""
    prob, dev = _program_problem(state, tp, xstarts)

    def step(st, rnstream, xs):
        eto = _program_simulator(st, rnstream, prob, rule, inner_iterations, draw_mode)(xs, True)
        return eto.mu, eto.grad_x, eto.std_grad_x

    return GraphProgram(step, device=dev)


def _sga_step_fn(rule, *, lr, inner_iterations, draw_mode, mesh, group, mc_ranks):
    """step(st, rnstream, prob, carry): `_sga_step` on the `_Problem` prob,
    the statistics of the stream's blocks reduced over `group`, whose
    `mc_ranks` ranks make the stream."""

    def step(st, rnstream, prob, carry):
        simulate = _program_simulator(st, rnstream, prob, rule, inner_iterations, draw_mode,
                                      group)
        return _sga_step(simulate, carry, prob.lbs, prob.ubs, rnstream.shape[0] * mc_ranks,
                         lr, mesh)

    return step


def make_batched_sga_step(state: sg.SurrogateState, tp: TrajectoryParams,
                          rule: DecisionRule, xstarts, *, lr: float = 0.01,
                          inner_iterations: int = 12, draw_mode: str = "reparam",
                          mesh=None):
    """`step(st, rnstream, carry)` -> carry: one SGA iteration (`_sga_step`:
    simulate, eswavs freeze, Adam, clamp) over the carry (xs, AdamState,
    done, vals) as one program. The sample size is the stream's length;
    the new vals are the values at the points before the step.

    `mesh`: the step of one rank of it, on that rank's blocks of rnstream
    (along 'mc', whose ranks reduce the statistics) and of the carry's
    restarts (along 'restarts'); it returns (carry, active), the restarts
    still active summed over the world, and its graph holds both
    collectives."""
    prob, dev = _program_problem(state, tp, xstarts)
    group, mc_ranks = _program_mesh(mesh, dev)
    step = _sga_step_fn(rule, lr=lr, inner_iterations=inner_iterations, draw_mode=draw_mode,
                        mesh=mesh, group=group, mc_ranks=mc_ranks)
    return _graph(lambda st, rnstream, carry: step(st, rnstream, prob, carry), dev, mesh)


class _ScannedSGAProgram:
    """A scanned-SGA program with the number of steps it holds, which
    `stochastic_solve_scanned` reads in place of its own argument, and on a
    mesh the mesh and the graph that gathers the restarts."""

    def __init__(self, fn, steps_per_call: int, mesh=None, gather=None):
        self._fn = fn
        self.steps_per_call = int(steps_per_call)
        self.mesh, self.gather = mesh, gather
        self.graphs = (fn,) if gather is None else (fn, gather)

    def __call__(self, st, rnstream, carry):
        return self._fn(st, rnstream, carry)


def make_scanned_sga_program(state: sg.SurrogateState, tp: TrajectoryParams,
                             rule: DecisionRule, xstarts, *, steps_per_call: int = 10,
                             lr: float = 0.01, inner_iterations: int = 12,
                             draw_mode: str = "reparam", mesh=None):
    """`program(st, rnstream, carry)` -> carry: `steps_per_call` k SGA
    iterations (`make_batched_sga_step`'s) and then the value-only pass at
    the final points, whose values are the new carry's vals, all as one
    program (one CUDA graph on the card). The JAX program scores the final
    points with a pass that also takes gradients; the values are the same.
    The returned program carries `steps_per_call`.

    `mesh`: as `make_batched_sga_step`'s, the window on one rank's blocks,
    returning (carry, active); the program's `gather` graph joins the
    ranks' restarts after the last window (`stochastic_solve_scanned`)."""
    prob, dev = _program_problem(state, tp, xstarts)
    group, mc_ranks = _program_mesh(mesh, dev)

    def program(st, rnstream, carry):
        simulate = _program_simulator(st, rnstream, prob, rule, inner_iterations, draw_mode,
                                      group)
        active = None
        for _ in range(steps_per_call):
            carry = _sga_step(simulate, carry, prob.lbs, prob.ubs,
                              rnstream.shape[0] * mc_ranks, lr, mesh)
            if mesh is not None:
                carry, active = carry
        xs, opt, done, _ = carry
        carry = (xs, opt, done, simulate(xs, False).mu)
        return carry if mesh is None else (carry, active)

    gather = None
    if mesh is not None:
        gather = _graph(lambda xs, vals: _gather_restarts(xs, vals, mesh), dev, mesh)
    return _ScannedSGAProgram(_graph(program, dev, mesh), steps_per_call, mesh, gather)


class _FusedSGAProgram:
    """The whole multi-restart SGA solve (`make_fused_sga_program`): the
    step program replayed until every restart has stopped or `max_iters`
    is reached, "all stopped" read on the host after each step, then the
    final program. `iterations` holds the SGA iterations of the last call.
    On a mesh it takes this rank's blocks of its inputs first (`_blocks`).
    Both graphs take the `_Problem` as an input: the one the program was
    built for, or a call's `problem` of the same shapes."""

    def __init__(self, step, final, problem, max_iters: int, select_best: bool, mesh=None,
                 shard_stream=True):
        self.step, self.final, self.problem = step, final, problem
        self.max_iters, self.select_best = max_iters, select_best
        self.mesh, self.shard_stream = mesh, shard_stream
        self.graphs = (step, final)
        self.iterations = 0

    def __call__(self, st, rnstream, xs0, problem=None):
        prob = self.problem if problem is None else problem
        xs0, rnstream, _ = _blocks(xs0, rnstream, self.mesh, self.shard_stream)
        carry, self.iterations = _sga(lambda c: self.step(st, rnstream, prob, c),
                                      _sga_carry(xs0), max_steps=self.max_iters, mesh=self.mesh)
        with profiling.span("outer.final"):
            return self.final(st, rnstream, prob, carry[0])


def _fused_program(state, tp, rule, xstarts, *, max_iters, lr, inner_iterations, draw_mode,
                   select_best, mesh, shard_stream):
    """`make_fused_sga_program`, with the stream's blocks split over 'mc'
    (`shard_stream`) or whole on every rank (the batch solve's placement)."""
    prob, dev = _program_problem(state, tp, xstarts)
    group, mc_ranks = _program_mesh(mesh, dev, shard_stream)
    step = _sga_step_fn(rule, lr=lr, inner_iterations=inner_iterations, draw_mode=draw_mode,
                        mesh=mesh, group=group, mc_ranks=mc_ranks)

    def final(st, rnstream, prob, xs):
        simulate = _program_simulator(st, rnstream, prob, rule, inner_iterations, draw_mode,
                                      group)
        return _final(simulate, xs, mesh, select_best)

    return _FusedSGAProgram(_graph(step, dev, mesh), _graph(final, dev, mesh), prob,
                            max_iters, select_best, mesh, shard_stream)


def make_fused_sga_program(state: sg.SurrogateState, tp: TrajectoryParams,
                           rule: DecisionRule, xstarts, *, max_iters: int = 50,
                           lr: float = 0.01, inner_iterations: int = 12,
                           draw_mode: str = "reparam", select_best: bool = False,
                           mesh=None):
    """`program(st, rnstream, xs0)` -> (xs (R, d), vals (R,)): the whole
    multi-restart SGA solve from xs0, with the semantics of
    `stochastic_solve_fused` (the all-stopped test after every iteration,
    as the JAX program's `while_loop`), the values from a value-only pass
    at the final points. With `select_best` the argmax restart (the first
    of tied ones) is returned instead: (x_best (d,), v_best ()). The
    program's `iterations` attribute holds the SGA iterations of its last
    call. On the card one SGA step and the final pass are CUDA graphs.

    `mesh`: the solve on one rank of it, called with the whole stream and
    restarts as on one device: the program takes this rank's blocks (the
    restarts along 'restarts', the trajectories along 'mc'), its step graph
    holds the 'mc' statistics and the world-summed count of the restarts
    still active (the one value the host reads between replays), and its
    final graph the 'restarts' gather and the argmax; every rank returns
    the same. Raises for a gloo mesh on CUDA tensors, whose collectives no
    graph can hold."""
    return _fused_program(state, tp, rule, xstarts, max_iters=max_iters, lr=lr,
                          inner_iterations=inner_iterations, draw_mode=draw_mode,
                          select_best=select_best, mesh=mesh, shard_stream=True)


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
    as in the JAX package); it must have been built for this call's `mesh`
    (or for none without one), takes no `steps_per_call`, and its
    `select_best` must be this call's.
    """
    if program is not None:
        _check_program_mesh(program, mesh)
        if steps_per_call != 1 or program.select_best != select_best:
            raise ValueError("a fused program tests 'all stopped' after every iteration and "
                             f"has its own select_best: steps_per_call {steps_per_call}, "
                             f"select_best {select_best} (the program's "
                             f"{program.select_best})")
        x, value = program(state, tp.rnstream, restarts)
        return FusedSolve(x, value, program.iterations)
    return FusedSolve(*_multi_restart(
        state, tp, rule, xstarts, restarts,
        max_iters=-(-max_iters // steps_per_call) * steps_per_call, lr=lr,
        inner_iterations=inner_iterations, draw_mode=draw_mode, mesh=mesh,
        shard_stream=True, check_every=steps_per_call, select_best=select_best))


def _check_program_mesh(program, mesh) -> None:
    """Raise unless `program` was built for `mesh` (or for none, without one;
    a callable with no `mesh` stands for a one-device program)."""
    built_for = getattr(program, "mesh", None)
    if built_for != mesh:
        raise ValueError(f"a program built for mesh {built_for} cannot solve on mesh "
                         f"{mesh}: build it with this call's mesh")


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
    call per window; its own `steps_per_call` overrides the argument, and
    a program built for a mesh solves on it (`_scanned_program_solve`)."""
    if program is None:
        fs = stochastic_solve_fused(state, tp, rule, xstarts, starts, max_iters=max_iters,
                                    lr=lr, inner_iterations=inner_iterations,
                                    draw_mode=draw_mode, steps_per_call=steps_per_call)
        return fs.x, fs.value
    fs = _scanned_program_solve(program, state, tp.rnstream, starts, max_iters)
    return fs.x, fs.value


def _scanned_program_solve(program, state, rnstream, starts, max_iters) -> FusedSolve:
    """`stochastic_solve_scanned` through a scanned program, one call per
    window: (xs, values at them, SGA iterations run). A program built for a
    mesh runs on this rank's blocks and gathers the restarts at the end."""
    mesh = program.mesh
    starts, rnstream, _ = _blocks(starts, rnstream, mesh, True)
    (xs, _, _, vals), calls = _sga(lambda c: program(state, rnstream, c), _sga_carry(starts),
                                   max_steps=-(-max_iters // program.steps_per_call),
                                   mesh=mesh)
    with profiling.span("outer.final"):     # the values came with the last window
        if mesh is not None:
            xs, vals = program.gather(xs, vals)
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


def _ghq_step(simulate, carry, lbs, ubs, *, lr, grad_tol, mesh=None):
    """One Adam iteration of the quadrature objective over the carry (xs,
    opt, active): a restart whose gradient norm falls below grad_tol keeps
    the point it had and takes no further part (the JAX package's
    per-restart `while_loop` under `vmap`). On a rank of `mesh` it returns
    (carry, `_active_count` of the new carry)."""
    xs, opt, active = carry
    eto = simulate(xs, True)
    stop = torch.linalg.vector_norm(eto.grad_x, dim=-1) < grad_tol
    opt, xs_new = adam_update(opt, xs, eto.grad_x, lr=lr)
    xs_new = torch.clamp(xs_new, lbs, ubs)
    xs = torch.where((active & ~stop)[..., None], xs_new, xs)
    carry = (xs, opt, active & ~stop)
    return carry if mesh is None else (carry, _active_count(carry[2], mesh))


def _deterministic_ascent(step, xs, *, max_iters, mesh=None):
    """carry = step(carry) from the carry at xs (R, d), all restarts together
    (`_ghq_step` eagerly, or a replay of its graph), until none is active
    (read on the host after each step; on a mesh, none on any rank) or
    after `max_iters`. Returns the final points. A restart that stopped
    keeps its point, so the steps a rank runs after its own restarts have
    stopped change none of them."""
    (xs, *_), _ = _sga(step, _ghq_carry(xs), max_steps=max_iters, mesh=mesh,
                       stopped=lambda carry: not bool(carry[2].any()))
    return xs


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
    `mesh`: the restarts split over its 'restarts' axis, the ascent run
    until no restart is active on any rank (the world-summed count, as the
    JAX loop's all-reduced predicate), the results gathered: the eager
    mesh route of `make_deterministic_program(mesh=...)`."""
    simulate, as_t, lbs, ubs = _ghq_simulator(
        state, theta, lbs, ubs, xstarts, rule, horizon=horizon, num_nodes=num_nodes,
        inner_iterations=inner_iterations, node_scale=node_scale)
    starts, _, _ = _blocks(as_t(starts), None, mesh, False)
    step = lambda c: _ghq_step(simulate, c, lbs, ubs, lr=lr, grad_tol=grad_tol,  # noqa: E731
                               mesh=mesh)
    xs = _deterministic_ascent(step, starts, max_iters=max_iters, mesh=mesh)
    return _final(simulate, xs, mesh, False)


class _DeterministicProgram:
    """The Gauss-Hermite solve from every restart (`make_deterministic_program`):
    the step program through `_deterministic_ascent` (as `_FusedSGAProgram`
    runs its step through `_sga`), then the final program; on a mesh from
    this rank's block of the restarts."""

    def __init__(self, step, final, max_iters: int, mesh=None):
        self.step, self.final, self.max_iters, self.mesh = step, final, max_iters, mesh
        self.graphs = (step, final)

    def __call__(self, st, starts):
        starts, _, _ = _blocks(starts, None, self.mesh, False)
        xs = _deterministic_ascent(lambda c: self.step(st, c), starts, max_iters=self.max_iters,
                                   mesh=self.mesh)
        with profiling.span("outer.final"):
            return self.final(st, xs)


def make_deterministic_program(state: sg.SurrogateState, theta, lbs, ubs, xstarts,
                               rule: DecisionRule, *, horizon: int, num_nodes: int = 8,
                               max_iters: int = 50, lr: float = 0.01, grad_tol: float = 1e-4,
                               inner_iterations: int = 12, node_scale: float = 1.0,
                               select_best: bool = False, mesh=None):
    """`program(st, starts)` -> (xs (R, d), vals (R,)): `deterministic_solve_batch`
    from the restarts starts (R, d) on the state st, as a program (the JAX
    package jits that solve with its argmax). With `select_best` the argmax
    restart (the first of tied ones) is returned instead: (x_best (d,),
    v_best ()). On the card one Adam step and the final value pass are CUDA
    graphs; the quadrature tables are made here, outside their captures.
    `mesh`: the solve on one rank of it (`deterministic_solve_batch(mesh=)`'s
    placement), the step graph holding the world-summed count of the
    restarts still active, the final graph the gather and the argmax."""
    simulate, _, lbs, ubs = _ghq_simulator(
        state, theta, lbs, ubs, xstarts, rule, horizon=horizon, num_nodes=num_nodes,
        inner_iterations=inner_iterations, node_scale=node_scale)
    dev = state.X.device
    _program_mesh(mesh, dev, shard_stream=False)

    def step(st, carry):
        return _ghq_step(lambda x, g: simulate(x, g, st=st), carry, lbs, ubs, lr=lr,
                         grad_tol=grad_tol, mesh=mesh)

    def final(st, xs):
        return _final(lambda x, g: simulate(x, g, st=st), xs, mesh, select_best)

    return _DeterministicProgram(_graph(step, dev, mesh), _graph(final, dev, mesh), max_iters,
                                 mesh)
