"""Sharded rollout-acquisition evaluation and outer policy optimization.

Port of `rollout_bo_tpu/parallel/sharded.py`. There the single-device
programs are jitted with their inputs placed by NamedShardings and GSPMD
inserts the collectives. Here the programs take the mesh themselves
(`outer.make_fused_sga_program(mesh=...)` and the other factories), shard
their inputs and hold the collectives in their CUDA graphs, which NCCL runs
on the card; these wrappers place the inputs as the JAX package's do: the
surrogate state replicated from rank 0 (outside the program, as
`jax.device_put` is outside the jit), the restarts and the trajectories
split as each function names. Every rank of the mesh calls them and gets
the same, replicated, result.

`sharded_simulate_mc` and `sharded_stochastic_solve_batch` run through a
program kept per (rule, mesh, settings, device) in
`utils.graphs.cached_program`, every tensor of the problem an input of its
graphs, so that repeated calls replay them; the fused and scanned solves run the caller's `program=` or
build one, as the JAX ones do. On a gloo mesh with CUDA tensors no graph
can hold the collectives (gloo runs them on the host): there every
function takes the eager mesh route, by that rule
(`parallel.mesh.programs_run_on`), and a program passed in is refused.
"""

from __future__ import annotations

import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.parallel.mesh import AXES, Mesh
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout import outer as outer_mod
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams
from rollout_bo_tpu_torch.utils import graphs

__all__ = [
    "sharded_simulate_mc",
    "sharded_stochastic_solve_batch",
    "sharded_stochastic_solve_fused",
    "sharded_stochastic_solve_scanned",
]


def sharded_simulate_mc(state: sg.SurrogateState, tp: TrajectoryParams, rule: DecisionRule,
                        xstarts, mesh: Mesh, *, with_gradients: bool = True,
                        iterations: int = 12, draw_mode: str = "reparam"):
    """simulate_trajectory_mc with the trajectories of tp.rnstream split
    over every rank of the mesh (both axes); the statistics are reduced
    over all of them and every rank returns the same. One program per
    (rule, mesh, with_gradients, iterations, draw_mode, device) takes every
    tensor as an input, so a repeated call replays its graph."""
    state = mesh_mod.replicate(state, mesh)
    prob, dev = outer_mod._program_problem(state, tp, xstarts)
    tp = TrajectoryParams(torch.as_tensor(tp.x0, dtype=state.X.dtype, device=dev), prob.theta,
                          prob.lbs, prob.ubs,
                          mesh_mod.shard_leading(tp.rnstream, mesh, AXES))
    group = mesh.group(AXES)

    def simulate(st, tpx, xs):
        return mc_mod.simulate_trajectory_mc(st, tpx, rule, xs, with_gradients=with_gradients,
                                             iterations=iterations, draw_mode=draw_mode,
                                             group=group)

    if not mesh_mod.programs_run_on(mesh, dev):
        return simulate(state, tp, prob.xstarts)
    program = graphs.cached_program(
        ("sharded_simulate_mc", rule, mesh, with_gradients, iterations, draw_mode, str(dev)),
        lambda: outer_mod._graph(simulate, dev, mesh))
    return program(state, tp, prob.xstarts)


def sharded_stochastic_solve_batch(state: sg.SurrogateState, tp: TrajectoryParams,
                                   rule: DecisionRule, xstarts, starts, mesh: Mesh, *,
                                   max_iters: int = 50, lr: float = 0.01,
                                   inner_iterations: int = 12, draw_mode: str = "reparam"):
    """Multi-restart SGA with the restarts split over mesh axis 'restarts'
    and the stream replicated. Returns (xs (R, d), values (R,)) on every
    rank; their argmax is the reference's distributed winner reduction
    (adaptive_bayesopt.jl:483-488). Runs the fused program of this
    placement, kept per (rule, mesh, solver settings, dtype, device): tp's
    theta and box and xstarts are inputs of its graphs, as the state and the
    stream are, so a call with new values replays them."""
    state = mesh_mod.replicate(state, mesh)
    prob, dev = outer_mod._program_problem(state, tp, xstarts)
    kw = dict(max_iters=max_iters, lr=lr, inner_iterations=inner_iterations,
              draw_mode=draw_mode)
    if not mesh_mod.programs_run_on(mesh, dev):
        return outer_mod.stochastic_solve_batch(state, tp, rule, xstarts, starts, mesh=mesh,
                                                **kw)
    key = ("sharded_batch", rule, mesh, max_iters, lr, inner_iterations, draw_mode,
           str(state.X.dtype), str(dev))
    program = graphs.cached_program(key, lambda: outer_mod._fused_program(
        state, tp, rule, xstarts, select_best=False, mesh=mesh, shard_stream=False, **kw))
    return program(state, tp.rnstream, starts, problem=prob)


def sharded_stochastic_solve_fused(state: sg.SurrogateState, tp: TrajectoryParams,
                                   rule: DecisionRule, xstarts, starts, mesh: Mesh, *,
                                   max_iters: int = 50, lr: float = 0.01,
                                   inner_iterations: int = 12, draw_mode: str = "reparam",
                                   select_best: bool = False,
                                   program=None) -> outer_mod.FusedSolve:
    """The fused outer solver (the bench's and the non-myopic loop's) on a
    mesh: restarts over axis 'restarts' and trajectories over axis 'mc' at
    once, the two embarrassingly parallel axes of the reference's intended
    fan-out (adaptive_bayesopt.jl:483-488). Returns the `FusedSolve` of
    `outer.stochastic_solve_fused` on every rank. `program`: a
    `make_fused_sga_program` built for this mesh, whose own settings hold;
    without one this call builds one (a CUDA graph per signature)."""
    state = mesh_mod.replicate(state, mesh)
    kw = dict(max_iters=max_iters, lr=lr, inner_iterations=inner_iterations,
              draw_mode=draw_mode, select_best=select_best)
    if program is None and mesh_mod.programs_run_on(mesh, state.X.device):
        program = outer_mod.make_fused_sga_program(state, tp, rule, xstarts, mesh=mesh, **kw)
    return outer_mod.stochastic_solve_fused(state, tp, rule, xstarts, starts, mesh=mesh,
                                            program=program, **kw)


def sharded_stochastic_solve_scanned(state: sg.SurrogateState, tp: TrajectoryParams,
                                     rule: DecisionRule, xstarts, starts, mesh: Mesh, *,
                                     max_iters: int = 50, steps_per_call: int = 10,
                                     lr: float = 0.01, inner_iterations: int = 12,
                                     draw_mode: str = "reparam", program=None):
    """The scanned outer solver (`outer.stochastic_solve_scanned`: whole
    windows of `steps_per_call`) on a mesh, placed as the fused one is:
    restarts over axis 'restarts', trajectories over axis 'mc'. Returns
    (xs (R, d), values (R,)) on every rank. `program`: a
    `make_scanned_sga_program` built for this mesh; without one this call
    builds one."""
    state = mesh_mod.replicate(state, mesh)
    kw = dict(lr=lr, inner_iterations=inner_iterations, draw_mode=draw_mode)
    if program is None:
        if not mesh_mod.programs_run_on(mesh, state.X.device):
            fs = outer_mod.stochastic_solve_fused(state, tp, rule, xstarts, starts,
                                                  max_iters=max_iters, mesh=mesh,
                                                  steps_per_call=steps_per_call, **kw)
            return fs.x, fs.value
        program = outer_mod.make_scanned_sga_program(state, tp, rule, xstarts, mesh=mesh,
                                                     steps_per_call=steps_per_call, **kw)
    outer_mod._check_program_mesh(program, mesh)
    return outer_mod.stochastic_solve_scanned(state, tp, rule, xstarts, starts,
                                              max_iters=max_iters, program=program, **kw)
