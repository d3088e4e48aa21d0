"""Sharded rollout-acquisition evaluation and outer policy optimization.

Port of `rollout_bo_tpu/parallel/sharded.py`. There the single-device
programs are jitted with their inputs placed by NamedShardings and GSPMD
inserts the collectives. Here the estimator and the solvers take the mesh
themselves (`mc.simulate_trajectory_mc(group=...)`,
`outer.stochastic_solve_fused(mesh=...)`), and these wrappers place the
inputs as the JAX package's do: the surrogate state replicated from rank 0,
the restarts and the trajectories split as each function names. Every
rank of the mesh calls them and gets the same, replicated, result.
"""

from __future__ import annotations

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import DecisionRule
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.parallel.mesh import AXES, Mesh
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout import outer as outer_mod
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

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
    over all of them and every rank returns the same."""
    rn = mesh_mod.shard_leading(tp.rnstream, mesh, AXES)
    return mc_mod.simulate_trajectory_mc(
        mesh_mod.replicate(state, mesh), tp._replace(rnstream=rn), rule, xstarts,
        with_gradients=with_gradients, iterations=iterations, draw_mode=draw_mode,
        group=mesh.group(AXES))


def sharded_stochastic_solve_batch(state: sg.SurrogateState, tp: TrajectoryParams,
                                   rule: DecisionRule, xstarts, starts, mesh: Mesh, *,
                                   max_iters: int = 50, lr: float = 0.01,
                                   inner_iterations: int = 12, draw_mode: str = "reparam"):
    """Multi-restart SGA with the restarts split over mesh axis 'restarts'
    and the stream replicated. Returns (xs (R, d), values (R,)) on every
    rank; their argmax is the reference's distributed winner reduction
    (adaptive_bayesopt.jl:483-488)."""
    return outer_mod.stochastic_solve_batch(
        mesh_mod.replicate(state, mesh), tp, rule, xstarts, starts, max_iters=max_iters,
        lr=lr, inner_iterations=inner_iterations, draw_mode=draw_mode, mesh=mesh)


def sharded_stochastic_solve_fused(state: sg.SurrogateState, tp: TrajectoryParams,
                                   rule: DecisionRule, xstarts, starts, mesh: Mesh, *,
                                   max_iters: int = 50, lr: float = 0.01,
                                   inner_iterations: int = 12, draw_mode: str = "reparam",
                                   select_best: bool = False) -> outer_mod.FusedSolve:
    """The fused outer solver (the bench's and the non-myopic loop's) on a
    mesh: restarts over axis 'restarts' and trajectories over axis 'mc' at
    once, the two embarrassingly parallel axes of the reference's intended
    fan-out (adaptive_bayesopt.jl:483-488). Returns the `FusedSolve` of
    `outer.stochastic_solve_fused` on every rank."""
    return outer_mod.stochastic_solve_fused(
        mesh_mod.replicate(state, mesh), tp, rule, xstarts, starts, max_iters=max_iters,
        lr=lr, inner_iterations=inner_iterations, draw_mode=draw_mode,
        select_best=select_best, mesh=mesh)


def sharded_stochastic_solve_scanned(state: sg.SurrogateState, tp: TrajectoryParams,
                                     rule: DecisionRule, xstarts, starts, mesh: Mesh, *,
                                     max_iters: int = 50, steps_per_call: int = 10,
                                     lr: float = 0.01, inner_iterations: int = 12,
                                     draw_mode: str = "reparam"):
    """The scanned outer solver (`outer.stochastic_solve_scanned`: whole
    windows of `steps_per_call`) on a mesh, placed as the fused one is:
    restarts over axis 'restarts', trajectories over axis 'mc'. Returns
    (xs (R, d), values (R,)) on every rank."""
    fs = outer_mod.stochastic_solve_fused(
        mesh_mod.replicate(state, mesh), tp, rule, xstarts, starts, max_iters=max_iters,
        lr=lr, inner_iterations=inner_iterations, draw_mode=draw_mode, mesh=mesh,
        steps_per_call=steps_per_call)
    return fs.x, fs.value
