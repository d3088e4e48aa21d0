"""Bayesian-optimization loops: myopic (EI / POI / LCB / Random baselines),
non-myopic (rollout acquisition) and adaptive-horizon (rollout acquisition
at a horizon that follows a schedule).

Port of `rollout_bo_tpu/rollout/bo.py` (reference
`experiments/myopic_bayesopt.jl:207-263`, `adaptive_bayesopt.jl:479-526`).
Each loop is a Python loop over BO iterations: acquisition solve ->
true-function evaluation -> rank-1 condition -> hyperparameter MLE. Every
step that the JAX package runs as a jitted program is a program here
(`utils.graphs.GraphProgram`: CUDA graphs on the card, the function run
eagerly elsewhere), taken from `_cached_program` under the JAX package's
key with the device added, so that one capture serves every BO iteration
of a trial and every trial with the same key:

- "myopic_chunk": the solve of one myopic BO iteration, called with
  "nm_observe" k times for a chunk of k, the state on the device and one
  host read per chunk (`run_myopic_bo`); its key is the JAX package's
  without the chunk length, which the one iteration's program does not
  depend on;
- "nm_observe": the true function at the new point, the condition on it
  and the MLE when due (`_observer`, `_observe_program`), in both loops;
- "nm_fallback": the exploration fallback;
- "nm_acquire" / "ad_acquire": the rollout acquisition
  (`outer.make_fused_sga_program` for "fused" and "batch",
  `make_scanned_sga_program`, `make_deterministic_program`).

The JAX package computes the MLE on every call and selects it with a
traced mask. Whether it is due is known on the host, so here it is a
constant of the program: a program has at most two graphs per signature,
and a loop that never refits (the adaptive one) never captures a refit.
On a mesh the acquisitions are the same factories' mesh programs, under
the key with the mesh's shape and backend added (their graphs hold the
NCCL collectives); the observe and fallback programs are rank-local and
serve it too. A gloo mesh on CUDA tensors runs the acquisitions in the
eager loop: no graph can hold a gloo collective, which runs on the host
(`parallel.mesh.programs_run_on`).

The host reads what the loop needs: per iteration the acquisition's best
value (non-myopic, to decide on the fallback) and the new point with its
observation; in the myopic loop, one chunk's points and observations.

Every BO iteration (every myopic chunk) keeps a trace record
(`utils.profiling`): spans `bo.iteration` (`bo.chunk`) > `bo.acquire`
(> `bo.fallback`) and `bo.observe`, the counters, and the device time of
its graph replays, kept in `profiling.RECORDS`.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import EI, DecisionRule, LogEI
from rollout_bo_tpu_torch.models.testfns import TestFunction
from rollout_bo_tpu_torch.ops import kernels as kern
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.rollout import outer as outer_mod
from rollout_bo_tpu_torch.rollout import solvers
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams
from rollout_bo_tpu_torch.utils import checkpoint as ckpt
from rollout_bo_tpu_torch.utils import graphs
from rollout_bo_tpu_torch.utils import metrics, profiling
from rollout_bo_tpu_torch.utils.graphs import GraphProgram

__all__ = ["MyopicBOResult", "run_myopic_bo", "run_nonmyopic_bo", "run_adaptive_bo",
           "alternating_horizon", "fixed_horizon", "truncated_horizon"]


# the JAX package's name for its cache of jitted programs; the cache, which
# the sharded functions share, is `utils.graphs.PROGRAM_CACHE`
_cached_program = graphs.cached_program


@dataclass
class MyopicBOResult:
    X: np.ndarray                # (n_init + budget, d) all sampled points
    y: np.ndarray                # (n_init + budget,)
    gaps: np.ndarray             # (budget,) gap before each new sample
    simple_regrets: np.ndarray   # (budget,)
    minimum_observations: np.ndarray  # (budget,)
    times: np.ndarray            # (budget,) acquisition wall seconds (myopic:
    # of the whole BO iteration, uniform within a chunk)
    state: sg.SurrogateState = field(repr=False, default=None)
    # non-myopic and adaptive only: outer SGA iterations and whether the
    # exploration fallback was taken, per BO iteration run by this call
    sga_iterations: np.ndarray | None = None
    fallbacks: np.ndarray | None = None
    # adaptive only: device bytes allocated above the level before each
    # acquisition at its peak (the reference's @timed bytes); 0 on the CPU
    allocations: np.ndarray | None = None


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Trial:
    """What both loops share: the initial design and surrogate, the metric
    arrays, the snapshot and the observe step. Only a `lead` trial writes
    snapshots (rank 0 of a mesh; every rank reads them)."""

    def __init__(self, testfn, *, budget, n_init, num_starts, seed, kernel, noise,
                 kernel_lbs, kernel_ubs, mle_every, dtype, device, x_init,
                 checkpoint_path, checkpoint_every, lead=True):
        self.testfn = testfn
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        lbs, ubs = testfn.lbs, testfn.ubs
        if x_init is None:
            x_init = qmc.randsample(n_init, testfn.dim, lbs, ubs, self.rng)
        y_init = testfn.batch(torch.as_tensor(x_init, dtype=torch.float64)).numpy()
        self.capacity = n_init + budget
        kernel = kernel or kern.matern52(device=self.device, dtype=dtype)
        self.state = sg.fit(kernel, x_init, y_init, capacity=self.capacity,
                            noise=noise, device=self.device, dtype=dtype)
        # what a cached program bakes in of the problem (the JAX _shape_key)
        self.shape_key = (self.capacity, testfn.dim, str(dtype), kernel.kind,
                          tuple(np.asarray(lbs).tolist()), tuple(np.asarray(ubs).tolist()),
                          str(self.device))
        # np.array copies: the box bounds are strided views of (d, 2)
        self.as_t = lambda a: torch.tensor(np.array(a), dtype=dtype, device=self.device)
        self.lbs, self.ubs = self.as_t(lbs), self.as_t(ubs)
        self.xstarts = self.as_t(qmc.generate_initial_guesses(num_starts, lbs, ubs))
        self.klbs, self.kubs = self.as_t(kernel_lbs), self.as_t(kernel_ubs)
        self.bounds_key = (tuple(np.asarray(kernel_lbs, dtype=float).tolist()),
                           tuple(np.asarray(kernel_ubs, dtype=float).tolist()))
        self.mle_every = mle_every
        self.true_minimum = testfn.fmin
        self.initial_best = float(y_init.min())
        self.gaps, self.regrets = np.zeros(budget), np.zeros(budget)
        self.min_obs, self.times = np.zeros(budget), np.zeros(budget)
        self.X_all = [np.asarray(x) for x in x_init]
        self.y_all = list(map(float, y_init))
        self.checkpoint_path, self.checkpoint_every = checkpoint_path, checkpoint_every
        self.lead = lead
        self.start = 0
        if checkpoint_path is not None and os.path.exists(
                checkpoint_path if checkpoint_path.endswith(".npz")
                else checkpoint_path + ".npz"):
            self.state, self.start, saved = ckpt.load_bo_checkpoint(
                checkpoint_path, capacity=self.capacity, device=self.device)
            b = self.start
            self.gaps[:b] = saved["gaps"][:b]
            self.regrets[:b] = saved["simple_regrets"][:b]
            self.min_obs[:b] = saved["minimum_observations"][:b]
            self.times[:b] = saved["times"][:b]
            self.X_all = [np.asarray(x) for x in saved["X_all"]]
            self.y_all = list(map(float, saved["y_all"]))

    def observe(self, b: int, observe, xnext) -> None:
        """Record the gap before the observation; run `observe`, the observe
        program (the true function at xnext, the condition on it and the
        hyperparameter MLE when due); snapshot when due. A span of the
        iteration's trace record: `bo.observe`."""
        with profiling.span("bo.observe"):
            best = min(self.y_all)               # the incumbent BEFORE this observation
            self.gaps[b] = metrics.gap(self.initial_best, best, self.true_minimum)
            self.regrets[b] = metrics.simple_regret(self.true_minimum, best)
            refit = (b + 1) % self.mle_every == 0
            profiling.note_refit(refit)
            self.state, ynext = observe(self.state, xnext, refit)
            xy = torch.cat([xnext, ynext[None]]).cpu().numpy().astype(float)  # one read
            self.X_all.append(xy[:-1])
            self.y_all.append(float(xy[-1]))
            self.min_obs[b] = min(self.y_all)
            if (b + 1) % self.checkpoint_every == 0:
                self.snapshot(b + 1)

    def record_chunk(self, b: int, rows: np.ndarray, seconds: float) -> None:
        """Record the BO iterations b, b + 1, ... of one myopic chunk from its
        rows (k, d + 1): x and y, float64; the incumbent before each and
        after it is the running minimum over every observation; each
        iteration's time is the chunk's over k."""
        k, d = rows.shape[0], self.testfn.dim
        after = np.minimum.accumulate(np.concatenate([[min(self.y_all)], rows[:, d]]))
        self.gaps[b:b + k] = [metrics.gap(self.initial_best, float(v), self.true_minimum)
                              for v in after[:-1]]
        self.regrets[b:b + k] = [metrics.simple_regret(self.true_minimum, float(v))
                                 for v in after[:-1]]
        self.min_obs[b:b + k] = after[1:]
        self.times[b:b + k] = seconds / k
        self.X_all.extend(rows[:, :d])
        self.y_all.extend(map(float, rows[:, d]))

    def snapshot(self, iteration: int) -> None:
        """Save the trial after `iteration` BO iterations (a lead trial with
        a checkpoint path only)."""
        if self.lead and self.checkpoint_path is not None:
            ckpt.save_bo_checkpoint(
                self.checkpoint_path, self.state, iteration=iteration,
                metrics=dict(gaps=self.gaps, simple_regrets=self.regrets,
                             minimum_observations=self.min_obs, times=self.times,
                             X_all=np.stack(self.X_all), y_all=np.asarray(self.y_all)))

    def result(self, **extra) -> MyopicBOResult:
        return MyopicBOResult(
            X=np.stack(self.X_all), y=np.asarray(self.y_all), gaps=self.gaps,
            simple_regrets=self.regrets, minimum_observations=self.min_obs,
            times=self.times, state=self.state, **extra)


def _observer(testfn: TestFunction, klbs, kubs):
    """observe(state, xnext, do_mle) -> (state, ynext): the true function at
    xnext, the rank-1 condition on it and, with `do_mle`, the
    hyperparameter MLE in [klbs, kubs] (the JAX package's observe program,
    its traced MLE mask a constant here)."""

    def observe(state, xnext, do_mle: bool):
        ynext = testfn.f(xnext)
        state = sg.condition(state, xnext, ynext)
        if do_mle:
            state = sg.optimize_hypers(state, klbs, kubs)
        return state, ynext

    return observe


def _observe_program(t: _Trial):
    """The observe step as a program, cached as the JAX package caches it
    ("nm_observe")."""
    return _cached_program(
        ("nm_observe", id(t.testfn)) + t.bounds_key + (t.shape_key,),
        lambda: GraphProgram(_observer(t.testfn, t.klbs, t.kubs), device=t.device))


def _myopic_solve(rule, theta, lbs, ubs, xstarts, solver_iterations):
    """solve(state, u) -> x: the solve of one myopic BO iteration (the body
    of the JAX package's `trial_chunk` scan, up to the observe step): the
    lane solver's next point, or with `u` (the Random rule's uniform draw,
    made on the host) `solvers.random_point`."""

    def solve(state, u):
        if u is None:
            return solvers.multistart_maximize(state, rule, theta, lbs, ubs, xstarts,
                                               iterations=solver_iterations).x
        return solvers.random_point(lbs, ubs, u)

    return solve


def run_myopic_bo(
    testfn: TestFunction,
    rule: DecisionRule,
    *,
    budget: int = 100,
    theta=(0.0,),
    n_init: int = 5,
    num_starts: int = 64,
    seed: int = 1906,
    kernel: kern.RBFKernel | None = None,
    kernel_lbs=(0.1,),
    kernel_ubs=(5.0,),
    noise: float = 1e-6,
    mle_every: int = 1,
    solver_iterations: int = 12,
    dtype=torch.float64,
    device="cuda",
    x_init: np.ndarray | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    steps_per_call: int = 0,
) -> MyopicBOResult:
    """One myopic BO trial (protocol of myopic_bayesopt.jl:94-263).

    5 uniform initial samples, Matern-5/2 + per-iteration MLE in [0.1, 5],
    `num_starts` Sobol multistarts + 2 near-boundary points per solve: one
    lane-solver call per BO iteration.

    The BO iterations run in chunks of `steps_per_call` (the JAX package's
    semantics): 0 = the whole budget, or `checkpoint_every` when
    checkpointing; 1 = one iteration per chunk. A chunk of k calls the
    "myopic_chunk" program of one BO iteration's solve and the observe
    program from `_cached_program` k times each (on the card 2k replays of
    their CUDA graphs, so that each iteration's solve and observe step
    have device times of their own: the record's `steps`), the state
    passed on the device from one to the next, and the host reads the
    chunk's points once, at its end. `times[b]` is the wall time of b's
    chunk over its length: solve, observe, condition and MLE, synchronized
    with the device. The points do not depend on the chunk size.

    The Random rule draws its uniforms on the host from a CPU
    `torch.Generator` seeded with `seed`, a chunk's draws before the chunk
    in the order the iterations take them; it runs no MLE.

    If `checkpoint_path` is given, the surrogate + metric arrays are
    snapshotted every `checkpoint_every` iterations, at the end of a chunk,
    and a crashed trial resumes from the last snapshot (the reference
    cannot resume a trial).
    """
    t = _Trial(testfn, budget=budget, n_init=n_init, num_starts=num_starts, seed=seed,
               kernel=kernel, noise=noise, kernel_lbs=kernel_lbs, kernel_ubs=kernel_ubs,
               mle_every=mle_every, dtype=dtype, device=device, x_init=x_init,
               checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every)
    theta_key = tuple(map(float, theta))
    theta = t.as_t(theta)
    is_random = rule.name == "Random"
    generator = torch.Generator().manual_seed(seed)
    draw = lambda: torch.rand(testfn.dim, generator=generator, dtype=dtype)  # noqa: E731
    if is_random:
        for _ in range(t.start):         # a resumed trial continues the stream
            draw()
    if steps_per_call <= 0:
        steps_per_call = checkpoint_every if checkpoint_path is not None else budget
    steps_per_call = max(1, min(steps_per_call, budget))

    solve = _cached_program(
        ("myopic_chunk", rule, theta_key, num_starts, solver_iterations, mle_every,
         id(testfn)) + t.bounds_key + (t.shape_key,),
        lambda: GraphProgram(_myopic_solve(rule, theta, t.lbs, t.ubs, t.xstarts,
                                           solver_iterations), device=t.device))
    observe = _observe_program(t)
    b = t.start
    serial = profiling.next_serial()
    while b < budget:
        k = min(steps_per_call, budget - b)
        with profiling.record("bo.chunk", serial=serial, b=b, loop="myopic", device=t.device,
                              iterations=k):
            us = torch.stack([draw() for _ in range(k)]).to(t.device) if is_random else None
            t0 = time.perf_counter()
            xs, ys = [], []
            for i in range(k):
                with profiling.span("bo.acquire"):
                    xs.append(solve(t.state, None if us is None else us[i]))
                with profiling.span("bo.observe"):
                    # the MLE is a constant of the program: two graphs at most
                    do_mle = not is_random and (b + i + 1) % mle_every == 0
                    profiling.note_refit(do_mle)
                    t.state, y = observe(t.state, xs[-1], do_mle)
                    ys.append(y)
            # the chunk's one host read
            rows = torch.cat([torch.stack(xs), torch.stack(ys)[:, None]], 1)
            rows = rows.to(torch.float64).cpu().numpy()
            t.record_chunk(b, rows, time.perf_counter() - t0)
        b += k
        if b % checkpoint_every == 0:
            t.snapshot(b)
    return t.result()


def _make_exploration_fallback(rule, theta, lbs, ubs, xstarts, solver_iterations):
    """Escape hatch for a flat-zero rollout acquisition.

    When every outer restart reports zero expected improvement, the MC
    rollout estimate offers no direction (no trajectory sample crossed the
    incumbent: the empirical mean AND its gradient are exactly zero, so
    Adam freezes and the restart-winner argmax degenerates to a tie). The
    reference has no guard here: its BO loop re-samples the first batch
    point, the duplicate row makes the rank-1 Cholesky update singular, and
    the whole trial dies (adaptive_bayesopt.jl:492-542). Instead: fall back
    to the ANALYTIC myopic acquisition, and if even that is flat, to the
    max-posterior-sigma candidate (pure exploration); both move to a new
    point, keeping the surrogate update well-posed.

    LogEI never flattens: where EI underflows to an exact zero surface,
    log EI still has a finite value and gradient, so the analytic solve
    uses the log form whatever the rollout's base rule (same argmax as EI).

    Returns fallback(state) -> (x, value of the analytic solve), a function
    that copies nothing from the host: the loops run it as the program
    `_fallback_program` caches.
    """
    log_rule = LogEI() if rule.name in ("EI", "LogEI", "Random") else rule
    scale = float(torch.max(ubs - lbs))

    def fallback(state: sg.SurrogateState):
        res = solvers.multistart_maximize(state, log_rule, theta, lbs, ubs, xstarts,
                                          iterations=solver_iterations)
        with torch.no_grad():
            j = torch.argmax(sg.posterior(state, xstarts).sigma).reshape(1)
            x_explore = xstarts.index_select(0, j)[0]      # no host read of j
            # LogEI is finite everywhere, so finiteness alone cannot gate
            # the escape; also require a genuinely NEW point: conditioning
            # on a (near-)duplicate row is the ill-conditioned rank-1 update
            # this fallback exists to prevent
            d2 = torch.sum((state.X - res.x) ** 2, dim=-1)
            dmin = torch.sqrt(torch.amin(
                torch.where(state.mask, d2, torch.finfo(d2.dtype).max)))
            ok = torch.isfinite(res.value) & (dmin > 1e-6 * scale)
            if log_rule.name == "LogEI":
                # On functions whose minimum sits far BELOW the zero prior
                # mean, LogEI's far field is the huge-negative -z^2/2 tail
                # and its global argmax glues to the incumbent: the solve
                # returns an epsilon-step point whose EI is transfinitely
                # small, and the loop crawls in one basin. Gate on the EI
                # being meaningful at the function's own scale; otherwise
                # take the max-sigma explorer, which is sequential
                # space-filling.
                fmini = sg.get_active_minimum(state)
                floor = torch.log(1e-4 * torch.clamp(torch.abs(fmini), min=1.0))
                ok = ok & (res.value > floor)
            return torch.where(ok, res.x, x_explore), res.value

    return fallback


def _fallback_program(t: _Trial, rule, theta_key, theta, num_starts, solver_iterations):
    """The exploration fallback as a program, cached as the JAX package
    caches it ("nm_fallback")."""
    return _cached_program(
        ("nm_fallback", rule, theta_key, num_starts, solver_iterations, t.shape_key),
        lambda: GraphProgram(_make_exploration_fallback(rule, theta, t.lbs, t.ubs, t.xstarts,
                                                        solver_iterations), device=t.device))


def _ghq_node_scale(log10_parity: bool) -> float:
    """GHQ node multiplier under log10 parity: sqrt(log10 e) ~ 0.659
    integrates against the understated fantasy-noise distribution the
    reference's Box-Muller log10 quirk (utils.jl:33-35) draws from, so that
    deterministic-solve runs compare with its stochastic archives."""
    return math.sqrt(math.log10(math.e)) if log10_parity else 1.0


def run_nonmyopic_bo(
    testfn: TestFunction,
    *,
    horizon: int = 1,
    mc_iters: int = 25,
    budget: int = 15,
    theta=(0.0,),
    n_init: int = 5,
    num_starts: int = 16,
    num_restarts: int = 4,
    sgd_iters: int = 25,
    lr: float = 0.01,
    seed: int = 1906,
    kernel: kern.RBFKernel | None = None,
    kernel_lbs=(0.1,),
    kernel_ubs=(5.0,),
    noise: float = 1e-6,
    mle_every: int = 1,
    solver_iterations: int = 12,
    use_low_discrepancy: bool = True,
    log10_parity: bool = False,
    rule: DecisionRule | None = None,
    draw_mode: str = "reparam",
    dtype=torch.float64,
    device="cuda",
    x_init: np.ndarray | None = None,
    deterministic: bool = False,
    ghq_nodes: int = 8,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    mesh=None,
    outer_solver: str = "fused",
    steps_per_call: int = 10,
) -> MyopicBOResult:
    """Non-myopic (rollout-EI) BO trial.

    The intended full loop of the reference scripts (nonmyopic_bayesopt.jl
    CLI flags; adaptive_bayesopt.jl:479-526): per BO iteration, SGA-ascend
    the h-step rollout acquisition from the full reference batch of
    candidate starts (`num_restarts` Sobol points + the two near-boundary
    points), each ascent iteration being `mc_iters` fantasized trajectories
    with gradients under a fixed stream; take the best restart, evaluate
    the true function there, rank-1-condition the surrogate, and
    re-optimize the kernel hyperparameters.

    `deterministic=True` selects the SAA / Gauss-Hermite (variance-free)
    solver, the reference's `--deterministic-solve` flag
    (nonmyopic_bayesopt.jl:63-66, utils.jl:267-306). Otherwise
    `outer_solver` names the stochastic one, with the JAX package's
    semantics: "fused" (`outer.stochastic_solve_fused`, the all-stopped
    test after every SGA iteration), "scanned" (the same loop with that
    test after each window of `steps_per_call` iterations, and
    ceil(sgd_iters / steps_per_call) x steps_per_call iterations unless it
    ends the loop) or "batch" (`outer.stochastic_solve_batch` and the
    argmax: fused's points; `sga_iterations` records -1). `times[b]` is the
    wall time of the acquisition (fallback included), synchronized with
    the device. Every solver runs its program from `_cached_program`, keyed
    as the JAX package keys it (`_rollout_acquirer`), and so do the
    exploration fallback and the observe step (true function, condition,
    MLE every `mle_every` iterations).

    `mesh` (`parallel.mesh.Mesh`; every rank of it runs this call): the
    restarts are cut to `num_restarts` (the two near-boundary points are
    dropped, so that the mesh's 'restarts' axis can divide them, as in the
    JAX package) and split over that axis, the trajectories over its 'mc'
    axis; the Gauss-Hermite solve splits its restarts the same way. After
    every observation (and MLE) the surrogate is replicated from rank 0, so
    that rounding cannot part the ranks, and a fallback's point is rank 0's.
    Every rank returns the trial; rank 0's is the one to record. The
    acquisitions take their programs from `_cached_program` as on one
    device, built for the mesh (their graphs hold its NCCL collectives) and
    keyed with its shape and backend, where the mesh's collectives can be
    captured or the tensors are not on CUDA. On a gloo mesh with CUDA
    tensors, by that rule, they run in the eager loop: a gloo collective
    runs on the host, and no graph can hold it.
    """
    if outer_solver not in ("fused", "scanned", "batch"):
        raise ValueError(f"unknown outer solver {outer_solver!r}")
    rule = rule or EI()
    t = _Trial(testfn, budget=budget, n_init=n_init, num_starts=num_starts, seed=seed,
               kernel=kernel, noise=noise, kernel_lbs=kernel_lbs, kernel_ubs=kernel_ubs,
               mle_every=mle_every, dtype=dtype, device=device, x_init=x_init,
               checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
               lead=mesh is None or mesh.rank == 0)
    theta_key = tuple(map(float, theta))
    program_key = None
    if mesh_mod.programs_run_on(mesh, t.device):
        program_key = ("nm_acquire", rule, theta_key, mc_iters, num_starts, num_restarts,
                       sgd_iters, lr, solver_iterations, draw_mode, deterministic, ghq_nodes,
                       log10_parity, outer_solver, steps_per_call, t.shape_key)
        if mesh is not None:
            program_key += (("mesh", mesh.restarts, mesh.mc, mesh.backend),)
    theta = t.as_t(theta)
    make_rnstream = _rnstream_maker(t, mc_iters, use_low_discrepancy, log10_parity)
    acquire = _rollout_acquirer(t, rule, theta, deterministic=deterministic,
                                ghq_nodes=ghq_nodes, sgd_iters=sgd_iters, lr=lr,
                                solver_iterations=solver_iterations, draw_mode=draw_mode,
                                log10_parity=log10_parity, mesh=mesh,
                                outer_solver=outer_solver, steps_per_call=steps_per_call,
                                program_key=program_key)
    fallback = _fallback_program(t, rule, theta_key, theta, num_starts, solver_iterations)
    observe = _observe_program(t)
    if not use_low_discrepancy:
        # replay the normal draws consumed before the snapshot so that the
        # resumed stream continues where it left off (the QMC stream is
        # stateless and needs no replay)
        for _ in range(t.start):
            make_rnstream(horizon)

    sga_iterations = np.zeros(budget, dtype=int)
    fallbacks = np.zeros(budget, dtype=bool)
    # the full reference batch: num_restarts Sobol points + the two
    # eps-interior near-boundary points (utils.jl:97-106)
    restarts = t.as_t(qmc.generate_batch(num_restarts, testfn.lbs, testfn.ubs))
    if mesh is not None:
        restarts = restarts[:num_restarts]
    serial = profiling.next_serial()
    for b in range(t.start, budget):
        with profiling.record("bo.iteration", serial=serial, b=b, loop="nonmyopic",
                              device=t.device):
            rnstream = make_rnstream(horizon)
            with profiling.span("bo.acquire") as acquisition:
                xnext, sga_iterations[b], fallbacks[b] = _acquire_or_fall_back(
                    acquire, fallback, t.state, rnstream, restarts, horizon)
                if mesh is not None and fallbacks[b]:
                    xnext = mesh_mod.broadcast(xnext, mesh)
                _synchronize(t.device)
            t.times[b] = acquisition.seconds
            t.observe(b, observe, xnext)
            if mesh is not None:
                t.state = mesh_mod.replicate(t.state, mesh)
    return t.result(sga_iterations=sga_iterations, fallbacks=fallbacks)


def _rnstream_maker(t: _Trial, mc_iters, use_low_discrepancy, log10_parity):
    """make(h) -> the (mc_iters, d+1, h+1) normal stream of one acquisition."""
    d = t.testfn.dim

    def make(h: int):
        if use_low_discrepancy:
            # log10_parity reproduces the reference's Box-Muller `log10`
            # quirk (utils.jl:33-35): its archived variance-reduction runs
            # fantasize with draws of std log10(e)^0.5 ~ 0.659, not N(0, 1)
            z = qmc.gen_low_discrepancy_sequence(
                mc_iters, d, h + 1, log10_parity=log10_parity)
        else:
            z = t.rng.normal(size=(mc_iters, d + 1, h + 1))
        return t.as_t(z)

    return make


def _rollout_acquirer(t: _Trial, rule, theta, *, deterministic, ghq_nodes, sgd_iters,
                      lr, solver_iterations, draw_mode, log10_parity, mesh=None,
                      outer_solver="fused", steps_per_call=1, program_key=None):
    """acquire(state, rnstream, restarts, h) -> (x, value, SGA iterations or
    -1) of the h-step rollout acquisition: the stochastic solver named by
    `outer_solver` (see `run_nonmyopic_bo`), or the Gauss-Hermite one with
    `deterministic` (which ignores the stream); on the ranks of `mesh` if
    one is given. With `program_key` every solve runs the program cached
    under program_key + (h,) ("fused" and "batch":
    `outer.make_fused_sga_program(select_best=True)`, whose points are the
    batch solver's with its argmax; "scanned": `make_scanned_sga_program`;
    Gauss-Hermite: `make_deterministic_program(select_best=True)`); without
    one they run the eager loop, the route the tests hold the programs to.
    On `mesh` the programs are built for it (`outer`'s `mesh=`): they take
    this rank's blocks of the restarts and the stream themselves."""
    node_scale = _ghq_node_scale(log10_parity)

    def program(state, tp, h):
        def build():
            kw = dict(lr=lr, inner_iterations=solver_iterations)
            if deterministic:
                return outer_mod.make_deterministic_program(
                    state, theta, t.lbs, t.ubs, t.xstarts, rule, horizon=h,
                    num_nodes=ghq_nodes, max_iters=sgd_iters, node_scale=node_scale,
                    select_best=True, mesh=mesh, **kw)
            if outer_solver == "scanned":
                return outer_mod.make_scanned_sga_program(
                    state, tp, rule, t.xstarts, steps_per_call=steps_per_call,
                    draw_mode=draw_mode, mesh=mesh, **kw)
            return outer_mod.make_fused_sga_program(state, tp, rule, t.xstarts,
                                                    max_iters=sgd_iters, select_best=True,
                                                    draw_mode=draw_mode, mesh=mesh, **kw)

        return _cached_program(program_key + (h,), build)

    def acquire(state, rnstream, restarts, h):
        if deterministic:
            if program_key is not None:
                x, value = program(state, None, h)(state, restarts)
                return x, value, -1
            xs, vals = outer_mod.deterministic_solve_batch(
                state, theta, t.lbs, t.ubs, t.xstarts, restarts, rule,
                horizon=h, num_nodes=ghq_nodes, max_iters=sgd_iters, lr=lr,
                inner_iterations=solver_iterations, node_scale=node_scale, mesh=mesh)
            j = torch.argmax(vals)
            return xs[j], vals[j], -1
        tp = TrajectoryParams(x0=restarts, theta=theta, lbs=t.lbs, ubs=t.ubs,
                              rnstream=rnstream)
        kw = dict(max_iters=sgd_iters, lr=lr, inner_iterations=solver_iterations,
                  draw_mode=draw_mode, mesh=mesh)
        if program_key is None:
            if outer_solver == "batch":
                xs, vals = outer_mod.stochastic_solve_batch(state, tp, rule, t.xstarts,
                                                            restarts, **kw)
                j = torch.argmax(vals)
                return xs[j], vals[j], -1
            res = outer_mod.stochastic_solve_fused(
                state, tp, rule, t.xstarts, restarts, select_best=True,
                steps_per_call=steps_per_call if outer_solver == "scanned" else 1, **kw)
            return res.x, res.value, res.iterations
        prog = program(state, tp, h)
        if outer_solver == "scanned":
            res = outer_mod._scanned_program_solve(prog, state, tp.rnstream, restarts,
                                                   sgd_iters)
            j = torch.argmax(res.value)
            return res.x[j], res.value[j], res.iterations
        res = outer_mod.stochastic_solve_fused(state, tp, rule, t.xstarts, restarts,
                                               select_best=True, program=prog, mesh=mesh)
        return res.x, res.value, -1 if outer_solver == "batch" else res.iterations

    return acquire


def _acquire_or_fall_back(acquire, fallback, state, rnstream, restarts, h):
    """(x, SGA iterations, fallback taken): the rollout acquisition's
    winner, or the exploration fallback's point (span `bo.fallback`) where
    the winner's value is not finite and positive."""
    xnext, vbest, iterations = acquire(state, rnstream, restarts, h)
    vb = float(vbest)
    taken = not math.isfinite(vb) or vb <= 0.0
    profiling.note(value=vb, fallback=taken)
    if taken:
        with profiling.span("bo.fallback"):
            return fallback(state)[0], iterations, True
    return xnext, iterations, False


def alternating_horizon(max_horizon: int = 1):
    """Reference adaptive schedule: h alternates 0, max_h, 0, max_h, ...
    (adaptive_bayesopt.jl:505, `tp.h = budget % 2 == 1 ? 0 : 1`, with the
    hard-coded 1 generalized to max_horizon). `b` is 0-based."""

    def schedule(b: int, budget: int) -> int:
        return 0 if (b + 1) % 2 == 1 else max_horizon

    return schedule


def fixed_horizon(max_horizon: int):
    """Constant-horizon schedule: the reference's no-truncated-horizons
    archive (metadata `Should Truncate Horizon: false`)."""

    def schedule(b: int, budget: int) -> int:
        return max_horizon

    return schedule


def truncated_horizon(max_horizon: int):
    """The reference's commented-out alternative (adaptive_bayesopt.jl:503):
    the horizon shrinks with the remaining budget."""

    def schedule(b: int, budget: int) -> int:
        return min(max_horizon, budget - (b + 1))

    return schedule


def _memory_mark(device: torch.device) -> int:
    """Start a peak-memory window: bytes allocated now (0 off the card)."""
    if device.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak_bytes_since(device: torch.device, mark: int) -> int:
    """Peak bytes allocated above `mark` since `_memory_mark` (0 off the card,
    as the JAX package reports on a backend without memory statistics)."""
    if device.type != "cuda":
        return 0
    return max(0, torch.cuda.max_memory_allocated(device) - mark)


def run_adaptive_bo(
    testfn: TestFunction,
    *,
    horizon: int = 1,
    schedule: Callable[[int, int], int] | None = None,
    mc_iters: int = 25,
    budget: int = 15,
    theta=(0.0,),
    n_init: int = 1,
    num_starts: int = 16,
    num_restarts: int = 4,
    sgd_iters: int = 25,
    lr: float = 0.01,
    seed: int = 1906,
    kernel: kern.RBFKernel | None = None,
    kernel_lbs=(0.1,),
    kernel_ubs=(5.0,),
    noise: float = 1e-6,
    mle_every: int = 10**9,
    solver_iterations: int = 12,
    use_low_discrepancy: bool = True,
    log10_parity: bool = False,
    deterministic: bool = False,
    ghq_nodes: int = 8,
    rule: DecisionRule | None = None,
    draw_mode: str = "reparam",
    dtype=torch.float64,
    device="cuda",
    x_init: np.ndarray | None = None,
) -> MyopicBOResult:
    """Adaptive-horizon rollout BO trial (reference adaptive_bayesopt.jl:479-526).

    Each BO iteration solves the rollout acquisition at horizon
    schedule(b, budget) (default: the reference's alternating 0 / h) from
    the `num_restarts` + 2 restart batch, with a fresh (mc_iters, d+1, h+1)
    stream; h = 0 rolls out the first draw alone, with no inner solve.
    `deterministic=True` selects the Gauss-Hermite solver (reference
    `rollout_solver_saa`). The buffers hold len(x_init) + budget
    observations (n_init + budget without x_init), as in the JAX package.

    The acquisition runs `outer.make_fused_sga_program(select_best=True)`
    (or `make_deterministic_program`), one program per horizon from
    `_cached_program` (keyed as the JAX package keys it), and so do the
    exploration fallback and the observe step.

    The result carries `times` (acquisition wall seconds, synchronized),
    `allocations` (peak device bytes per acquisition above the level
    before it), `sga_iterations` and `fallbacks`.
    """
    rule = rule or EI()
    schedule = schedule or alternating_horizon(horizon)
    if x_init is not None:
        n_init = len(x_init)
    t = _Trial(testfn, budget=budget, n_init=n_init, num_starts=num_starts, seed=seed,
               kernel=kernel, noise=noise, kernel_lbs=kernel_lbs, kernel_ubs=kernel_ubs,
               mle_every=mle_every, dtype=dtype, device=device, x_init=x_init,
               checkpoint_path=None, checkpoint_every=1)
    theta_key = tuple(map(float, theta))
    program_key = ("ad_acquire", rule, theta_key, mc_iters, num_starts, num_restarts,
                   sgd_iters, lr, solver_iterations, draw_mode, deterministic, ghq_nodes,
                   log10_parity, t.shape_key)
    theta = t.as_t(theta)
    make_rnstream = _rnstream_maker(t, mc_iters, use_low_discrepancy, log10_parity)
    acquire = _rollout_acquirer(t, rule, theta, deterministic=deterministic,
                                ghq_nodes=ghq_nodes, sgd_iters=sgd_iters, lr=lr,
                                solver_iterations=solver_iterations, draw_mode=draw_mode,
                                log10_parity=log10_parity, program_key=program_key)
    fallback = _fallback_program(t, rule, theta_key, theta, num_starts, solver_iterations)
    observe = _observe_program(t)
    sga_iterations = np.zeros(budget, dtype=int)
    fallbacks = np.zeros(budget, dtype=bool)
    allocations = np.zeros(budget)
    restarts = t.as_t(qmc.generate_batch(num_restarts, testfn.lbs, testfn.ubs))
    serial = profiling.next_serial()
    for b in range(budget):
        with profiling.record("bo.iteration", serial=serial, b=b, loop="adaptive",
                              device=t.device):
            h = max(0, int(schedule(b, budget)))
            rnstream = make_rnstream(h)
            mark = _memory_mark(t.device)
            with profiling.span("bo.acquire") as acquisition:
                xnext, sga_iterations[b], fallbacks[b] = _acquire_or_fall_back(
                    acquire, fallback, t.state, rnstream, restarts, h)
                _synchronize(t.device)
            t.times[b] = acquisition.seconds
            allocations[b] = _peak_bytes_since(t.device, mark)
            t.observe(b, observe, xnext)
    return t.result(sga_iterations=sga_iterations, fallbacks=fallbacks,
                    allocations=allocations)
