"""Non-myopic (rollout) BO experiment CLI.

Port of `rollout_bo_tpu/experiments/nonmyopic.py` (reference
`experiments/nonmyopic_bayesopt.jl` flags :4-74; the loop is
`rollout_bo_tpu_torch.rollout.bo.run_nonmyopic_bo`). Outputs
rollout_h{H}_{times,gaps,observations}.csv in the reference's archived
schema. Same flags, defaults, file names and initial-sample stream as the
JAX package's CLI. Differences: `--device` (default `cuda`; without a card
it raises). `--outer-solver` and `--steps-per-call` keep the JAX CLI's
semantics (`run_nonmyopic_bo(outer_solver=...)`), over the one SGA loop of
`rollout/outer.py`.

Several ranks: `--nworkers N` (0: every card, or 1 on `--device cpu`).
When N > 1 divides `--batch-size`, the CLI spawns N processes, one rank
each, joined by `torch.distributed` (`--backend nccl`, the default, one
card per rank; `gloo` for ranks that share a card or run on the CPU), on a
mesh of restarts = N, mc = 1, as the JAX CLI builds it: each rank solves
its share of the restarts. The rendezvous is a `file://` store in the
output directory unless `--init-method` names one. Rank 0 alone writes the
metadata, the CSVs and the progress lines; a rank that fails ends the
others. When N does not divide the batch, the run takes one device. Over
NCCL the acquisitions run as CUDA-graph programs that hold the ranks'
collectives; gloo runs its collectives on the host, where no graph can
hold them, so gloo ranks on the card run the acquisitions eagerly (the
CLI says so once).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import logging as log


def parse_args(argv=None):
    p = argparse.ArgumentParser("Nonmyopic Bayesian Optimization CLI")
    p.add_argument("--nworkers", type=int, default=0,
                   help="ranks (one process and device each) over which the "
                        "restarts are split; 0 = every card (1 with --device "
                        "cpu). Takes effect when it divides --batch-size")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend of the ranks: nccl needs one "
                        "card per rank; gloo serves ranks that share a card or "
                        "run on the CPU")
    p.add_argument("--init-method", default=None,
                   help="rendezvous URL of the ranks (default: a file:// store "
                        "in the output directory)")
    p.add_argument("--seed", type=int, default=1906)
    p.add_argument("--optimize", action="store_true",
                   help="optimize surrogate hyperparameters each iteration")
    p.add_argument("--starts", type=int, default=16)
    p.add_argument("--trials", type=int, default=60)
    p.add_argument("--budget", type=int, default=15)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mc-samples", type=int, default=200)
    p.add_argument("--horizon", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8,
                   help="outer SGA restarts per BO iteration")
    p.add_argument("--function-name", required=True)
    p.add_argument("--sgd-iterations", type=int, default=50)
    p.add_argument("--variance-reduction", action="store_true",
                   help="use low-discrepancy (QMC) trajectory streams")
    p.add_argument("--log10-parity", action="store_true",
                   help="reproduce the reference's Box-Muller log10 quirk "
                        "(utils.jl:33-35): QMC fantasy draws get std "
                        "log10(e)^0.5 ~ 0.659 instead of 1. The reference's "
                        "archived variance-reduction runs all carry this "
                        "quirk, so regret-parity runs should pass it")
    p.add_argument("--solve-f-tol", type=float, default=0.0,
                   help="IPNewton-style loose acceptance for the INNER "
                        "(fantasy-step EI) solves: the reference applies "
                        "Optim.Options(x_tol=f_tol=1e-3) to every inner "
                        "solve (rbf_optim.jl:26-30), ours are tight by "
                        "default; nonzero sets solve_f_tol=solve_x_tol on "
                        "the rollout rule")
    p.add_argument("--deterministic-solve", action="store_true",
                   help="SAA/Gauss-Hermite solver instead of MC "
                        "(reference utils.jl:267-306)")
    p.add_argument("--ghq-nodes", type=int, default=8)
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"],
                   help="torch dtype of the surrogate and the solves")
    p.add_argument("--outer-solver", default="fused",
                   choices=["fused", "batch", "scanned"],
                   help="fused: every restart simulated in lock-step, the loop "
                        "ends once all have stopped (tested every SGA "
                        "iteration); scanned: the same, tested after each "
                        "window of --steps-per-call iterations, whole windows "
                        "only; batch: fused's points, SGA iterations not "
                        "recorded")
    p.add_argument("--steps-per-call", type=int, default=10,
                   help="SGA iterations per window of --outer-solver scanned")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="snapshot the trial every N iterations (0 = off); a "
                        "crashed run resumes from the last snapshot")
    p.add_argument("--initial-observations", type=int, default=5,
                   help="initial uniform samples per trial: 5 matches the "
                        "reference nonmyopic script "
                        "(nonmyopic_bayesopt.jl:133); its ARCHIVED "
                        "rollout_h* data was produced by the adaptive "
                        "script with ONE initial observation per trial "
                        "(adaptive_bayesopt.jl:496): pass 1 to compare "
                        "against those CSVs")
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    n = args.nworkers or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if n > 1 and args.batch_size % n == 0:
        mesh_mod.check_backend(args.backend, n, device.type)
        if args.backend == "gloo" and device.type == "cuda":
            print("--backend gloo on the card: the acquisitions run eagerly (a gloo "
                  "collective runs on the host, and no CUDA graph can hold it); "
                  "--backend nccl, one card per rank, runs them as programs")
        _spawn(args, n)
        return
    if n > 1:
        print(f"--nworkers {n} does not divide --batch-size {args.batch_size}: "
              "running on one device")
    _run(args, device, None)


def _spawn(args, world: int) -> None:
    """Run `_rank_main` in `world` new processes; a rank that fails ends
    the others, and the first failure is raised here."""
    os.makedirs(args.output_dir, exist_ok=True)
    store = os.path.abspath(os.path.join(args.output_dir, f".rendezvous-{os.getpid()}"))
    try:
        mp.start_processes(_rank_main, args=(args, world, args.init_method or f"file://{store}"),
                           nprocs=world, start_method="spawn")
    finally:
        if os.path.exists(store):
            os.remove(store)


def _rank_main(rank: int, args, world: int, init_method: str) -> None:
    """One rank of a `--nworkers` run: join the group, run the trials on
    the mesh (restarts = world, mc = 1), leave the group."""
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method, world, rank, backend=args.backend)
    try:
        _run(args, mesh_mod.rank_device(args.device), mesh_mod.make_mesh(restarts=world, mc=1))
    finally:
        mesh_mod.finalize_distributed()


def _run(args, device: torch.device, mesh) -> None:
    """The trials, on one device or as one rank of `mesh`."""
    lead = mesh is None or mesh.rank == 0
    dtype = getattr(torch, args.dtype)
    f = testfns.get_function(args.function_name)
    outdir = os.path.join(args.output_dir, args.function_name)
    h = args.horizon
    if lead:
        os.makedirs(outdir, exist_ok=True)
        log.write_metadata(
            os.path.dirname(outdir) or outdir,
            budget=args.budget, number_of_trials=args.trials,
            number_of_starts=args.starts, data_directory=args.output_dir,
            should_optimize=args.optimize, horizon=args.horizon,
            mc_samples=args.mc_samples, batch_size=args.batch_size,
            sgd_iterations=args.sgd_iterations,
            should_reduce_variance=args.variance_reduction,
            log10_parity=args.log10_parity,
        )
        for metric in ["times", "gaps", "observations"]:
            log.create_csv(os.path.join(outdir, f"rollout_h{h}_{metric}"), args.budget)

    rng = np.random.default_rng(args.seed)
    # crash-resume: skip trials that already hold a CSV row (create_csv
    # keeps existing rows) instead of recomputing and appending duplicates
    done_trials = 0
    if args.checkpoint_every:
        if lead:
            done_trials = len(log.read_rows(os.path.join(outdir, f"rollout_h{h}_gaps")))
            if done_trials:
                print(f"resuming: {done_trials} completed trial(s) on disk")
        if mesh is not None:
            done_trials = int(mesh_mod.broadcast(
                torch.tensor([done_trials], device=device), mesh))
    n_init = args.initial_observations
    for trial in range(args.trials):
        x_init = np.asarray(f.lbs) + (np.asarray(f.ubs) - np.asarray(f.lbs)) \
            * rng.uniform(size=(n_init, f.dim))
        if trial < done_trials:
            continue  # x_init drawn anyway to keep the rng stream aligned
        t0 = time.time()
        ckpt_path = (os.path.join(outdir, f"rollout_h{h}_trial{trial}_ckpt")
                     if args.checkpoint_every else None)
        res = bo.run_nonmyopic_bo(
            f, horizon=h, mc_iters=args.mc_samples, budget=args.budget,
            n_init=n_init, num_starts=args.starts, num_restarts=args.batch_size,
            sgd_iters=args.sgd_iterations, seed=args.seed + trial,
            mle_every=1 if args.optimize else 10**9,
            use_low_discrepancy=args.variance_reduction,
            log10_parity=args.log10_parity,
            rule=(dr.DecisionRule("EI", 1e-8, args.solve_f_tol,
                                  args.solve_f_tol)
                  if args.solve_f_tol else dr.EI()),
            x_init=x_init, dtype=dtype, device=device,
            deterministic=args.deterministic_solve, ghq_nodes=args.ghq_nodes,
            checkpoint_path=ckpt_path,
            checkpoint_every=args.checkpoint_every or 5,
            mesh=mesh, outer_solver=args.outer_solver,
            steps_per_call=args.steps_per_call,
        )
        if not lead:
            continue
        if ckpt_path is not None and os.path.exists(ckpt_path + ".npz"):
            os.remove(ckpt_path + ".npz")  # completed trial: drop snapshot
        log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_times"), res.times)
        log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_gaps"), res.gaps)
        log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_observations"),
                         res.y[-args.budget:])
        print(f"trial {trial + 1}/{args.trials}: final gap {res.gaps[-1]:.3f} "
              f"mean iter {res.times.mean():.2f}s total {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
