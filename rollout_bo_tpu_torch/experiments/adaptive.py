"""Adaptive-horizon rollout BO experiment CLI.

Port of `rollout_bo_tpu/experiments/adaptive.py` (reference
`experiments/adaptive_bayesopt.jl`, flags :4-74, main loop :339-545): per
BO iteration the rollout horizon follows a schedule (default the
reference's alternating 0 / h, adaptive_bayesopt.jl:505), the acquisition
is solved over a batch of candidate starts, and `--deterministic-solve`
selects the Gauss-Hermite solver (the reference's `rollout_solver_saa`).

Outputs the reference's four CSVs per function,
rollout_h{H}_{gaps,observations,times,allocations}.csv, plus
metadata.txt; a trial that raises is written to `<function>_failed.txt`
and the sweep continues (adaptive_bayesopt.jl:492-542,
write_error_to_disk:330-336). Same flags, defaults and files as the JAX
package's CLI, plus `--device` (default `cuda`; without a card it raises).
`allocations` are peak device bytes per acquisition on the card, 0 on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import time
import traceback

import torch

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import logging as log


def parse_args(argv=None):
    p = argparse.ArgumentParser("Adaptive Rollout Bayesian Optimization CLI")
    p.add_argument("--seed", type=int, default=1906)
    p.add_argument("--optimize", action="store_true",
                   help="optimize surrogate hyperparameters each iteration")
    p.add_argument("--starts", type=int, default=16)
    p.add_argument("--trials", type=int, default=60)
    p.add_argument("--budget", type=int, default=15)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--mc-samples", type=int, default=100)
    p.add_argument("--horizon", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8,
                   help="outer SGA restarts per BO iteration")
    p.add_argument("--function-name", required=True)
    p.add_argument("--sgd-iterations", type=int, default=50)
    p.add_argument("--variance-reduction", action="store_true",
                   help="use low-discrepancy (QMC) trajectory streams")
    p.add_argument("--log10-parity", action="store_true",
                   help="reproduce the reference's Box-Muller log10 quirk "
                        "(utils.jl:33-35) in the QMC streams — required for "
                        "regret parity against its archived runs")
    p.add_argument("--deterministic-solve", action="store_true",
                   help="SAA/Gauss-Hermite solver instead of MC")
    p.add_argument("--ghq-nodes", type=int, default=8)
    p.add_argument("--schedule", default="alternating",
                   choices=["alternating", "truncated", "fixed"],
                   help="horizon schedule (adaptive_bayesopt.jl:503-505): "
                        "alternating = 0/h (the live line :505), truncated = "
                        "min(h, remaining budget) (the commented :503 — the "
                        "truncated-horizons archive), fixed = h every "
                        "iteration (the no-truncated-horizons archive)")
    p.add_argument("--resume", action="store_true",
                   help="skip trials that already hold a CSV row")
    p.add_argument("--n-init", type=int, default=1,
                   help="initial samples per trial (reference uses 1)")
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)

    f = testfns.get_function(args.function_name)
    outdir = os.path.join(args.output_dir, args.function_name)
    os.makedirs(outdir, exist_ok=True)
    log.write_metadata(
        outdir,
        budget=args.budget, number_of_trials=args.trials,
        number_of_starts=args.starts, data_directory=args.output_dir,
        should_optimize=args.optimize, horizon=args.horizon,
        mc_samples=args.mc_samples, batch_size=args.batch_size,
        sgd_iterations=args.sgd_iterations,
        should_reduce_variance=args.variance_reduction,
        sample_average_approximation=args.deterministic_solve,
        schedule=args.schedule,
    )

    h = args.horizon
    for metric in ["gaps", "observations", "times", "allocations"]:
        log.create_csv(os.path.join(outdir, f"rollout_h{h}_{metric}"), args.budget)

    schedule = {"alternating": bo.alternating_horizon,
                "truncated": bo.truncated_horizon,
                "fixed": bo.fixed_horizon}[args.schedule](h)

    done_trials = 0
    if args.resume:
        done_trials = len(log.read_rows(os.path.join(outdir, f"rollout_h{h}_gaps")))
        if done_trials:
            print(f"resuming: {done_trials} completed trial(s) on disk")
    for trial in range(args.trials):
        if trial < done_trials:
            continue
        try:
            t0 = time.time()
            res = bo.run_adaptive_bo(
                f, horizon=h, schedule=schedule, mc_iters=args.mc_samples,
                budget=args.budget, num_starts=args.starts,
                num_restarts=args.batch_size, sgd_iters=args.sgd_iterations,
                seed=args.seed + trial, n_init=args.n_init,
                mle_every=1 if args.optimize else 10**9,
                use_low_discrepancy=args.variance_reduction,
                log10_parity=args.log10_parity,
                deterministic=args.deterministic_solve,
                ghq_nodes=args.ghq_nodes, rule=dr.EI(), dtype=dtype,
                device=device,
            )
            log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_gaps"), res.gaps)
            log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_observations"),
                             res.y[-args.budget:])
            log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_times"), res.times)
            log.write_to_csv(os.path.join(outdir, f"rollout_h{h}_allocations"),
                             res.allocations)
            print(f"trial {trial + 1}/{args.trials}: final gap {res.gaps[-1]:.3f} "
                  f"mean iter {res.times.mean():.2f}s total {time.time() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 — reference behavior: log + continue
            msg = (f"({args.function_name}) Trial {trial + 1} failed with error: "
                   f"{e}\n{traceback.format_exc()}")
            with open(os.path.join(outdir, f"{args.function_name}_failed.txt"),
                      "w") as fh:
                fh.write(msg)
            print(f"trial {trial + 1} FAILED: {e}")


if __name__ == "__main__":
    main()
