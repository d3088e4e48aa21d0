"""Myopic BO experiment CLI.

Port of `rollout_bo_tpu/experiments/myopic.py` (reference
`experiments/myopic_bayesopt.jl`, flags :4-41, protocol :94-263): for each
acquisition in {EI, POI, LCB, Random}, run `--trials` BO trials of
`--budget` iterations with 5 uniform initial samples, logging times / gaps
/ simple-regret / minimum-observation CSVs per acquisition in the
reference schema (plus allocations, which are always 0 here). Same flags,
defaults, file names and initial-sample stream as the JAX package's CLI.
`--steps-per-call` sets the BO iterations per chunk, the host reading the
points once per chunk (0, the default: the whole budget, or the snapshot
cadence with `--checkpoint-every`). Difference: `--device` (default
`cuda`; without a card it raises, it never runs on the CPU unasked).

Usage:
    python -m rollout_bo_tpu_torch.experiments.myopic --function-name sixhump \
        --budget 100 --trials 60 --starts 64 --seed 1906
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import logging as log


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of the surrogate and the solves (default "
                        "cuda: the inner solves run the CUDA kernel, and the "
                        "run raises without a card); cpu runs the kernel's "
                        "plain PyTorch version")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; pass "
                           "--device cpu to run the plain PyTorch route")
    return device


def parse_args(argv=None):
    p = argparse.ArgumentParser("Myopic Bayesian Optimization CLI")
    p.add_argument("--seed", type=int, default=1906)
    p.add_argument("--starts", type=int, default=64,
                   help="multistarts for the inner acquisition solve")
    p.add_argument("--trials", type=int, default=60)
    p.add_argument("--budget", type=int, default=100)
    p.add_argument("--function-name", required=True)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--acquisitions", nargs="+",
                   default=["ei", "poi", "lcb", "random"])
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"],
                   help="torch dtype of the surrogate and the solves")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="snapshot the trial every N iterations (0 = off); "
                        "a crashed run resumes from the last snapshot")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="BO iterations per chunk, one host read each (0 = the "
                        "whole budget, or the checkpoint cadence)")
    add_device_argument(p)
    return p.parse_args(argv)


ACQS = {
    "ei": (dr.EI, (0.0,)),
    "logei": (dr.LogEI, (0.0,)),  # stable log-EI (same argmax as EI)
    # POI stays in its native form deliberately. POI's regret behavior
    # depends on LOOSE maximization: Phi(z) saturates to 1.0 over a wide
    # plateau (f32: z > 6; f64: z > 8), and the reference's IPNewton with
    # f_tol=1e-3 stops anywhere on it: implicit exploration that is the
    # reason POI works at all. Exact log-space maximization (LogPOI,
    # "logpoi" below) resolves the true argmax, an epsilon-step from the
    # incumbent. POI parity runs should use --dtype float64, whose
    # saturation plateau matches the reference's.
    "poi": (dr.POI, (0.0,)),
    "logpoi": (dr.LogPOI, (0.0,)),  # exact log-space POI (see above)
    "lcb": (dr.LCB, (2.0,)),
    "random": (dr.RandomAcquisition, (0.0,)),
}

METRICS = ["times", "gaps", "allocations", "simple_regret", "minimum_observations"]


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)

    f = testfns.get_function(args.function_name)
    # per-function subdirectory, like the reference's experiments/myopic/<fn>/
    outdir = os.path.join(args.output_dir or os.path.join("experiments", "myopic"),
                          args.function_name)
    os.makedirs(outdir, exist_ok=True)
    log.write_metadata(outdir, budget=args.budget,
                       number_of_trials=args.trials,
                       number_of_starts=args.starts)

    for acq in args.acquisitions:
        for metric in METRICS:
            log.create_csv(os.path.join(outdir, f"{acq}_{metric}"), args.budget)

    rng = np.random.default_rng(args.seed)
    initial_samples = [
        np.asarray(f.lbs) + (np.asarray(f.ubs) - np.asarray(f.lbs))
        * rng.uniform(size=(5, f.dim))
        for _ in range(args.trials)
    ]

    for acq in args.acquisitions:
        rule_fn, theta = ACQS[acq]
        rule = rule_fn()
        print(f"[{args.function_name}] acquisition={rule.name}")
        # crash-resume: completed trials already hold a CSV row (create_csv
        # keeps existing rows); skip them instead of recomputing AND
        # re-appending duplicates that would bias the gap statistics
        done_trials = 0
        if args.checkpoint_every:
            done_trials = len(log.read_rows(os.path.join(outdir, f"{acq}_gaps")))
            if done_trials:
                print(f"  resuming: {done_trials} completed trial(s) on disk")
        for trial in range(done_trials, args.trials):
            t0 = time.time()
            ckpt_path = (os.path.join(outdir, f"ckpt_{acq}_{trial}")
                         if args.checkpoint_every else None)
            res = bo.run_myopic_bo(
                f, rule, budget=args.budget, theta=theta,
                num_starts=args.starts, seed=args.seed + trial,
                x_init=initial_samples[trial], dtype=dtype, device=device,
                checkpoint_path=ckpt_path,
                checkpoint_every=args.checkpoint_every or 10,
                steps_per_call=args.steps_per_call,
            )
            if ckpt_path and os.path.exists(ckpt_path + ".npz"):
                os.remove(ckpt_path + ".npz")
            for metric, data in [
                ("times", res.times),
                ("gaps", res.gaps),
                ("allocations", np.zeros(args.budget)),
                ("simple_regret", res.simple_regrets),
                ("minimum_observations", res.minimum_observations),
            ]:
                log.write_to_csv(os.path.join(outdir, f"{acq}_{metric}"), data)
            print(f"  trial {trial + 1}/{args.trials}: "
                  f"final gap {res.gaps[-1]:.3f} ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
