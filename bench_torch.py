#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: one h=3 rollout-acquisition
optimization per BO iteration, timed as bench.py times the JAX package.

    python3 bench_torch.py [--device cuda|cpu]

The configuration is bench.py's (the reference's archived
nonmyopic-shortrun-timing run): trid10d, 12 observations in a capacity-20
Matern-5/2 surrogate (lengthscale 1, noise 1e-5, seed 1906), horizon 3,
200 QMC trajectories, 8 outer SGA restarts, 50 SGA iterations with the
eswavs early stop, lr 0.01, 8 + 2 inner starts, 10 Newton iterations,
float32. The solve is the port's `make_fused_sga_program(select_best=True)`,
built once, as bench.py builds the JAX program (bench.py:70-72): on the
card, CUDA graphs of one SGA step and of the final pass. Reference wall
time: 309.4 s per BO iteration (BASELINE.md).

The protocol is bench.py's: one warm-up acquisition (on the card, the
program's capture), whose winner must be finite, then 3 timed ones, each
on a new QMC stream tensor and each ending in `torch.cuda.synchronize()`;
the median is reported. The same protocol first runs the solve in the
eager loop (`stochastic_solve_fused` with no program), on a line of its
own, with the largest difference between the two routes' winners on the
last stream. Earlier lines give the card's name and power limit
(nvidia-smi), the program's capture seconds, memory-pool bytes and
warm-up launches, then for the program the SGA iterations of each
acquisition, its lane-kernel launches (checked on both routes: horizon x
(SGA iterations + 1) on the card, 0 on the CPU, where the plain PyTorch
version runs) and the three times. The last line is bench.py's JSON, of
the program.

The card is the default and its absence raises; `--device cpu` runs the
plain PyTorch route (the tests do).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

BASELINE_S = 309.4  # reference trid10d h=3 s/iter (BASELINE.md)
METRIC = "trid10d_h3_rollout_acq_opt_seconds_per_iter"
TIMED_RUNS = 3


def bench_problem(device, dtype, *, name="trid10d", n_obs=12, capacity=20, mc=200,
                  horizon=3, starts=8, restarts=8):
    """bench.py's problem (bench.py:39-62) built with the port's functions:
    the surrogate state, the trajectory parameters (x0 = 0, theta = 0, the
    box, the QMC stream (mc, d + 1, horizon + 1)), the inner starts
    (starts + 2, d) and the outer restarts (restarts, d)."""
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.ops import kernels as K
    from rollout_bo_tpu_torch.ops import qmc
    from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

    f = testfns.get_function(name)
    d = f.dim
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    rng = np.random.default_rng(1906)
    X0 = qmc.randsample(n_obs, d, f.lbs, f.ubs, rng)
    y0 = f.batch(torch.tensor(X0, dtype=torch.float64)).numpy()
    state = sg.fit(K.matern52((1.0,), device=device, dtype=dtype), X0, y0,
                   capacity=capacity, noise=1e-5, device=device, dtype=dtype)
    xstarts = t(qmc.generate_initial_guesses(starts, f.lbs, f.ubs))
    z = qmc.gen_low_discrepancy_sequence(mc, d, horizon + 1)
    tp = TrajectoryParams(x0=torch.zeros(d, dtype=dtype, device=device),
                          theta=torch.zeros(1, dtype=dtype, device=device),
                          lbs=t(f.lbs), ubs=t(f.ubs), rnstream=t(z))
    rs = t(qmc.generate_batch(restarts, f.lbs, f.ubs)[:restarts])
    return state, tp, xstarts, rs


def acquire(state, tp, xstarts, restarts, *, max_iters=50, lr=0.01, inner_iterations=10,
            program=None):
    """One acquisition: the multi-restart SGA solve with winner selection,
    in the eager loop, or through `program` (`fused_program`)."""
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.rollout import outer

    return outer.stochastic_solve_fused(state, tp, EI(), xstarts, restarts,
                                        max_iters=max_iters, lr=lr,
                                        inner_iterations=inner_iterations, select_best=True,
                                        program=program)


def fused_program(state, tp, xstarts):
    """`make_fused_sga_program(select_best=True)` with `acquire`'s solver
    settings, so that both routes solve one problem."""
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.rollout import outer

    kw = {k: v for k, v in acquire.__kwdefaults__.items() if k != "program"}
    return outer.make_fused_sga_program(state, tp, EI(), xstarts, select_best=True, **kw)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return f"device: {device} (the plain PyTorch route; no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc
    from rollout_bo_tpu_torch.utils import graphs

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    device = resolve_device(p.parse_args(argv).device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    print(card_line(device))

    state, tp, xstarts, restarts = bench_problem(device, torch.float32)
    d, dtype = tp.lbs.shape[0], tp.lbs.dtype
    program = fused_program(state, tp, xstarts)

    def route(program):
        """bench.py's protocol: (SGA iterations, launches, seconds, winner)
        per acquisition, the warm-up first. The launches leave out those of
        the graphs' warm-up runs before a capture (the program's first
        call), which `warmup` holds per acquisition."""
        iterations, launches, warmup, times = [], [], [], []

        def run(rnstream):
            sync()
            nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
            t0 = time.perf_counter()
            res = acquire(state, tp._replace(rnstream=rnstream), xstarts, restarts,
                          program=program)
            sync()
            times.append(time.perf_counter() - t0)
            iterations.append(res.iterations)
            warmup.append(graphs.WARMUP_LAUNCHES - warm0)
            launches.append(nl.LAUNCHES - warmup[-1])
            return res

        res = run(tp.rnstream)                                 # warm-up
        if not (bool(torch.all(torch.isfinite(res.x))) and math.isfinite(float(res.value))):
            raise AssertionError(f"non-finite acquisition result x={res.x} v={res.value}")
        for _ in range(TIMED_RUNS):
            # a new stream tensor per call, as bench.py:84-91 (the same values:
            # the Sobol stream is deterministic)
            z = torch.tensor(qmc.gen_low_discrepancy_sequence(tp.mc_iters, d, tp.horizon + 1),
                             dtype=dtype, device=device)
            res = run(z)
        want = [tp.horizon * (it + 1) if cuda else 0 for it in iterations]
        if launches != want or any(warmup[1:]):
            raise AssertionError(f"lane-kernel launches {launches} != {want}, or warm-up "
                                 f"launches {warmup} after the first call")
        return iterations, launches, warmup[0], times[1:], res

    its, launches, _, times, eager = route(None)
    print(f"eager route: {statistics.median(times)} s per acquisition (median; {times}), "
          f"SGA iterations {its}, lane-kernel launches {launches}")
    iterations, launches, warm, times, res = route(program)
    print(f"program: capture {sum(g.capture_seconds for g in program.graphs)} s, "
          f"memory pools {sum(g.pool_bytes for g in program.graphs)} B, "
          f"{warm} lane-kernel launches in the warm-up runs before it; winner on the last "
          f"stream against the eager route's: max |dx| "
          f"{float(torch.max(torch.abs(res.x - eager.x)))}, |dv| "
          f"{abs(float(res.value) - float(eager.value))}")
    print(f"SGA iterations per acquisition (warm-up, then timed): {iterations}")
    print(f"lane-kernel launches per acquisition: {launches} "
          f"(expected {'horizon x (SGA iterations + 1)' if cuda else '0 on the CPU'})")
    print(f"seconds per acquisition (timed): {times}")
    val = statistics.median(times)
    print(json.dumps({"metric": METRIC, "value": val, "unit": "s",
                      "vs_baseline": BASELINE_S / val}))


if __name__ == "__main__":
    main()
