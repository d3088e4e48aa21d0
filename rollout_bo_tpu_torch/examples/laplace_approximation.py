"""Repeated fantasy conditioning: allocation / reuse behavior.

Port of the JAX package's `examples/laplace_approximation.py`, the analog
of the reference's `notebooks/laplace_approximation.ipynb` (cells 2-4):
the notebook measures Julia allocations of constructing a fresh
FantasySurrogate and conditioning h+1 fantasy points on it, repeated
budget x simulations times (100 x 100).

Here the 100 simulations of one budget step are the lanes of ONE fantasy
state: each sweep starts from the base state and makes h + 1 = 2 rank-1
conditions, each one batched over the 100 episode lanes (eager PyTorch
ops). The state is a set of fixed-capacity tensors; on the card a sweep's
tensors come from PyTorch's caching allocator, which hands freed blocks
back to the next sweep. The example reports (a) the bytes of one
(unbatched) fantasy state, (b) the wall time of the 100 sweeps after a
warm-up, and (c) the peak device memory of those sweeps
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`,
beside what the process held before them; not measured on the CPU).
float32, as the JAX script, which leaves JAX's x64 mode off.

Run: python -m rollout_bo_tpu_torch.examples.laplace_approximation [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import qmc

BUDGET = 100        # notebook cell 3: outer loop
SIMULATIONS = 100   # notebook cell 3: inner loop
HORIZON = 1
INITIAL_SAMPLES = 9  # notebook cell 2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(p)
    dev = resolve_device(p.parse_args(argv).device)
    dt = torch.float32
    f = testfns.get_function("gramacylee")
    rng = np.random.default_rng(1906)
    X0 = qmc.randsample(INITIAL_SAMPLES, f.dim, f.lbs, f.ubs, rng)
    y0 = f.batch(X0).numpy()
    state = sg.fit(K.matern52((1.0,), device=dev, dtype=dt), X0, y0,
                   capacity=INITIAL_SAMPLES + 1, noise=1e-4, device=dev, dtype=dt)

    fs0 = fant.make_fantasy(state, HORIZON)
    fs_bytes = sum(v.nbytes for v in fs0 if torch.is_tensor(v)) + fs0.kernel.theta.nbytes

    lbs = torch.as_tensor(f.lbs, dtype=dt, device=dev)
    ubs = torch.as_tensor(f.ubs, dtype=dt, device=dev)
    us = torch.as_tensor(rng.uniform(size=(SIMULATIONS, HORIZON + 1, f.dim)), dtype=dt,
                         device=dev)

    def sweep():
        """All SIMULATIONS episodes of one budget step: a fresh fantasy state
        (lanes broadcast from fs0 on the first condition) + h+1 conditions."""
        fs = fs0
        for j in range(HORIZON + 1):
            xn = lbs + (ubs - lbs) * us[:, j]
            fs = fant.fantasy_condition(fs, xn, f.f(xn))
        return fs.cs[:, -1].sum()  # force the coefficient history

    sweep()  # warm-up
    peak_mb = before_mb = float("nan")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before_mb = torch.cuda.memory_allocated(dev) / 1e6
    t0 = time.perf_counter()
    acc = 0.0
    for _ in range(BUDGET):
        acc += float(sweep())
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6

    n_episodes = BUDGET * SIMULATIONS
    print(f"fantasy state size:        {fs_bytes / 1e3:.1f} kB (fixed, reused)")
    print(f"episodes:                  {n_episodes} "
          f"({BUDGET} budget x {SIMULATIONS} simulations, h={HORIZON})")
    print(f"total wall time:           {wall:.3f} s "
          f"({wall / n_episodes * 1e6:.1f} us/episode)")
    print(f"peak device memory:        "
          + (f"{peak_mb:.3f} MB, of which {before_mb:.3f} MB were allocated before "
             "the sweeps" if dev.type == "cuda" else "not measured (CPU)"))
    print("reference notebook measured ~6.6 GB of cumulative allocation churn for "
          "the same sweep (laplace_approximation.ipynb cell 4); here each budget "
          f"step is one fantasy state batched over {SIMULATIONS} episode lanes, "
          f"{HORIZON + 1} conditions per sweep as eager PyTorch ops"
          + ("; their tensors come from PyTorch's caching allocator, which reuses "
             "freed blocks." if dev.type == "cuda" else "."))
    if not np.isfinite(acc):
        raise AssertionError(f"non-finite coefficient history: {acc}")
    return {"fantasy_state_bytes": fs_bytes, "episodes": n_episodes, "wall_s": wall,
            "us_per_episode": wall / n_episodes * 1e6, "peak_mb": peak_mb,
            "allocated_before_mb": before_mb}


if __name__ == "__main__":
    main()
