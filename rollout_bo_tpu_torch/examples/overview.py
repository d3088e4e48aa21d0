"""Myopic GP + EI walkthrough: posterior, EI landscape, one BO run.

Port of the JAX package's `examples/overview.py`, the script analog of the
reference's `notebooks/overview.ipynb` (the myopic surrogate + EI
validation notebook): fit a GP to a few samples of a 1-D function, print
posterior / EI values across the domain, run a short myopic EI BO loop
(one lane-solver call per BO iteration: the CUDA kernel on the card), and
report the gap trajectory. float64.

Run:  python -m rollout_bo_tpu_torch.examples.overview [--function-name gramacylee]
      [--budget 15] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.models.decision_rules import EI
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout import bo


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--function-name", default="gramacylee")
    p.add_argument("--budget", type=int, default=15)
    p.add_argument("--n-init", type=int, default=4)
    p.add_argument("--grid", type=int, default=9)
    p.add_argument("--seed", type=int, default=42)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    f = testfns.get_function(args.function_name)
    rng = np.random.default_rng(args.seed)
    X0 = qmc.randsample(args.n_init, f.dim, f.lbs, f.ubs, rng)
    y0 = f.batch(X0).numpy()
    state = sg.fit(K.matern52((0.5,), device=dev), X0, y0,
                   capacity=args.n_init + args.budget, noise=1e-6, device=dev)
    theta = torch.zeros((1,), dtype=state.X.dtype, device=dev)

    print(f"== {args.function_name}: GP posterior / EI across the domain ==")
    print(f"{'x':>24}  {'mu':>10}  {'sigma':>9}  {'EI':>10}")
    grid = np.linspace(f.lbs, f.ubs, args.grid)
    rule = EI()
    x = torch.as_tensor(grid, dtype=state.X.dtype, device=dev)
    post = sg.posterior(state, x)                  # every grid point in one call
    a = sg.acquisition(state, rule, x, theta)
    rows = torch.stack([post.mu, post.sigma, a], dim=-1).cpu().numpy()
    for xv, (mu, sigma, ei) in zip(grid, rows):
        xs = np.array2string(np.asarray(xv), precision=3)
        print(f"{xs:>24}  {mu:>10.4f}  {sigma:>9.4f}  {ei:>10.6f}")

    print(f"\n== myopic EI BO, budget {args.budget} ==")
    res = bo.run_myopic_bo(f, rule, budget=args.budget, n_init=args.n_init,
                           seed=args.seed, device=dev)
    gaps = np.asarray(res.gaps)
    print(f"initial best y: {float(np.asarray(res.y)[:args.n_init].min()):.5f}")
    print(f"final best y:   {float(np.asarray(res.y).min()):.5f}"
          f"   (f* = {f.fmin:.5f})")
    print(f"gap trajectory: {np.array2string(gaps, precision=3)}")
    print(f"final gap:      {float(gaps[-1]):.4f}")
    return {"grid": grid, "mu_sigma_ei": rows, "X": res.X, "y": res.y, "gaps": gaps,
            "final_gap": float(gaps[-1])}


if __name__ == "__main__":
    main()
