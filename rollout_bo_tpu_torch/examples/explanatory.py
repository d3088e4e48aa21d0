"""1-D rollout-acquisition sweep: value, adjoint gradient, FD validation.

Port of the JAX package's `examples/explanatory.py`, the script analog of
the reference's de-facto integration test `notebooks/explanatory.ipynb`
(cells 10-12): sweep a 1-D domain, evaluate the h-step Monte-Carlo rollout
acquisition with its adjoint gradient, and compare the gradient against
centered finite differences of the MC estimate under common random numbers
(the same fixed QMC stream on both sides). float64.

The estimator is batch-first: the grid points are one batch of starts.
Three simulate calls make the sweep (h lane-solver calls each): the values
and gradients at every grid point, then the values at every point + eps,
then at every point - eps. The + and - evaluations of a point thus run at
the same lane and batch shape (the card's dense math rounds by batch
size, and a rounding difference can move an inner argmax at a near tie).

A row agrees with FD when |grad - fd| <= 5e-3 |fd| + 5e-6; the count is
printed and nothing is gated on it: where the inner argmax changes basin
within +-eps, FD measures a jump the pathwise gradient does not have.

Run:  python -m rollout_bo_tpu_torch.examples.explanatory [--horizon 2] [--mc 64]
      [--grid 21] [--csv out.csv] [--device cuda]
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
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# a row's adjoint gradient agrees with FD when |g - fd| <= RTOL |fd| + ATOL
FD_RTOL, FD_ATOL = 5e-3, 5e-6


def fd_agrees(grad, fd):
    """Rows whose adjoint gradient agrees with the FD one (boolean array)."""
    grad, fd = np.asarray(grad), np.asarray(fd)
    return np.abs(grad - fd) <= FD_RTOL * np.abs(fd) + FD_ATOL


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--horizon", type=int, default=2)
    p.add_argument("--mc", type=int, default=64)
    p.add_argument("--grid", type=int, default=21)
    p.add_argument("--eps", type=float, default=1e-4)
    p.add_argument("--function-name", default="gramacylee")
    p.add_argument("--csv", default=None, help="optional output CSV path")
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=dev)  # noqa: E731

    f = testfns.get_function(args.function_name)
    d = f.dim
    rng = np.random.default_rng(7)
    X0 = qmc.randsample(4, d, f.lbs, f.ubs, rng)
    y0 = f.batch(X0).numpy()
    state = sg.fit(K.matern52((0.5,), device=dev), X0, y0, capacity=16, noise=1e-6,
                   device=dev)

    xstarts = t(qmc.generate_initial_guesses(6, f.lbs, f.ubs))
    z = t(qmc.gen_low_discrepancy_sequence(args.mc, d, args.horizon + 1))
    tp = TrajectoryParams(x0=None, theta=t([0.0]), lbs=t(f.lbs), ubs=t(f.ubs), rnstream=z)
    rule = EI()

    def estimate(x0, with_gradients):
        return mc_mod.simulate_trajectory_mc(
            state, tp._replace(x0=x0), rule, xstarts, with_gradients=with_gradients,
            iterations=8, draw_mode="reparam")

    grid = np.linspace(f.lbs[0], f.ubs[0], args.grid)
    x0 = t(np.repeat(grid[:, None], d, axis=1))           # (grid, d): [x] * d
    step = torch.zeros_like(x0)
    step[:, 0] = args.eps
    out = estimate(x0, True)
    # centered FD under common random numbers (same z stream), the + and -
    # sides at the same batch shape
    mu_p = estimate(x0 + step, False).mu
    mu_m = estimate(x0 - step, False).mu
    fd = (mu_p - mu_m) / (2 * args.eps)
    arr = np.column_stack([grid] + [v.cpu().numpy() for v in (out.mu, out.grad_x[:, 0], fd)])

    print(f"{'x':>8} {'alpha(x)':>12} {'grad (adjoint)':>15} {'grad (FD of MC)':>16}")
    for x, mu, g, fdv in arr:
        print(f"{x:8.3f} {mu:12.6f} {g:15.6f} {fdv:16.6f}")

    # agreement where the acquisition is active (nonzero value)
    active = arr[:, 1] > 1e-8
    max_rel = None
    if active.any():
        err = np.abs(arr[active, 2] - arr[active, 3])
        scale = np.maximum(np.abs(arr[active, 3]), 1e-6)
        max_rel = float((err / scale).max())
        print(f"\nmax relative |adjoint - FD| over active points: {max_rel:.2e}")
    agree = int(fd_agrees(arr[:, 2], arr[:, 3]).sum())
    print(f"rows where |adjoint - FD| <= {FD_RTOL:g} |FD| + {FD_ATOL:g}: "
          f"{agree} of {len(arr)}")
    if args.csv:
        np.savetxt(args.csv, arr, delimiter=",", header="x,alpha,grad_adjoint,grad_fd",
                   comments="")
        print(f"wrote {args.csv}")
    return {"rows": arr, "max_rel_active": max_rel, "fd_agree": agree}


if __name__ == "__main__":
    main()
