"""Cost of repeated fantasy conditioning: rank-1 updates vs refits.

Port of the JAX package's `examples/fantasy_conditioning.py`, the script
analog of the reference's `notebooks/laplace_approximation.ipynb`, which
measures the allocation behavior of repeatedly conditioning a
FantasySurrogate. The fantasy state is a set of fixed-capacity tensors, so
the costs to compare are (a) the time of the rank-1 Schur append
(`fantasy_condition`) against a full O(N^3) refactorization
(`surrogate.refit`), and (b) the posterior at each fantasy index. It also
checks that h conditions followed by `fantasy_reset` restore the base
posterior (reference reset!, rbs.jl:476-480), to 1e-12. float64.

Times on the card come from CUDA events around 20 calls after a warm-up
(device time per call); on the CPU from the host clock.

Run:  python -m rollout_bo_tpu_torch.examples.fantasy_conditioning [--capacity 64]
      [--horizon 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K


def _timeit(fn, device: torch.device, repeats=20):
    """Seconds per call of fn() after one warm-up call: CUDA events on the
    card (the queue drained before and after), the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(repeats):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--n-init", type=int, default=24)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--dim", type=int, default=4)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=dev)  # noqa: E731

    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (args.n_init, args.dim))
    y = np.sin(X.sum(axis=1))
    state = sg.fit(K.matern52((1.0,), device=dev), X, y, capacity=args.capacity,
                   noise=1e-6, device=dev)
    fs = fant.make_fantasy(state, args.horizon)

    xnew = t(rng.uniform(-1, 1, (args.dim,)))
    ynew = t(0.3)

    t_cond = _timeit(lambda: fant.fantasy_condition(fs, xnew, ynew), dev)
    t_refit = _timeit(lambda: sg.refit(state), dev)

    print(f"n={args.n_init}, capacity={args.capacity}, horizon={args.horizon}")
    print(f"rank-1 fantasy condition: {t_cond * 1e3:9.3f} ms")
    print(f"full refactorization:     {t_refit * 1e3:9.3f} ms")
    print(f"speedup:                  {t_refit / t_cond:9.2f}x")

    # condition h times, inspect per-index posterior, then reset
    fs_h = fs
    for _ in range(args.horizon):
        xj = t(rng.uniform(-1, 1, (args.dim,)))
        fs_h = fant.fantasy_condition(fs_h, xj, t(float(rng.standard_normal())))
    xq = t(rng.uniform(-1, 1, (args.dim,)))
    print("\nposterior sigma at a held-out point by fantasy index:")
    sigmas = {}
    for fi in range(-1, args.horizon):
        sigmas[fi] = float(sg.posterior(fant.view(fs_h, fi), xq).sigma)
        print(f"  index {fi:2d}: sigma = {sigmas[fi]:.6f}")

    fs_r = fant.fantasy_reset(fs_h)
    s0 = float(sg.posterior(fant.view(fs, -1), xq).sigma)
    s1 = float(sg.posterior(fant.view(fs_r, -1), xq).sigma)
    if not abs(s0 - s1) < 1e-12:
        raise AssertionError(f"reset does not restore the base posterior: {s0} vs {s1}")
    print(f"\nreset restores base posterior exactly (sigma {s1:.6f})")
    return {"condition_s": t_cond, "refit_s": t_refit, "speedup": t_refit / t_cond,
            "sigmas": sigmas, "reset_sigmas": (s0, s1)}


if __name__ == "__main__":
    main()
