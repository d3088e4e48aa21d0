"""Non-myopic rollout BO end to end: the block-triangular adjoint in action.

Port of the JAX package's `examples/rollout_bo.py`, the script analog of
the reference's `notebooks/rollout_bo.ipynb` ("Differentiating Policies for
Non-Myopic Rollout Bayesian Optimization"). That notebook derives the
forward system of an h-step rollout trajectory

    r_j(x_j; x_0, y_0, ..., x_{j-1}, y_{j-1}, theta) = 0   (inner argmax)
    f(x_j) - y_j = 0                                        (observation)

and its adjoint: the variations solve the block-lower-triangular system
L v = -q dtheta - g dx0, so dy_t/dx0 = -e_m^T L^{-1} g and
dy_t/dtheta = -e_m^T L^{-1} q. This script runs that math, in float64:

1. the h-step rollout acquisition and its gradient (d/dx0 and d/dtheta) at
   a batch of points, all in one simulate call: autograd through the
   trajectory with the implicit-function rule on each inner argmax
   (rollout/trajectory.py); the explicit dual back-substitution
   (rollout/adjoint.py) cross-checks autograd on one sample path;
2. multi-restart SGA of the acquisition (`outer.stochastic_solve_fused`)
   and a short non-myopic BO loop, its gap curve against the myopic EI
   baseline on the same seed.

Run:  python -m rollout_bo_tpu_torch.examples.rollout_bo [--function-name gramacylee]
      [--horizon 2] [--mc 32] [--budget 8] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.models.decision_rules import EI
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout import adjoint as adj
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.rollout import mc as mc_mod
from rollout_bo_tpu_torch.rollout import outer as outer_mod
from rollout_bo_tpu_torch.rollout import trajectory as traj
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--function-name", default="gramacylee")
    p.add_argument("--horizon", type=int, default=2)
    p.add_argument("--mc", type=int, default=32)
    p.add_argument("--budget", type=int, default=8)
    p.add_argument("--n-init", type=int, default=4)
    p.add_argument("--seed", type=int, default=11)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=dev)  # noqa: E731
    num = lambda a: a.detach().cpu().numpy()  # noqa: E731

    f = testfns.get_function(args.function_name)
    d, h = f.dim, args.horizon
    rng = np.random.default_rng(args.seed)
    X0 = qmc.randsample(args.n_init, d, f.lbs, f.ubs, rng)
    y0 = f.batch(X0).numpy()
    state = sg.fit(K.matern52((0.5,), device=dev), X0, y0,
                   capacity=args.n_init + args.budget + 1, noise=1e-6, device=dev)

    xstarts = t(qmc.generate_initial_guesses(6, f.lbs, f.ubs))
    z = t(qmc.gen_low_discrepancy_sequence(args.mc, d, h + 1))
    tp = TrajectoryParams(x0=t(np.zeros(d)), theta=t([0.0]), lbs=t(f.lbs), ubs=t(f.ubs),
                          rnstream=z)
    rule = EI()

    # -- 1) acquisition surface + adjoint gradients ------------------------
    print(f"== {args.function_name}: h={h} rollout acquisition and its "
          f"adjoint gradient ({args.mc} QMC trajectories) ==")
    print(f"{'x0':>22}  {'alpha_h(x0)':>12}  {'d alpha/dx0':>22}  {'d alpha/dtheta':>14}")
    probe = np.linspace(f.lbs, f.ubs, 7)[1:-1]
    eto = mc_mod.simulate_trajectory_mc(state, tp._replace(x0=t(probe)), rule, xstarts,
                                        with_gradients=True, iterations=10)
    surface = np.column_stack([num(eto.mu), num(eto.grad_x), num(eto.grad_theta)[:, 0]])
    for xv, row in zip(probe, surface):
        xs = np.array2string(np.asarray(xv), precision=3)
        gs = np.array2string(row[1:1 + d], precision=4)
        print(f"{xs:>22}  {row[0]:>12.6f}  {gs:>22}  {row[-1]:>14.6f}")

    # cross-check the autograd gradient against the explicit dual
    # back-substitution (the notebook's block-triangular L^{-1} system) on
    # one sample path under identical (sample_path) draw semantics. The two
    # agree where the trajectory improves on the incumbent at a step t >= 1
    # and the inner argmaxes of steps 1..t are interior (at the box, the IFT
    # rule pins a coordinate and the dual does not): the path is the first
    # (probe, trajectory) pair that does so, the middle probe's z[0] if none
    # does.
    fs0 = fant.make_fantasy(state, h)
    fmini = traj.base_fmini(fs0)

    def rollout(x0, zk):
        return traj.rollout_trajectory(fs0, x0.expand(zk.shape[:-2] + (d,)), tp.theta,
                                       tp.lbs, tp.ubs, xstarts, zk, rule, iterations=10,
                                       draw_mode="sample_path")

    def case3_interior(rec):
        best = torch.argmin(rec.ys, -1)
        inside = ((rec.xs > tp.lbs + 1e-6) & (rec.xs < tp.ubs - 1e-6)).all(-1)
        steps = torch.arange(h + 1, device=dev)
        interior = (inside | (steps == 0) | (steps > best[..., None])).all(-1)
        return (torch.amin(rec.ys, -1) < fmini) & (best >= 1) & interior

    # every probe x every sample path in one batch (P, M), then each
    # candidate alone (the batch may round another way)
    _, rec_all = rollout(t(probe)[:, None, :], z.expand((len(probe),) + z.shape))
    i, k = len(probe) // 2, 0
    for ic, kc in torch.nonzero(case3_interior(rec_all)).tolist():
        if bool(case3_interior(rollout(t(probe[ic]), z[kc])[1])):
            i, k = ic, kc
            break
    x_probe = t(probe[i])
    fs_final, rec = rollout(x_probe, z[k])
    x_leaf = x_probe.clone().requires_grad_(True)
    th_leaf = tp.theta.clone().requires_grad_(True)
    with torch.enable_grad():
        r = traj.trajectory_reward(fs0, x_leaf, th_leaf, tp.lbs, tp.ubs, xstarts, z[k], rule,
                                   iterations=10, draw_mode="sample_path")
        gx_ad, gth_ad = torch.autograd.grad(r, (x_leaf, th_leaf))
    gx_adj, gth_adj = adj.gradient_adjoint(fs_final, rec, rule, tp.theta)
    den = max(float(torch.max(torch.abs(gx_ad))), 1e-12)
    err = float(torch.max(torch.abs(gx_adj - gx_ad))) / den
    case3 = bool(case3_interior(rec))
    print(f"\nexplicit dual back-substitution vs autodiff-of-scan gradient "
          f"(one sample path, x0 {np.array2string(probe[i], precision=3)}, z[{k}]"
          + (f", best step {int(torch.argmin(rec.ys))}, interior" if case3 else
             ", no improving interior path at t >= 1") + f"): max rel err {err:.3e}")

    # -- 2) SGA ascent + short non-myopic BO loop --------------------------
    restarts = t(qmc.generate_batch(4, f.lbs, f.ubs)[:4])
    sga = outer_mod.stochastic_solve_fused(state, tp, rule, xstarts, restarts, max_iters=15,
                                           lr=0.05, inner_iterations=10)
    vals = num(sga.value)
    j = int(np.argmax(vals))
    print(f"\nmulti-restart SGA (fused solve, {sga.iterations} iterations): best restart "
          f"alpha={vals[j]:.6f} at x={np.array2string(num(sga.x)[j], precision=4)}")

    print(f"\n== non-myopic (h={h}) vs myopic EI BO, budget {args.budget} ==")
    res_nm = bo.run_nonmyopic_bo(f, budget=args.budget, n_init=args.n_init, seed=args.seed,
                                 horizon=h, mc_iters=args.mc, num_restarts=4, sgd_iters=15,
                                 device=dev)
    res_my = bo.run_myopic_bo(f, rule, budget=args.budget, n_init=args.n_init,
                              seed=args.seed, device=dev)
    g_nm, g_my = np.asarray(res_nm.gaps), np.asarray(res_my.gaps)
    print(f"rollout gap curve: {np.array2string(g_nm, precision=3)}")
    print(f"myopic  gap curve: {np.array2string(g_my, precision=3)}")
    print(f"final gaps: rollout {float(g_nm[-1]):.4f}  myopic {float(g_my[-1]):.4f}")
    return {"probe": probe, "surface": surface, "adjoint_rel_err": err,
            "adjoint_path": (i, k), "adjoint_case3_interior": case3,
            "adjoint": (num(gx_adj), num(gth_adj)), "autograd": (num(gx_ad), num(gth_ad)),
            "sga_x": num(sga.x), "sga_values": vals, "sga_iterations": sga.iterations,
            "gaps_rollout": g_nm, "gaps_myopic": g_my, "sga_iterations_bo": res_nm.sga_iterations,
            "fallbacks": res_nm.fallbacks}


if __name__ == "__main__":
    main()
