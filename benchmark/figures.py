"""Measure a cell's fixed figure on the card: the lane kernel's iterations
per start on the cell's first acquisition, outside any window.

    python3 benchmark/figures.py --workload <cell>

The cell's first acquisition (the first BO iteration on design 0 of its
traffic's pool) is solved in the program's eager route, and every
lane-kernel solve is launched once more through
`ops/newton_lanes.py::_iterations_run`, which returns the iterations
each (lane, start) ran. Prints the mean over every start of
every launch as JSON: the `iterations_per_start` of the cell's file
(benchmark/cells/<cell>.json), which the lane kernel's roofline counts."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark import core
    from benchmark.loops import bo_trials
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.models.decision_rules import RULES
    from rollout_bo_tpu_torch.ops import kernels
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout import outer
    from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

    cell = core.Cell(args.workload, spec_path=ROOT / "BENCHMARK.json", data_root=ROOT)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device("cuda", 0)
    dt = getattr(torch, cfg["dtype"])
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    loop = bo_trials.Loop(cell, 0, dev)
    X = loop.x_init((bo_trials.DESIGN, 0), tr["n_init"])
    y = loop.f(torch.tensor(X)).numpy()
    xstarts, restarts, z, box = loop.xstarts, loop.restarts, loop.z, (loop.lbs, loop.ubs)
    cap = cfg["capacity"]
    kernel = getattr(kernels, cfg["kernel"])((cfg["lengthscale"],), device=dev, dtype=dt)
    state = sg.fit(kernel, X, y, capacity=cap, noise=cfg["noise"], device=dev, dtype=dt)
    tp = TrajectoryParams(x0=t(restarts), theta=torch.zeros(1, dtype=dt, device=dev),
                          lbs=t(box[0]), ubs=t(box[1]), rnstream=t(z))
    totals = [0, 0]
    solve = nl.newton_solve_lanes

    def counted(*a, **kw):
        runs = nl._iterations_run(*a, **kw)
        totals[0] += int(runs.sum())
        totals[1] += runs.numel()
        return solve(*a, **kw)

    nl.newton_solve_lanes = counted
    try:
        res = outer.stochastic_solve_fused(state, tp, RULES[tr["rule"]](), t(xstarts),
                                           t(restarts), max_iters=tr["sgd_iters"], lr=tr["lr"],
                                           inner_iterations=tr["solver_iterations"],
                                           select_best=True)
    finally:
        nl.newton_solve_lanes = solve
    print(json.dumps({"workload": cell.name,
                      "sga_iterations": int(res.iterations),
                      "iterations_per_start": totals[0] / totals[1],
                      "starts_counted": totals[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
