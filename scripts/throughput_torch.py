"""Rollout trajectory throughput of the PyTorch port: trajectories/s per
card, and a weak-scaling check over ranks of torch.distributed.

The port's counterpart of scripts/throughput.py, with the same flags,
problem and measured call. One "trajectory" = one h-step fantasy rollout
(h inner multistart-Newton solves, h+1 joint (f, grad f) draws, rank-1
conditions) PLUS its reverse-mode gradient w.r.t. (x0, theta): one lane of
the production estimator `rollout.mc.simulate_trajectory_mc(with_gradients=True)`.
The problem is bench.py's surrogate (12 observations of `--function`,
capacity 20, Matern-5/2 with lengthscale 1, seed 1906), 8 + 2 inner starts,
float32, x0 = 0, `--mc` QMC trajectories.

Default mode measures the card: one warm-up call, then the median of
`--reps` calls, each ending in `torch.cuda.synchronize()`, of the call as
one program (`utils.graphs.GraphProgram`, a CUDA graph: the counterpart
of the `jax.jit` that scripts/throughput.py:146-150 times), captured by a
call before the warm-up. The same protocol first times the call run
eagerly, on a line of its own. It checks on both routes that each call
launched the lane kernel `--horizon` times. The last line is the
program's.

`--nworkers N --backend gloo|nccl` (the flags of the port's non-myopic
CLI) is the counterpart of `--virtual N`: for n = 1, 2, 4, 8 up to N it
spawns n ranks, each holding `--mc` trajectories (weak scaling: a fixed
batch per rank), and times `parallel.sharded.sharded_simulate_mc` over
them; a timed call's seconds are the slowest rank's. Ranks that share one
host's cores, or one card (gloo), validate that the trajectories split
over the ranks without replicated work; they are NOT a hardware scaling
measurement. NCCL runs one rank per card and refuses more ranks than cards
(`parallel.mesh.check_backend`), as the CLI does.

Usage:
  python scripts/throughput_torch.py                                 # the card, prints JSON
  python scripts/throughput_torch.py --nworkers 2 --backend gloo     # two ranks sharing it
  python scripts/throughput_torch.py --device cpu --mc 8 --horizon 1  # the plain CPU route
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402  (bench.py's problem)
from rollout_bo_tpu_torch.experiments.myopic import add_device_argument  # noqa: E402
from rollout_bo_tpu_torch.experiments.myopic import resolve_device  # noqa: E402
from rollout_bo_tpu_torch.utils.graphs import GraphProgram  # noqa: E402

# reference: one serial Julia trajectory + gradient of the h=3 trid10d
# configuration is ~309.4 s / (50 SGD iterations x 8 restarts x 200 MC)
# at the bench shape, ~3.9 ms per trajectory, ~258 trajectories/s
REFERENCE_EQUIV_TRAJ_PER_S = (50 * 8 * 200) / 309.4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nworkers", type=int, default=0,
                   help="weak-scaling check over 1, 2, 4, 8 ranks, up to N "
                        "(0: the single-card measurement)")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                   help="torch.distributed backend of the ranks: nccl needs one "
                        "card per rank; gloo serves ranks that share a card or "
                        "run on the CPU")
    p.add_argument("--mc", type=int, default=4096, help="trajectories per call (per rank)")
    p.add_argument("--horizon", type=int, default=3)
    p.add_argument("--function", default="trid10d")
    p.add_argument("--inner-iterations", type=int, default=10)
    p.add_argument("--reps", type=int, default=5)
    add_device_argument(p)
    return p.parse_args(argv)


def _problem(args, device, mc):
    state, tp, xstarts, _ = bench_torch.bench_problem(
        device, torch.float32, name=args.function, mc=mc, horizon=args.horizon)
    return state, tp, xstarts


def _timed(call, reps, sync):
    """One warm-up call, then `reps` timed ones; (seconds per call, last result)."""
    out = call()
    sync()
    seconds = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = call()
        sync()
        seconds.append(time.perf_counter() - t0)
    return seconds, out


def single_card(args, device):
    """The single-device measurement: (the results dict, the last estimate)."""
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout import mc as mc_mod

    cuda = device.type == "cuda"
    state, tp, xstarts = _problem(args, device, args.mc)
    estimate = lambda st, tpx: mc_mod.simulate_trajectory_mc(
        st, tpx, EI(), xstarts, with_gradients=True, iterations=args.inner_iterations)
    call = lambda: estimate(state, tp)
    program = GraphProgram(estimate, device=device)

    def timed(fn):
        nl.LAUNCHES = 0
        seconds, eto = _timed(fn, args.reps, torch.cuda.synchronize if cuda else (lambda: None))
        launches = nl.LAUNCHES / (args.reps + 1)
        if launches != (args.horizon if cuda else 0):
            raise AssertionError(f"{launches} lane-kernel launches per call on {device}, "
                                 f"expected {args.horizon if cuda else 0}")
        return statistics.median(seconds), eto, launches

    dt, _, _ = timed(call)
    print(f"eager route: {dt} s per call (median of {args.reps}), "
          f"{args.mc / dt} trajectories/s")
    program(state, tp)          # the capture; the timed calls are replays
    dt, eto, launches = timed(lambda: program(state, tp))
    print(f"program: capture {program.capture_seconds} s, memory pool "
          f"{program.pool_bytes} B")
    return dict(_header(args, device), mode="single_chip", seconds_per_call=dt,
                value=args.mc / dt, unit="trajectories/s/chip",
                reference_equiv_traj_per_s=REFERENCE_EQUIV_TRAJ_PER_S,
                lane_kernel_launches_per_call=launches,
                **(_lane_kernel_times(call) if cuda else {})), eto


def _lane_kernel_times(call):
    """The lane kernel inside one more call (after the timed ones): the
    CUDA-event ms of each launch, the iterations its starts ran (one more
    launch on the same lanes, `newton_lanes._iterations_run`: a start stops
    at its fixed point) and the least time the card could take for the work
    they need (`chip_smoke.lane_bound`)."""
    import chip_smoke
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    real, launches = nl.newton_solve_lanes, []

    def timed(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, *rest, **kw):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, *rest, **kw)
        stop.record()
        runs = nl._iterations_run(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, *rest,
                                  **kw)
        launches.append((start, stop, n, X, xstarts.shape[0], kw["iterations"], runs))
        return out

    nl.newton_solve_lanes = timed
    try:
        call()
    finally:
        nl.newton_solve_lanes = real
    torch.cuda.synchronize()
    ms, bounds, ran = [], [], []
    for start, stop, n, X, S, iterations, runs in launches:
        ms.append(start.elapsed_time(stop))
        bounds.append(chip_smoke.lane_bound(n.tolist(), X.shape[1], X.shape[2], S,
                                            iterations, X.dtype, runs))
        ran.append(float(runs.double().mean()))
    return dict(lane_kernel_lanes=launches[0][3].shape[0], lane_kernel_ms=ms,
                lane_kernel_iterations_run=ran,
                lane_kernel_bound_ms=[b["bound_ms"] for b in bounds],
                lane_kernel_bound_by=bounds[0]["bound_by"])


def _header(args, device):
    from rollout_bo_tpu_torch.models import testfns

    return {"metric": "rollout_trajectories_per_second", "function": args.function,
            "horizon": args.horizon, "dim": testfns.get_function(args.function).dim,
            "mc_per_call": args.mc,
            "inner_iterations": args.inner_iterations, "with_gradients": True,
            "backend": device.type, "n_devices": torch.cuda.device_count()}


def _rank(rank, world, init_method, args, out):
    """One rank of an n-rank run: the sharded estimate over world x --mc
    trajectories, timed after a barrier; writes its seconds to out."""
    import torch.distributed as dist

    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
    from rollout_bo_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method, world, rank, backend=args.backend)
    try:
        device = mesh_mod.rank_device(args.device)
        cuda = device.type == "cuda"
        state, tp, xstarts = _problem(args, device, args.mc * world)
        mesh = mesh_mod.make_mesh(restarts=1, mc=world)

        def sync():
            if cuda:
                torch.cuda.synchronize(device)
            dist.barrier()

        seconds, _ = _timed(lambda: sharded.sharded_simulate_mc(
            state, tp, EI(), xstarts, mesh, with_gradients=True,
            iterations=args.inner_iterations), args.reps, sync)
        with open(f"{out}-rank{rank}.json", "w") as fh:
            json.dump(seconds, fh)
    finally:
        mesh_mod.finalize_distributed()


def rank_scaling(args, device):
    """Weak scaling over n = 1, 2, 4, 8 (up to --nworkers) spawned ranks."""
    import torch.multiprocessing as mp

    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.check_backend(args.backend, args.nworkers, device.type)
    rows = []
    tmp = tempfile.mkdtemp(prefix="throughput_torch-")
    try:
        for n in (1, 2, 4, 8):
            if n > args.nworkers:
                break
            out = os.path.join(tmp, f"n{n}")
            mp.start_processes(_rank, args=(n, f"file://{out}-store", args, out),
                               nprocs=n, start_method="spawn")
            per_rank = []
            for r in range(n):
                with open(f"{out}-rank{r}.json") as fh:
                    per_rank.append(json.load(fh))
            dt = statistics.median(max(s) for s in zip(*per_rank))
            rows.append({"devices": n, "trajectories": args.mc * n, "seconds": dt,
                         "traj_per_s": args.mc * n / dt})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    base = rows[0]["traj_per_s"]
    for r in rows:
        r["weak_scaling_efficiency"] = r["traj_per_s"] / (base * r["devices"])
    return dict(_header(args, device), mode="ranks_weak_scaling",
                dist_backend=args.backend, rows=rows)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    results = rank_scaling(args, device) if args.nworkers else single_card(args, device)[0]
    sys.stdout.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main()
