"""Multi-process worker: one rank of a `torch.distributed` group running
the fused multi-restart SGA solve over a mesh that spans every rank.

Port of `rollout_bo_tpu/parallel/multihost_worker.py`, the executable
proof of the multi-process leg of the parallel design: the reference fans
out with `Distributed.addprocs` + `SharedArrays` on one machine
(adaptive_bayesopt.jl:92-97, 483-488); here each process is one rank with
one device, the ('restarts', 'mc') mesh is restarts = 2 by mc = world / 2,
and the collectives (the per-restart MC reductions over 'mc', the
all-stopped all-reduce, the winner gather over 'restarts') ride NCCL
between cards, or gloo on the CPU. Over NCCL the solve and the timed
estimate run as CUDA-graph programs that hold those collectives
(`sharded_stochastic_solve_fused` builds its program; `sharded_simulate_mc`
keeps one per problem, so the timed calls are replays); gloo ranks on the
card run them eagerly (`parallel.mesh.programs_run_on`).

The worker builds a deterministic problem (the JAX worker's numbers, so a
test compares process 0's result with the JAX package's single-process
solve); with `--bench-mc` it also times `sharded_simulate_mc` (its first
call, the warm-up, captures).

Launch (2 processes, here on the CPU):

    python -m rollout_bo_tpu_torch.parallel.multihost_worker \\
        --process-id 0 --num-processes 2 --port 12395 --out p0.npz \\
        --backend gloo --device cpu &
    ... the same with --process-id 1 ...

On a machine with two cards, drop `--backend` and `--device` (NCCL, one
card per rank).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.parallel import sharded
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams


def build_problem(mc_iters: int = 16, horizon: int = 1, n_starts: int = 8, *,
                  device="cuda"):
    """The JAX worker's deterministic tiny GP problem, in float64 on
    `device`: (state, tp, xstarts, starts)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=device)
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, size=(6, 1)), axis=0)
    y = np.sin(6 * X[:, 0]) + 0.3 * X[:, 0]
    st = sg.fit(K.matern52((0.3,), device=device), X, y, capacity=12, noise=1e-6,
                device=device)
    z = np.random.default_rng(3).normal(size=(mc_iters, 2, horizon + 1))
    tp = TrajectoryParams(x0=t([0.52]), theta=t([0.0]), lbs=t([0.0]), ubs=t([1.0]),
                          rnstream=t(z))
    xstarts = t(qmc.generate_initial_guesses(4, [0.0], [1.0]))
    starts = t(np.linspace(0.1, 0.9, n_starts)[:, None])
    return st, tp, xstarts, starts


SOLVE_KW = dict(max_iters=4, inner_iterations=10)


def main(argv=None):
    p = argparse.ArgumentParser("multihost worker")
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--port", type=int, required=True,
                   help="rendezvous port of process 0 on localhost (tcp://)")
    p.add_argument("--out", default=None,
                   help="npz path for process 0's (xs, vals) result")
    p.add_argument("--bench-mc", type=int, default=0,
                   help="also time sharded_simulate_mc with this many "
                        "trajectories PER RANK (weak scaling probe)")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    p.add_argument("--device", default="cuda",
                   help="cuda (card process-id %% cards) or cpu")
    p.add_argument("--init-method", default=None,
                   help="rendezvous URL instead of tcp://localhost:PORT")
    args = p.parse_args(argv)

    world = args.num_processes
    # one device per process: the (restarts=2, mc=world/2) mesh needs an
    # even world of at least 2
    if world < 2 or world % 2 != 0:
        raise SystemExit(f"multihost_worker needs an even number of processes >= 2 to "
                         f"build its (restarts=2, mc={max(world // 2, 1)}) mesh; got {world}")
    torch.set_num_threads(1)
    nproc = mesh_mod.initialize_distributed(
        args.init_method or f"tcp://localhost:{args.port}", world, args.process_id,
        backend=args.backend)
    try:
        _solve(args, nproc)
    finally:
        mesh_mod.finalize_distributed()


def _solve(args, nproc):
    device = mesh_mod.rank_device(args.device)
    print(f"[p{args.process_id}] processes={args.num_processes} world={nproc} "
          f"device={device}", flush=True)
    mesh = mesh_mod.make_mesh(restarts=2, mc=nproc // 2)
    st, tp, xstarts, starts = build_problem(device=device)
    rule = dr.EI()
    xs, vals, _ = sharded.sharded_stochastic_solve_fused(st, tp, rule, xstarts, starts,
                                                         mesh, **SOLVE_KW)
    xs, vals = xs.cpu().numpy(), vals.cpu().numpy()
    print(f"[p{args.process_id}] winner={int(vals.argmax())} best={vals.max():.12f}",
          flush=True)

    if args.bench_mc:
        m = args.bench_mc * nproc
        stb, tpb, xstartsb, _ = build_problem(mc_iters=m, device=device)

        def run():
            out = sharded.sharded_simulate_mc(stb, tpb, rule, xstartsb, mesh,
                                              with_gradients=True, iterations=10)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return out

        run()                                   # warm-up
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        dt = (time.perf_counter() - t0) / reps
        print(f"[p{args.process_id}] bench_mc: {m} trajectories {dt * 1e3:.1f} ms/call "
              f"{m / dt:.0f} traj/s", flush=True)

    if args.out and args.process_id == 0:
        np.savez(args.out, xs=xs, vals=vals)
    print(f"[p{args.process_id}] OK", flush=True)


if __name__ == "__main__":
    main()
