#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`rollout_bo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA Hopper card
(H100). Phases, each ending in `torch.cuda.synchronize()`:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles csrc/newton_lanes.cu with nvcc (sm_90a) and prints the
   build seconds, the compiler's register / stack / spill report and the
   blocks an SM holds at the bench shape;
3. kernel vs plain version on the card: the CUDA Newton lane kernel
   against `newton_solve_lanes_ref` on the same inputs, at the bench shape
   (1600 lanes, capacity 24, d 10, 10 starts, matern52 / EI, float32),
   on lanes of that shape whose Newton steps move, at d = 16 (the
   kernel's maximum) in float32 and float64, each timed and set against
   the least time the card could take for the same work; at small shapes
   for every kernel kind x rule in float32 and float64 with per-lane active
   counts, plus the loose freeze (POI); and at the edges of the block
   layout (1 and 40 starts, 7 and 1601 lanes, a lane with no data and a
   full one, capacity 64 at d 16 in float64); and at the two shapes the BO
   loops give it, both in float64 at d 6 (hartmann6d): the myopic loop's
   (1 lane of 104 observations in a capacity-105 buffer, 64 + 2 starts, 12
   iterations) and the non-myopic loop's (2000 lanes = 10 restarts x 200
   trajectories, fantasy capacity 23, 16 + 2 starts), each timed and set
   against its bound.
   Criteria (tests/test_pallas_newton.py): (a) the kernel's value matches
   a plain re-evaluation of the acquisition at its argmax; (b) its
   solution is never worse than the plain solver's beyond tolerance. In
   float32, rounding can part two correct solvers on a lane (another
   backtracking step at a near-tie, then another basin): where the kernel
   misses (b) or ends elsewhere than the plain version, the plain
   version's float64 run on the same inputs arbitrates. (b) is void on a
   lane where that run and the float32 one are themselves farther apart
   than (b) grants, and a lane agrees if the kernel ends where the
   float64 run does; both counts are printed;
4. main path: the port's `make_fused_sga_program(select_best=True)` (CUDA
   graphs of one SGA step and of the final pass), built once as
   `bench_torch.py` builds it, at the exact bench.py configuration
   (trid10d, horizon 3, 200 QMC trajectories, 8 restarts, 10 + 8 + 2 inner
   starts, 50 SGA iterations, float32) on the card; the first call
   captures. Checks a finite winner inside the box, each graph captured
   once, that the first call ran the kernel 3 x (SGA iterations + 1)
   times besides the 3 x 2 x 3 of the graphs' warm-up runs, that a small
   float64 run of the same path agrees with the CPU route (the plain
   solver, the program run eagerly); times the median of 2 acquisitions
   after the first, each launching the kernel 3 x (SGA iterations + 1)
   times. The `kernels` line's launches are the first call's;
5. myopic BO, one full-protocol trial through the experiment CLI
   (`experiments.myopic.main`, its default `--steps-per-call 0`: the
   budget as one chunk program, a CUDA graph of one BO iteration replayed
   100 times): hartmann6d, budget 100, 64 starts, EI / POI / LCB / Random,
   5 initial samples, Matern-5/2 with the MLE every iteration, float64.
   Checks every CSV (header, sentinel, one row of 100 finite numbers), gaps
   in [0, 1] and non-decreasing, 100 kernel launches per solved acquisition
   and none for Random (the warm-up runs of the capture taken off), the
   fitted lengthscale in [0.1, 5], EI's final gap > 0. Prints per
   acquisition the final gap, the seconds per BO iteration (the chunk's
   over 100; the trial's over 100), the fitted lengthscale and the share of
   solves whose winner left its start point (over the warm-up runs: a
   replay hides the rest). Then, timed apart from the trials: the observe
   program (condition + MLE) at n 105 against the eager observe, bit for
   bit, with the eager refit's ms and the replay's; and one EI trial at a
   cut budget (10) in the eager loop and through its chunk program in one
   process: the same points bit for bit, the seconds per BO iteration of
   each, the captures, capture seconds and pool bytes;
6. non-myopic BO, one trial through `experiments.nonmyopic.main` at the
   CLI's width: hartmann6d, horizon 2, 200 QMC trajectories, 8 + 2
   restarts, 50 SGA iterations, 16 + 2 starts, MLE on, float64, budget 15
   (depth; the widths are the CLI's defaults). Same CSV checks; kernel
   launches = sum over BO iterations of horizon x (SGA iterations + 1),
   plus one per fallback taken, besides those of the graphs' warm-up runs
   (the acquisitions, the observe step and the fallback run their cached
   programs). Prints seconds per BO iteration, SGA iterations per
   acquisition, fallbacks, the final gap, the refit and observe ms timed
   apart (the observe program at n 20 against the eager observe, bit for
   bit) and the share of solver lanes that left their start (over the
   solver calls a replay does not hide: the warm-up runs and the
   fallbacks). Then one BO iteration with `--deterministic-solve` at the
   same width (8 Gauss-Hermite nodes: 512 quadrature trajectories per
   restart) through its program, timed;
7. small float64 trials, card against CPU route: a 4-iteration myopic
   trial, a 2-iteration non-myopic trial (h 1, 8 samples), one
   `deterministic=True` iteration (h 1, 4 Gauss-Hermite nodes), a
   3-iteration adaptive trial (h 1, 8 samples) and a 2-iteration
   cost-aware non-myopic trial (cost_aware(EI, NonUniformCost), h 1, 8
   samples), each run on the card and with device="cpu": the same sampled
   points to 1e-6 of the box width and the same fitted lengthscale to 1e-6
   relative;
8. adaptive-horizon BO, one trial through `experiments.adaptive.main` at
   the CLI's widths: hartmann6d, the alternating schedule h = 0, 2, 0, 2,
   ..., 100 QMC trajectories, 8 + 2 restarts, 50 SGA iterations, 16 + 2
   starts, MLE on, float64, budget 15. Checks the four CSVs, that no
   `hartmann6d_failed.txt` was written (the CLI catches a failed trial),
   the allocations finite and >= 0, and per BO iteration kernel launches =
   h x (SGA iterations + 1) + the fallback's one, so none in an h = 0
   iteration but a fallback's. Prints the acquisition median for h = 0 and
   h = 2, SGA iterations, the refit and observe ms timed apart (at n 16),
   the final gap and the peak device bytes per h = 2 acquisition. Then
   the exploration fallback's program on a state of that size against its
   eager call: bit for bit, one launch per call, timed;
9. cost-aware BO through `experiments.cost_aware.main` at the CLI's
   widths (braninhoo, 100 QMC trajectories, 8 + 2 restarts, 8 + 2 starts,
   h 1, 50 SGA iterations, float32, modes uniform / nonuniform / gp),
   budget 1 (depth). Checks the CSVs, costs in [1, 1 + amp], gaps in
   [0, 1], one cached acquisition program (two graphs) and one observe
   graph per mode, every capture in a cached program, and kernel launches
   == fallbacks taken: a cost-aware solve never reaches the kernel (the
   torch `newton_solve_batch` takes it). The trials run as users run
   them, through the program cache. Then one eager simulate call at the
   same width, in turns for plain EI (the kernel) and the three cost-aware
   rules on the same inputs: the cost channel's price per call. Prints
   per mode the acquisition median, and from the eager call the seconds
   per simulate call, `newton_solve_batch`'s share of it (CUDA events
   around each solver call, which a replay hides) and the cumulative cost;
10. the sharded path (`parallel/`), ranks of torch.distributed started
   with `spawn`, each launching the kernel on its share of the lanes:
   `sharded_stochastic_solve_fused(select_best=True)` at the bench.py
   configuration on two gloo ranks sharing cuda:0 at meshes (2, 1) and
   (1, 2), eagerly (no graph holds a gloo collective). Per rank: the same
   finite winner inside the box and kernel launches = 3 x (SGA iterations
   + 1), counted from 0 just before the timed solve; prints each rank's
   lanes per launch and seconds per acquisition. On four or eight cards
   the same solve through its program on that many NCCL ranks at mesh
   (ranks, 1). Then the sharded programs
   on an NCCL group of one rank per card (one rank at mesh (1, 1) on one
   card, where the graphs hold the world all-reduces only; two at (2, 1)
   and (1, 2) where there are two cards): at the bench width the fused
   program (`program=`), the scanned one (windows of 10) and the batch
   one, each against the eager mesh route in the same process bit for
   bit with the same SGA iterations, launches 3 x (SGA iterations + 1)
   per rank (scanned: 3 x 11 per window) with the warm-up runs off, their
   captures, capture seconds and pool bytes, and the seconds per
   acquisition beside the single-device program's; `sharded_simulate_mc`
   at 4096 trajectories (h 3), the replay equal to the eager call, its
   trajectories/s beside the single-device graph's; the non-myopic loop
   at the CLI's widths on the mesh (budget 3) through `_cached_program`
   and in the eager loop, the same points and fallbacks bit for bit,
   every acquisition from the cache, the seconds per BO iteration of
   each; with two ranks also the worker problem against the blocked
   unsharded solve. Two ranks sharing one card give no scaling figure.
   Then a small float64
   non-myopic trial on a 2-rank mesh, card == CPU route to 1e-6 of the
   box; the float64 worker problem's fused solve on the two gloo ranks at
   (2, 1) and (1, 2) against one rank with no mesh, to 1e-12 when its
   simulate calls are split into the ranks' blocks, and unblocked (the
   difference printed: the dense products may round by batch size); and
   one trial through the CLI with `--nworkers 2 --backend gloo`
   at its widths (hartmann6d, h 2, 200 trajectories, 8 restarts, 16 + 2
   starts, MLE on, float64, budget 3: depth only): the CSVs, and per rank
   launches = 2 x sum(SGA iterations + 1) + fallbacks. With two or more
   cards also the multi-process worker's `--bench-mc` over NCCL;
11. the notebook-analog examples (`rollout_bo_tpu_torch/examples/`) at
   their default widths, each timed with its kernel launches and its own
   gates: derivs_ei (the EI derivative chain within 1e-5 of centered FD; no
   launch), fantasy_conditioning (rank-1 condition against a refit, CUDA
   events; the reset to 1e-12), laplace_approximation (100 x 100 episodes,
   float32, peak device memory), overview (15 launches: 1 per myopic BO
   iteration, the chunk's warm-up runs taken off), explanatory (21 points,
   64 trajectories, h 2: 3 simulate calls of h launches each; the same
   sweep on the CPU route in the same phase, the card's count of rows that
   agree with FD within 2 of the CPU route's) and rollout_bo (the explicit
   dual back-substitution within 1e-7 of autograd on an improving sample
   path with interior inner solves). Then each FD problem of
   tests/test_torch_fd.py (MC h 1 and 2, MC 2-D, the theta gradient,
   Gauss-Hermite, the ground-truth observable and the explicit adjoint on
   it) through the kernel in float64, at the JAX tests' eps and tolerances:
   the gradient and the JAX test's one centered difference, the gate, with
   its ratio; beside it the mean of 11 differences at points 1e-7 apart and
   the function's rounding floor (jitter), which on the MC 1-D problems (h
   1 and 2) must be within 3x the CPU route's, computed in the same phase;
12. the measurement entry points, each run as a user runs it (its own
   process, no arguments), each through its program (CUDA graphs) and,
   on an earlier line, eagerly: `bench_torch.py` (bench.py's protocol on
   `make_fused_sga_program(select_best=True)`: its last line has
   bench.py's four keys and metric name, a finite value, and launches =
   3 x (SGA iterations + 1) per acquisition),
   `scripts/throughput_torch.py` (trajectories/s per card at 4096 lanes, h
   3, with gradients, a graph of the call; 3 launches per call) and
   `scripts/profile_bench_torch.py` (5 replays of `make_batched_sga_step`
   under torch.profiler: ms per step, the device-busy share of the traced
   window, in (0, 1], and the top kernels by device time, the lane kernel
   among them). A non-zero exit of any of them fails the phase;
13. the SGA programs against the eager loop: bench.py's acquisition at
   its width, in float32 and in float64, eagerly and through
   `make_fused_sga_program(select_best=True)`, a warm-up of each (the
   program's capture) and then the median of 3 in turns, each on a new
   stream: the same SGA iterations, winner and value bit for bit (the two
   routes run the same kernels at the same shapes on one card), kernel
   launches 3 x (SGA iterations + 1) on both (on the program's first
   call besides the 3 x 2 x 3 of its graphs' warm-up runs), the capture
   seconds and the graphs' memory-pool bytes. Then non-myopic trials
   through the CLI at phase 6's widths, through the program cache and then
   in the eager loop (every program run eagerly): the fused solver (budget
   cut to 3), the batch solver (2) and the Gauss-Hermite one (1): one
   acquisition program captured for the trial (its two graphs once each)
   and one observe graph, the same points within 1e-9, the launch identity
   on both routes, the seconds per BO iteration of each. Then myopic
   trials (hartmann6d, budget 4, EI and Random) in chunks of 1 and of 4
   against the eager loop, bit for bit, one launch per EI iteration; and
   the observe program at the non-myopic width against the eager observe,
   bit for bit;
14. the regret-parity sweep (`scripts/parity_sweep_torch.py`), as its
   plan runs cells, each in a process of its own: the myopic cell sixhump
   / EI (budget 100, 64 starts, float64; 2 trials) and the ladder cell
   gramacylee / h 1 (budget 15, 200 QMC trajectories, 8 restarts, 8
   starts, 50 SGA iterations, MLE, 1 initial observation, float32; 1
   trial), then `scripts/parity_report_torch.py` on their output. Checks
   every CSV (header, sentinel, a row of finite numbers per trial; gaps in
   [0, 1], non-decreasing) and that each cell launched the lane kernel;
   prints per cell the seconds and launches per BO iteration (on the
   ladder cell the SGA iterations per acquisition they give) and the
   report's lines.

15. the MLE kernel (`csrc/gp_mle.cu`, built here with nvcc; its ptxas
   registers and shared memory printed) against its plain version
   (`gp_mle_ref`) on the card, at the cells' shapes (capacity 20 with n 5
   and 19, capacity 105 with n 5, 55 and 105, hartmann6d) and above the
   shared memory (capacity 160 in float64, 240 in float32: the scratch
   buffer), in float64 (noise 1e-6, rtol 1e-12) and float32 (noise 1e-3,
   rtol 1e-5), and every kernel kind at n 12 of capacity 20 (1e-10); its us per
   launch (CUDA events) beside its bound (`gp_mle.mle_work`) and, as a
   yardstick only, the autograd loop the port ran before it (60 steps of
   autograd through the masked Cholesky); then a myopic trial (hartmann6d,
   budget 10) whose programs are cached: one `gp_mle` launch per refit in
   its record (`mle_launches`).

`--phases 3 11` runs only the phases named (1 and 2 always run); a partial
run prints neither of the two closing lines.

It prints one JSON line describing the kernel (launches on the main path;
max |v_kernel - v_plain| over the bench-shape lanes; the kernel's and the
plain version's ms per call at the bench shape; `bound_ms`, the least time
the card could take for that call, from `lane_solve_work`), then, as the
last line,
{"ok": true, "device": {...}}. Any failure raises before those lines and
exits non-zero; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (a): value vs re-evaluation; (b): never worse than the plain solver
_TOL = {torch.float32: dict(rtol=2e-3, atol=1e-5, worse=5e-4),
        torch.float64: dict(rtol=1e-6, atol=1e-9, worse=1e-6)}
_LOG_ATOL = {torch.float32: 2e-3, torch.float64: 1e-6}
# phases 4 and 12 before the float32 kernel stopped a start at its fixed
# point, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
_RECORDED = {
    "bench": "0.0334 s per replayed acquisition",
    "throughput": "141,831 trajectories/s/card, the lane kernel 4.705, 4.759, 5.349 ms per "
                  "launch"}
# H100 SXM peaks: bytes/s of HBM3; FLOP/s outside the tensor cores (float64
# at half the float32 rate)
_PEAK_BYTES = 3.35e12
_PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi[0])
    return name, smi[0]


def phase_build():
    from rollout_bo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("newton_lanes")
    seconds = time.perf_counter() - t0
    built = _build.build_seconds("newton_lanes")
    print(f"build: newton_lanes.cu loaded in {seconds:.2f} s "
          f"({'nvcc ' + format(built, '.2f') + ' s' if built is not None else 'cached'})")
    inst = ()
    for line in _build.build_log("newton_lanes").splitlines():
        if "Compiling entry" in line:
            li = re.search(r"newton_li_kernel_d(\d+)ILb(\d)E", line)
            if li:
                inst = (f"float64, Li form, factor unrolled to {li[1]}",
                        "Li staged" if li[2] == "1" else "Li in device memory")
            elif "newton_lanes_kernel" in line:
                inst = ("float32, W form",
                        "W staged" if "Lb1E" in line else "W in device memory")
            else:
                inst = ("best start over the start blocks",
                        "float32" if "IfE" in line else "float64")
        if "registers" in line or "spill" in line:
            print(f"  ptxas ({', '.join(inst)}):", line.strip())
    lay = kernel_layout(torch.empty((1600, 24, 10), dtype=torch.float32, device="cuda"), 10)
    print(f"  bench shape (cap 24, d 10, S 10, float32): blocks of {lay['lanes_per_block']} "
          f"lane x {lay['groups_per_lane']} warps = {lay['threads']} threads, "
          f"{lay['shared_bytes']} B of shared memory, {lay['blocks_per_sm']} blocks "
          f"({lay['warps_per_sm']} warps) resident per SM")
    return seconds


def kernel_layout(X, S):
    """The lane kernel's blocks for lanes shaped like X and S starts on this
    card: blocks in the launch, their threads, lanes, groups (of 32
    threads) and start blocks, the lane block's slots (0: a warp per
    start), shared bytes, cluster size (no clusters: 1) and what an SM
    holds (`newton_lanes_blocks_per_sm`)."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    L, cap, d = X.shape
    lay = nl._block_shape(cap, d, S, X.element_size(), L, sms=nl._sm_count(X.device.index))
    per_sm = nl._library().newton_lanes_blocks_per_sm(X.element_size(), d, int(lay.stage_m),
                                                      lay.slots, lay.threads, lay.smem)
    return dict(blocks=-(-L // lay.lanes) * lay.start_blocks, threads=lay.threads,
                lanes_per_block=lay.lanes, groups_per_lane=lay.groups,
                start_blocks=lay.start_blocks, slots=lay.slots, shared_bytes=lay.smem, cluster=1,
                stage_m=lay.stage_m, blocks_per_sm=per_sm,
                warps_per_sm=per_sm * -(-lay.threads // 32))


# --------------------------------------------------------------------------
# phase 3: kernel vs plain version
# --------------------------------------------------------------------------


def _lane_state(sizes, d, cap, kind, theta, lbs, ubs, dtype, dev, seed, f=None):
    """A stacked state of sum(counts) lanes; `sizes` maps an active count to
    a number of lanes with that count."""
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    kern = K.RBFKernel(torch.tensor(theta, dtype=dtype, device=dev), kind)
    parts = []
    for n, count in sizes.items():
        X = rng.uniform(lbs, ubs, (count, n, d))
        y = f(torch.tensor(X, dtype=torch.float64)).numpy() if f is not None else \
            np.sin(2.0 * X.sum(axis=-1)) + 0.2 * rng.standard_normal((count, n))
        parts.append(sg.fit(kern, X, y, capacity=cap, noise=1e-5 if f else 1e-4,
                            device=dev, dtype=dtype))
    cat = {fld: torch.cat([getattr(p, fld) for p in parts])
           for fld in ("X", "y", "L", "c", "n", "Li")}
    return sg.SurrogateState(kern, noise=parts[0].noise, **cat)


def _events_ms(fn, reps):
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def _as_f64(st):
    """The same lanes' state in float64, cast."""
    from rollout_bo_tpu_torch.ops import kernels as K

    cast = lambda a: a.double() if torch.is_tensor(a) and a.is_floating_point() else a
    return st._replace(kernel=K.RBFKernel(st.kernel.theta.double(), st.kernel.kind),
                       **{f: cast(getattr(st, f)) for f in ("X", "y", "L", "c", "noise", "Li")})


def _plain64(args, kw):
    """The plain version in float64 on the lanes' own problem: the matrix the
    lanes' dtype reads (`newton_lanes._lane_matrix`: float32 lanes' W =
    Li^T Li as formed in float32), cast to float64, not formed anew from
    Li in float64, whose rounding would pose another problem."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    cast = lambda a: a.double() if torch.is_tensor(a) and a.is_floating_point() else a
    M, li = nl._lane_matrix(args[1])
    return nl._solve_plain(cast(args[0]), cast(M), li, *map(cast, args[2:]), **kw)


def _compare(st, rule, th, lbs, ubs, xstarts, iterations, label, timing=False,
             a_as_plain=False):
    """Kernel vs plain version on the same CUDA lanes; returns the stats
    (with `timing`, also both times and the kernel's work and bound).
    `a_as_plain` holds criterion (a) to the plain version's own misses: no
    more lanes may miss it than miss it there (lanes whose K is too
    ill-conditioned for the float32 W form on either route)."""
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    dt = st.X.dtype
    kth = st.kernel.theta
    period = kth[1] if st.kernel.kind == "periodic" else torch.ones_like(kth[0])
    fmini = sg.get_active_minimum(st)
    th0 = th[..., 0].contiguous()
    args = (st.X, st.Li, st.c, st.n, fmini, th0, kth[0], lbs, ubs, xstarts, period)
    kw = dict(kind=st.kernel.kind, rule=rule.name, iterations=iterations,
              f_tol=rule.solve_f_tol, x_tol=rule.solve_x_tol)
    kernel = lambda: nl.newton_solve_lanes(*args, **kw)
    plain = lambda: nl.newton_solve_lanes_ref(*args, **kw)
    if timing:
        x0, v0 = kernel()                       # warm up both
        plain()
        torch.cuda.synchronize()
        ms, (xk, vk) = _events_ms(kernel, 5)
        plain_ms, (xr, vr) = _events_ms(plain, 2)
    else:
        (x0, v0), (xk, vk), (xr, vr) = kernel(), kernel(), plain()
        ms = plain_ms = float("nan")
    torch.cuda.synchronize()
    repeats = torch.equal(x0, xk) and torch.equal(v0, vk)
    # the iterations the starts ran: the kernel stops a start at a fixed
    # point, and the bound counts the work these lanes need
    runs = nl._iterations_run(*args, **kw) if timing else None
    assert xk.shape == xr.shape and vk.shape == vr.shape and xk.dtype == dt
    vk_cross = sg.acquisition(st, rule, xk, th)
    vr_cross = sg.acquisition(st, rule, xr, th)
    torch.cuda.synchronize()
    tol = _TOL[dt]
    atol = _LOG_ATOL[dt] if rule.name.startswith("Log") else tol["atol"]
    scale = torch.clamp(vr_cross.abs(), min=1.0)
    err = (vk - vk_cross).abs()
    # kernel against plain version, same inputs (equal infinities count as 0)
    vs_plain = torch.where(vk == vr, 0.0, (vk - vr).abs())
    a_missed = int((err > tol["rtol"] * vk_cross.abs() + atol * scale).sum())
    a_missed_plain = int(((vr - vr_cross).abs() > tol["rtol"] * vr_cross.abs()
                          + atol * scale).sum())
    ok_a = a_missed <= a_missed_plain if a_as_plain else a_missed == 0
    # the loose freeze stops both at the same iteration only up to rounding
    # near its threshold: hold it to the acceptance tolerance itself, as
    # tests/test_pallas_newton.py::test_pallas_loose_freeze_f32_matches_xla does
    slack = (rule.solve_f_tol * (vr_cross.abs() + 1.0) if rule.solve_f_tol > 0
             else tol["worse"] * scale + 1e-6)
    width = float(torch.max(ubs - lbs))
    miss = vk_cross < vr_cross - slack
    far = (xk - xr).abs().amax(dim=-1) > 1e-3 * width
    agree = 1.0 - float(far.double().mean())
    void = sided = 0
    if dt == torch.float32 and bool(torch.any(miss | far)):
        # the plain version in float64 on the same inputs arbitrates
        st64 = _as_f64(st)
        x64, _ = _plain64(args, kw)
        value = lambda x: sg.acquisition(st64, rule, x.double(), th.double())
        undetermined = (value(xr) - value(x64)).abs() > slack
        with64 = (xk.double() - x64).abs().amax(dim=-1) <= 1e-3 * width
        void, sided = int((miss & undetermined).sum()), int((far & with64).sum())
        miss, far = miss & ~undetermined, far & ~with64
    ok_b = not bool(torch.any(miss))
    starts = torch.maximum(torch.minimum(xstarts, ubs), lbs)
    stayed = (xk[:, None, :] - starts[None]).abs().amax(dim=-1).amin(dim=-1) <= 1e-6 * width
    moved = float((~stayed).double().mean())
    if not (ok_a and ok_b):
        i = int(torch.argmax(err))
        raise AssertionError(
            f"{label}: kernel disagrees with the plain version "
            f"(a: {ok_a}, {a_missed} lanes miss it (plain version: {a_missed_plain}), "
            f"max |v - acq(x)| = {float(err.max()):.3e} at lane {i}: "
            f"{float(vk[i])} vs {float(vk_cross[i])}; b: {ok_b}, min kernel - plain = "
            f"{float((vk_cross - vr_cross).min()):.3e})")
    return dict(max_abs_err=float(vs_plain.max()), max_err_reeval=float(err.max()),
                a_missed=a_missed, a_missed_plain=a_missed_plain, agree=agree,
                apart=int(far.sum()), sided=sided, void=void, moved=moved,
                ms=ms, plain_ms=plain_ms, repeats=repeats,
                runs=None if runs is None else float(runs.double().mean()),
                **lane_bound(st.n.tolist(), st.X.shape[1], st.X.shape[2], xstarts.shape[0],
                             iterations, dt, runs))


def lane_bound(n, cap, d, S, iterations, dtype, runs=None):
    """The least time the card could take for one `newton_solve_lanes` call
    on lanes of active counts n: the larger of its operations over the peak
    rate of `dtype` and its bytes over the memory rate (`lane_solve_work`;
    `runs`, the iterations each start needs, where measured). Returns
    dict(flops, bytes, bound_ms, bound_by)."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    itemsize = torch.tensor([], dtype=dtype).element_size()
    flops, nbytes = nl.lane_solve_work(n, cap, d, S, iterations, itemsize,
                                       None if runs is None else runs.cpu())
    bound_ops, bound_bytes = flops / _PEAK_FLOPS[dtype] * 1e3, nbytes / _PEAK_BYTES * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes else "bytes")


def _work_line(r, card):
    ran = ("" if r.get("runs") is None
           else f" (the starts ran {r['runs']:.2f} iterations on average)")
    return (f"  work {r['flops'] / 1e9:.3f} GFLOP{ran}, {r['bytes']} B; "
            f"bound {r['bound_ms']:.4f} ms "
            f"(by {r['bound_by']}); kernel {r['ms']:.3f} ms, {r['bound_ms'] / r['ms']:.4f} of "
            f"the bound reached; plain {r['plain_ms']:.3f} ms; on {card}")


def phase_kernel_checks(dev, card):
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc

    # the bench shape: lanes as the main path's three fantasy steps see them
    # (12 trid10d observations + 1..3 fantasies in a capacity-24 buffer)
    f = testfns.get_function("trid10d")
    t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    st = _lane_state({13: 534, 14: 533, 15: 533}, f.dim, 24, "matern52", (1.0,),
                     f.lbs, f.ubs, torch.float32, dev, 7, f=f)
    lbs, ubs = t32(f.lbs), t32(f.ubs)
    xstarts = t32(qmc.generate_initial_guesses(8, f.lbs, f.ubs))
    th = torch.zeros((st.X.shape[0], 1), dtype=torch.float32, device=dev)
    bench = _compare(st, dr.EI(), th, lbs, ubs, xstarts, 10, "bench shape", timing=True)
    print(f"kernel vs plain, bench shape (1600 lanes, cap 24, d 10, S 10, matern52/EI, "
          f"f32): kernel {bench['ms']:.3f} ms, plain {bench['plain_ms']:.3f} ms, "
          f"argmax agreement {bench['agree']:.4f}, "
          f"max |v_kernel - v_plain| {bench['max_abs_err']:.3e}, "
          f"max |v - acq(x)| {bench['max_err_reeval']:.3e}, "
          f"lanes that left their start {bench['moved']:.4f} "
          f"(criteria: (a) |v - acq(x)| <= 2e-3 |acq(x)| + 1e-5 max(1, |acq|); "
          f"(b) acq(x_kernel) >= acq(x_plain) - 5e-4 max(1, |acq|) - 1e-6)")
    print(_work_line(bench, card))
    print(f"  {_layout_line(kernel_layout(st.X, xstarts.shape[0]))}")
    # every backtracking candidate ties on these lanes: the tie rule's check
    if bench["max_abs_err"] != 0.0 or bench["agree"] != 1.0:
        raise AssertionError(f"bench lanes: max |v_kernel - v_plain| {bench['max_abs_err']} "
                             f"!= 0 or argmax agreement {bench['agree']} != 1")

    # the bench's lanes sit on EI plateaus (lengthscale 1 in a box of width
    # 200), so check the same shape on lanes whose Newton steps move, and
    # the largest supported d
    for d, lanes, dts in ((10, {13: 534, 14: 533, 15: 533}, (torch.float32,)),
                          (nl.MAX_D, {9: 32, 15: 32}, (torch.float32, torch.float64))):
        lo, hi = np.full(d, -1.0), np.full(d, 1.0)
        for dt in dts:
            t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
            st = _lane_state(lanes, d, 24, "matern52", (0.8,), lo, hi, dt, dev, 5)
            th = torch.zeros((st.X.shape[0], 1), dtype=dt, device=dev)
            r = _compare(st, dr.EI(), th, t(lo), t(hi),
                         t(qmc.generate_initial_guesses(8, lo, hi)), 10, f"d={d} {dt}",
                         timing=True)
            if d == 10:
                # the reported error covers both sets of lanes at the bench shape
                bench["max_abs_err"] = max(bench["max_abs_err"], r["max_abs_err"])
            print(f"kernel vs plain, {st.X.shape[0]} lanes, cap 24, d {d}, S 10, "
                  f"matern52/EI, {dt}: argmax agreement {r['agree']:.4f}, "
                  f"max |v_kernel - v_plain| {r['max_abs_err']:.3e}, max |v - acq(x)| "
                  f"{r['max_err_reeval']:.3e}, lanes that left their start {r['moved']:.4f}")
            print(_work_line(r, card))
            print(f"  lanes that end elsewhere than the plain version: {r['sided']} with its "
                  f"float64 run, {r['apart']} with neither; lanes void for (b): {r['void']}")
            if r["apart"]:
                raise AssertionError(f"d={d} {dt}: {r['apart']} lanes end neither where the "
                                     f"plain version does nor where its float64 run does")

    # small shapes: every kind x rule, per-lane n, both dtypes
    d, cap = 3, 12
    lo, hi = np.full(d, -1.0), np.full(d, 1.0)
    n_small = n_void = 0
    for dt in (torch.float32, torch.float64):
        t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
        xs = t(qmc.generate_initial_guesses(6, lo, hi))
        for kind in nl.SUPPORTED_KINDS:
            theta = (0.9, 3.0) if kind == "periodic" else (0.8,)
            st = _lane_state({3: 16, 6: 16, 9: 16, 12: 16}, d, cap, kind, theta,
                             lo, hi, dt, dev, 11)
            for name in nl.SUPPORTED_RULES:
                th = torch.full((64, 1), 0.5 if name == "LCB" else 0.0, dtype=dt,
                                device=dev)
                # POI's default is the loose freeze; run every rule exact too
                rules = [dr.DecisionRule(name)]
                if name == "POI":
                    rules.append(dr.POI())
                for rule in rules:
                    r = _compare(st, rule, th, t(lo), t(hi), xs, 8,
                                 f"{kind}/{name}/{dt} loose={rule.solve_f_tol > 0}")
                    n_small += 1
                    n_void += r["void"]
    print(f"kernel vs plain, small shapes: {n_small} kind x rule x dtype cases "
          f"(per-lane n in 3..12, loose POI in f32 and f64) passed; float32 lanes void "
          f"for (b): {n_void}")

    for label, void in _edge_cases(dev):
        print(f"kernel vs plain, edge of the block layout: {label} passed; lanes void "
              f"for (b): {void}")

    for dt in (torch.float64, torch.float32):
        print(f"kernel vs plain, {_cross_block_tie(dev, dt)} passed")

    # the regret ladder's float32 shapes (8 restarts x 200 or 250
    # trajectories, n 1..16 of capacity 20, 8 + 2 starts, 12 iterations) and
    # the myopic loop's shape at --dtype float32 (hartmann6d), over 66 start
    # blocks. Criteria (a) and (b) hold them (in _compare) and two launches
    # must agree bit for bit. gramacylee runs at lengthscale 0.15 and 0.05:
    # at 0.15 its 16 random points in [0.5, 2.5] leave K, on a few lanes in a
    # thousand, too ill-conditioned for the float32 W form, and the plain
    # version misses (a) there too (so does the parent kernel, whose values
    # these are bit for bit: scripts/ab_newton_lanes_cuda.py --old-source),
    # so there no more lanes may miss (a) than miss it in the plain version.
    # Where the lanes end is printed, not held: on the ladder's 1-D lanes
    # float32 rounding picks between near-equal local maxima.
    t32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    gram = {1: 400, 4: 400, 8: 400, 12: 400, 16: 400}
    for fname, label, sizes, cap, starts, ell in (
            ("ackley2d", "ladder, ackley2d (1600 lanes, n 4..16 of capacity 20, S 10)",
             {4: 400, 8: 400, 12: 400, 16: 400}, 20, 8, 0.6),
            ("gramacylee", "ladder, gramacylee (2000 lanes, n 1..16 of capacity 20, S 10, "
             "lengthscale 0.15)", gram, 20, 8, 0.15),
            ("gramacylee", "ladder, gramacylee (2000 lanes, n 1..16 of capacity 20, S 10, "
             "lengthscale 0.05)", gram, 20, 8, 0.05),
            ("hartmann6d", "myopic loop in float32 (1 lane, n 104 of capacity 105, S 66)",
             {104: 1}, 105, 64, 0.6)):
        f = testfns.get_function(fname)
        st = _lane_state(sizes, f.dim, cap, "matern52", (ell,), f.lbs, f.ubs, torch.float32,
                         dev, 17 if fname == "hartmann6d" else 23, f=f)
        th = torch.zeros((st.X.shape[0], 1), dtype=torch.float32, device=dev)
        xs = t32(qmc.generate_initial_guesses(starts, f.lbs, f.ubs))
        lay = kernel_layout(st.X, xs.shape[0])
        r = _compare(st, dr.EI(), th, t32(f.lbs), t32(f.ubs), xs, 12, label, timing=True,
                     a_as_plain=ell == 0.15)
        print(f"kernel vs plain, {label}, d {f.dim}, matern52/EI, float32: argmax agreement "
              f"{r['agree']:.4f}, max |v_kernel - v_plain| {r['max_abs_err']:.3e}, max "
              f"|v - acq(x)| {r['max_err_reeval']:.3e}, lanes missing (a) {r['a_missed']} "
              f"(plain version: {r['a_missed_plain']}), lanes that left their start "
              f"{r['moved']:.4f}, two launches bit for bit {r['repeats']}; lanes that end "
              f"elsewhere than the plain version: {r['sided']} with its float64 run, "
              f"{r['apart']} with neither; lanes void for (b): {r['void']}")
        print(_work_line(r, card))
        print(f"  {_layout_line(lay)}")
        if not r["repeats"]:
            raise AssertionError(f"{label}: two launches on the same inputs differ")

    # the shapes the BO loops give the kernel (phases 5 and 6): hartmann6d in
    # float64, the solver's default 12 iterations
    f = testfns.get_function("hartmann6d")
    t64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)
    for key, label, sizes, cap, starts in (
            ("myopic", "myopic loop (1 lane, n 104 of capacity 105, S 66)", {104: 1}, 105, 64),
            ("non-myopic", "non-myopic loop (2000 lanes, n 6..21 of capacity 23, S 18)",
             {6: 500, 12: 500, 17: 500, 21: 500}, 23, 16)):
        st = _lane_state(sizes, f.dim, cap, "matern52", (0.6,), f.lbs, f.ubs,
                         torch.float64, dev, 17, f=f)
        th = torch.zeros((st.X.shape[0], 1), dtype=torch.float64, device=dev)
        xs = t64(qmc.generate_initial_guesses(starts, f.lbs, f.ubs))
        lay = kernel_layout(st.X, xs.shape[0])
        r = _compare(st, dr.EI(), th, t64(f.lbs), t64(f.ubs), xs, 12, label, timing=True)
        print(f"kernel vs plain, {label}, d 6, matern52/EI, float64: {lay['blocks']} blocks "
              f"of {lay['lanes_per_block']} lane x {lay['groups_per_lane']} warps, "
              f"{lay['start_blocks']} start blocks per lane, cluster "
              f"size {lay['cluster']}, Li {'staged' if lay['stage_m'] else 'in device memory'}, "
              f"{lay['shared_bytes']} B of shared memory, {lay['blocks_per_sm']} blocks "
              f"({lay['warps_per_sm']} warps) resident per SM; argmax agreement "
              f"{r['agree']:.4f}, max |v_kernel - v_plain| {r['max_abs_err']:.3e}, max "
              f"|v - acq(x)| {r['max_err_reeval']:.3e}, lanes that left their start "
              f"{r['moved']:.4f}, two launches bit for bit {r['repeats']}")
        print(_work_line(r, card))
        if r["agree"] != 1.0:
            raise AssertionError(f"{label}: argmax agreement {r['agree']} != 1 in float64")
        if not r["repeats"]:
            raise AssertionError(f"{label}: two launches on the same inputs differ")
        KERNEL_MS[key] = r["ms"]
    return bench


# the lane kernel's ms at the BO loops' shapes (phase 3), beside phases 5 and 6
KERNEL_MS = {}


def _layout_line(lay):
    return (f"layout: {lay['blocks']} blocks of {lay['lanes_per_block']} lane(s) x "
            f"{lay['groups_per_lane']} warps ({lay['threads']} threads), "
            f"{lay['start_blocks']} start block(s) per lane, "
            + (f"lane block of {lay['slots']} starts a pass, " if lay['slots'] else "")
            + f"{'W' if lay['stage_m'] else 'no lane matrix'} staged, {lay['shared_bytes']} B "
            f"of shared memory, {lay['blocks_per_sm']} blocks ({lay['warps_per_sm']} warps) "
            f"resident per SM")


def _kernel_ms(key):
    ms = KERNEL_MS.get(key)
    return "not measured in this run (phase 3)" if ms is None else f"{ms:.3f} ms (phase 3)"


def _cross_block_tie(dev, dt=torch.float64):
    """One lane, 66 starts, one per block (the construction of
    tests/test_torch_kernel_emulation.py), in the lanes' dtype `dt` (the
    double kernel, or the float one): four data points in a corner at
    lengthscale 0.001; starts 0-23 on them, starts 24-65 where every k(x,
    X_j) underflows to 0, so that their EI values tie exactly and none
    moves. Start 24 must win across the blocks, as in the plain version;
    criteria (a) and (b) hold; the value is the plain version's up to the
    normal CDF's rounding on each route (1e-12 relative in float64, 1e-6 in
    float32). Returns the label."""
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.ops import kernels as K
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc

    d = 2
    X = np.array([[-0.9, -0.9], [-0.9, -0.8], [-0.8, -0.9], [-0.8, -0.8]])
    kern = K.RBFKernel(torch.tensor([0.001], dtype=dt, device=dev), "matern52")
    st = sg.fit(kern, X[None], np.array([[1.0, 1.5, 2.0, 2.5]]), capacity=8, noise=1e-4,
                device=dev, dtype=dt)
    st = st._replace(Li=st.Li.contiguous())
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    hi = np.ones(d)
    xs = t(np.concatenate([np.repeat(X, 6, axis=0),
                           qmc.generate_initial_guesses(40, np.zeros(d), hi)]))
    th = torch.zeros((1, 1), dtype=dt, device=dev)
    lay = kernel_layout(st.X, xs.shape[0])
    label = (f"cross-block tie ({str(dt).split('.')[1]}, 1 lane, 66 starts in "
             f"{lay['start_blocks']} start blocks, starts 24-65 tied)")
    _compare(st, dr.EI(), th, t(-hi), t(hi), xs, 5, label)
    args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), th[:, 0].contiguous(),
            kern.theta[0], t(-hi), t(hi), xs, 1.0)
    kw = dict(kind="matern52", rule="EI", iterations=5)
    (xk, vk), (xr, vr) = (nl.newton_solve_lanes(*args, **kw),
                          nl.newton_solve_lanes_ref(*args, **kw))
    torch.cuda.synchronize()
    if not (torch.equal(xk[0], xs[24]) and torch.equal(xr[0], xs[24])):
        raise AssertionError(f"{label}: x {xk[0].tolist()} (plain {xr[0].tolist()}), "
                             f"not start 24 {xs[24].tolist()}")
    if abs(float(vk[0]) - float(vr[0])) > (1e-12 if dt == torch.float64 else 1e-6) * abs(
            float(vr[0])):
        raise AssertionError(f"{label}: value {float(vk[0])} vs plain {float(vr[0])}")
    return label


def _edge_cases(dev):
    """Shapes at the edges of the kernel's block layout, each held to the
    criteria (a) and (b); yields a label and the lanes void for (b) per case."""
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(3)
    # (label, lanes by active count, d, capacity, starts, dtype, lanes emptied)
    cases = [("1 start (8 lanes per block)", {5: 20, 9: 21}, 3, 12, 1, f64, 0),
             ("40 starts (3 starts per warp)", {5: 8, 9: 9}, 3, 12, 40, f64, 0),
             ("7 lanes of 1 start (a block not filled)", {6: 7}, 2, 8, 1, f32, 0),
             ("1601 lanes (a last block of one lane)", {4: 800, 7: 801}, 2, 8, 2, f32, 0),
             ("lanes with n = 0 and n = capacity", {12: 12}, 3, 12, 6, f64, 4),
             ("capacity 64, d 16, float64 (shared memory: "
              f"{nl._block_shape(64, 16, 6, 8)[3]} B)", {40: 4, 64: 4}, 16, 64, 6, f64, 0)]
    for label, sizes, d, cap, S, dt, emptied in cases:
        t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
        lo, hi = np.full(d, -1.0), np.full(d, 1.0)
        st = _lane_state(sizes, d, cap, "matern52", (0.8,), lo, hi, dt, dev, 13)
        rule, theta = dr.EI(), 0.0
        if emptied:
            # LCB does not read the incumbent, which a lane without data lacks
            n = st.n.clone()
            n[:emptied] = 0
            st, rule, theta = st._replace(n=n), dr.DecisionRule("LCB"), 0.5
        xs = t(qmc.generate_initial_guesses(S - 2, lo, hi)) if S > 2 else \
            t(rng.uniform(lo, hi, (S, d)))
        th = torch.full((st.X.shape[0], 1), theta, dtype=dt, device=dev)
        r = _compare(st, rule, th, t(lo), t(hi), xs, 6, label)
        yield label, r["void"]


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def phase_main_path(dev, card):
    import bench_torch
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout.outer import make_fused_sga_program, stochastic_solve_fused
    from rollout_bo_tpu_torch.utils import graphs

    problem = bench_torch.bench_problem(dev, torch.float32)
    state, tp, xstarts, restarts = problem
    program = bench_torch.fused_program(state, tp, xstarts)
    acquire = lambda: bench_torch.acquire(*problem, program=program)

    torch.cuda.synchronize()
    nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
    t0 = time.perf_counter()
    res = acquire()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # the first call captures: the warm-up runs of its two graphs (3 launches
    # each) launch the kernel besides the replays
    launches, warm = nl.LAUNCHES, graphs.WARMUP_LAUNCHES - warm0
    if warm != graphs.WARMUP * 2 * 3 or launches - warm != 3 * (res.iterations + 1):
        raise AssertionError(f"kernel launches {launches} != {graphs.WARMUP} x 2 x 3 warm-up "
                             f"+ 3 x ({res.iterations} + 1)")
    if sum(g.captures for g in program.graphs) != 2:
        raise AssertionError("the fused program did not capture its two graphs once each")
    x, v = res.x, res.value
    if x.shape != (10,) or not bool(torch.all(torch.isfinite(x))) or not math.isfinite(float(v)):
        raise AssertionError(f"bad acquisition result x={x} v={v}")
    if not (bool(torch.all((x >= tp.lbs) & (x <= tp.ubs))) and float(v) >= 0.0):
        raise AssertionError(f"winner outside the box or negative value: x={x} v={v}")
    print(f"main path: bench.py configuration through make_fused_sga_program(select_best="
          f"True), {res.iterations} SGA iterations, {launches} kernel launches ({warm} in "
          f"the warm-up runs before the capture, {launches - warm} replayed), v_best "
          f"{float(v):.6g}, first call {first_s:.3f} s (the capture of its two graphs "
          f"{sum(g.capture_seconds for g in program.graphs):.3f} s of it)")

    times, replayed = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        nl.LAUNCHES = 0
        t0 = time.perf_counter()
        r = acquire()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if nl.LAUNCHES != 3 * (r.iterations + 1):
            raise AssertionError(f"a call after the capture: kernel launches {nl.LAUNCHES} "
                                 f"!= 3 x ({r.iterations} + 1)")
        replayed.append(nl.LAUNCHES)
    median = statistics.median(times)
    print(f"main path: median {median:.4f} s per acquisition over 2 runs "
          f"({', '.join(f'{s:.4f}' for s in times)}), kernel launches {replayed} = 3 x "
          f"(SGA iterations + 1); on {card} (before the float32 kernel's fixed-point stop: "
          f"{_RECORDED['bench']})")

    # a small float64 run of the same path: the card (kernel, graphs) against
    # the CPU route (plain solver, eager program), which the CPU tests hold
    # to the JAX package
    def small(device):
        st, tps, rule, xs, rs = _setup_small(device)
        kw = dict(max_iters=5, lr=0.05, inner_iterations=6, select_best=True)
        prog = make_fused_sga_program(st, tps, rule, xs, **kw)
        return stochastic_solve_fused(st, tps, rule, xs, rs, program=prog, **kw)

    gpu, cpu = small(dev), small(torch.device("cpu"))
    torch.cuda.synchronize()
    if gpu.iterations != cpu.iterations or not torch.allclose(
            gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-6) or not math.isclose(
            float(gpu.value), float(cpu.value), rel_tol=1e-6):
        raise AssertionError(f"small f64 main path: card {gpu} vs CPU route {cpu}")
    print(f"main path, small float64 (trid2d, h 2, M 8, 4 restarts): card == CPU route "
          f"(x_best {gpu.x.cpu().numpy()}, v_best {float(gpu.value):.10g}, "
          f"{gpu.iterations} iterations)")
    return launches, median


def _setup_small(dev):
    from bench_torch import bench_problem
    from rollout_bo_tpu_torch.models.decision_rules import EI

    state, tp, xstarts, rs = bench_problem(dev, torch.float64, name="trid2d", n_obs=6,
                                           capacity=10, mc=8, horizon=2, starts=4,
                                           restarts=4)
    return state, tp, EI(), xstarts, rs


# --------------------------------------------------------------------------
# phases 5-7: the BO loops through the experiment CLIs
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _recording():
    """Records what the CLIs do not return: each trial's result with its
    wall seconds and the kernel-launch count at its end, and per
    lane-solver call the share of lanes whose argmax is at none of its
    start points. The launch counts leave out the launches of the graphs'
    warm-up runs before a capture (`warmup`, counted since the recording
    began): they are the launches whose results the loop used, which the
    phases hold to the SGA iterations. A graph's replay runs no Python, so
    on the program route the solver-call share is that of the warm-up runs
    and of the solves outside the graphs; `solver_calls` says how many. For
    the same reason it times no refit (the refit runs inside the observe
    program's replays): the refit ms that the phases print come from
    `_observe_routes`, timed apart from the trials."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout import bo, solvers
    from rollout_bo_tpu_torch.utils import graphs

    rec = dict(trials=[], moved=[], acquisitions=[])
    hot = solvers.maximize_hot
    acquire = bo._acquire_or_fall_back
    loops = {name: getattr(bo, name)
             for name in ("run_myopic_bo", "run_nonmyopic_bo", "run_adaptive_bo")}

    def maximize_hot(state, rule, theta, lbs, ubs, xstarts, **kw):
        x, v = hot(state, rule, theta, lbs, ubs, xstarts, **kw)
        if torch.cuda.is_current_stream_capturing():
            return x, v                  # a graph's capture computes nothing
        starts = torch.maximum(torch.minimum(xstarts, ubs), lbs)
        away = (x[..., None, :] - starts).abs().amax(dim=-1).amin(dim=-1)
        rec["moved"].append((away > 1e-6 * torch.max(ubs - lbs)).double().mean())
        return x, v

    def acquire_or_fall_back(acq, fallback, state, rnstream, restarts, h):
        before, warm = nl.LAUNCHES, graphs.WARMUP_LAUNCHES
        out = acquire(acq, fallback, state, rnstream, restarts, h)
        warm = graphs.WARMUP_LAUNCHES - warm
        rec["acquisitions"].append(dict(h=h, iterations=int(out[1]), fallback=bool(out[2]),
                                        launches=nl.LAUNCHES - before - warm, warmup=warm))
        return out

    warm0 = graphs.WARMUP_LAUNCHES

    def timed(loop):
        def run(*args, **kw):
            t0 = time.perf_counter()
            res = loop(*args, **kw)
            warm = graphs.WARMUP_LAUNCHES - warm0
            rec["trials"].append(dict(
                res=res, seconds=time.perf_counter() - t0, launches=nl.LAUNCHES - warm,
                warmup=warm, solver_calls=len(rec["moved"]),
                moved=torch.stack(rec["moved"]).cpu().numpy()
                if rec["moved"] else np.zeros(0), acquisitions=rec["acquisitions"][:]))
            for key in ("moved", "acquisitions"):
                rec[key].clear()
            return res
        return run

    solvers.maximize_hot = maximize_hot
    bo._acquire_or_fall_back = acquire_or_fall_back
    for name, loop in loops.items():
        setattr(bo, name, timed(loop))
    try:
        yield rec
    finally:
        solvers.maximize_hot = hot
        bo._acquire_or_fall_back = acquire
        for name, loop in loops.items():
            setattr(bo, name, loop)


@contextlib.contextmanager
def _eager_loops():
    """The BO loops in the eager loop: the acquisitions through
    `_rollout_acquirer` with no program key, and every program (observe,
    fallback, myopic iteration) calling its function eagerly
    (`GraphProgram.__call__` patched): the route that the programs are held
    to."""
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    acquirer, call = bo._rollout_acquirer, graphs.GraphProgram.__call__
    bo._rollout_acquirer = lambda *a, **kw: acquirer(*a, **dict(kw, program_key=None))
    graphs.GraphProgram.__call__ = lambda self, *a: self.fn(*a)
    try:
        yield
    finally:
        bo._rollout_acquirer = acquirer
        graphs.GraphProgram.__call__ = call


@contextlib.contextmanager
def _asked_programs():
    """The keys the BO loops ask `bo._cached_program` for inside the block,
    in order: the programs a trial took, whether it built them or found
    them cached."""
    from rollout_bo_tpu_torch.rollout import bo

    asked, cached_program = [], bo._cached_program

    def asking(key, builder):
        asked.append(key)
        return cached_program(key, builder)

    bo._cached_program = asking
    try:
        yield asked
    finally:
        bo._cached_program = cached_program


def _taken(asked, name):
    """The cached programs under the keys in `asked` named `name`, once each."""
    from rollout_bo_tpu_torch.utils import graphs

    return [graphs.PROGRAM_CACHE[k] for k in dict.fromkeys(asked) if k[0] == name]


def _cached_captures():
    """{key: captures} of every program in the BO loops' program cache."""
    from rollout_bo_tpu_torch.utils import graphs

    return {k: sum(g.captures for g in getattr(p, "graphs", (p,)))
            for k, p in graphs.PROGRAM_CACHE.items()}


def _tree_equal(a, b):
    """Two results (states, tuples of tensors) equal bit for bit."""
    from rollout_bo_tpu_torch.utils import graphs

    la, lb = [], []
    return (graphs._flatten(a, la) == graphs._flatten(b, lb) and len(la) == len(lb)
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def _hartmann6d_state(dev, n, cap, seed=1906):
    """hartmann6d, n uniform observations in a capacity-cap buffer, float64."""
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.ops import kernels as K

    f = testfns.get_function("hartmann6d")
    X = np.random.default_rng(seed).uniform(f.lbs, f.ubs, (n, f.dim))
    return f, sg.fit(K.matern52(device=dev, dtype=torch.float64), X,
                     f.batch(torch.tensor(X)).numpy(), capacity=cap, noise=1e-6, device=dev,
                     dtype=torch.float64)


def _observe_routes(dev, card, *, cap, label, reps=3):
    """The observe program (`bo._observer`: true function, condition, MLE
    when due) on a hartmann6d state of cap - 1 observations in a
    capacity-cap buffer, float64, against its function run eagerly on the
    same new point: equal bit for bit, with the MLE and without (the same
    kernels at the same shapes on one card; one graph each). Timed apart
    from any trial, synchronized, the median of `reps` in turns: the eager
    refit alone (`optimize_hypers` after the condition), the eager observe
    and the replayed one (MLE due). Returns those ms with the program's
    capture seconds and pool bytes."""
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    f, state = _hartmann6d_state(dev, cap - 1, cap)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)  # noqa: E731
    klbs, kubs = t([0.1]), t([5.0])
    fn = bo._observer(f, klbs, kubs)
    prog = graphs.GraphProgram(fn, device=dev)
    rng = np.random.default_rng(7)
    for do_mle in (True, False):
        x = t(rng.uniform(f.lbs, f.ubs))
        got, want = prog(state, x, do_mle), fn(state, x, do_mle)
        torch.cuda.synchronize()
        if not _tree_equal(got, want):
            raise AssertionError(f"observe program ({label}, MLE {do_mle}): the replay is not "
                                 "the eager observe bit for bit")
    if prog.captures != 2:
        raise AssertionError(f"observe program ({label}): {prog.captures} captures, not 2")
    x = t(rng.uniform(f.lbs, f.ubs))
    conditioned = sg.condition(state, x, f.f(x))
    calls = {"refit": lambda: sg.optimize_hypers(conditioned, klbs, kubs),
             "eager": lambda: fn(state, x, True), "program": lambda: prog(state, x, True)}
    ms = {name: [] for name in calls}
    for r in range(reps):
        for name in list(calls) if r % 2 == 0 else list(calls)[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0))
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(f"observe program, {label} (hartmann6d, n {cap} of capacity {cap}, float64): replay "
          f"== eager bit for bit with and without the MLE; timed apart from the trial "
          f"(median of {reps} in turns): eager refit {med['refit']:.2f} ms, eager observe "
          f"{med['eager']:.2f} ms, replayed observe {med['program']:.2f} ms; capture "
          f"{prog.capture_seconds:.3f} s (2 graphs), memory pools {prog.pool_bytes} B; on "
          f"{card}")
    return dict(refit_ms=med["refit"], eager_ms=med["eager"], replay_ms=med["program"],
                capture_s=prog.capture_seconds, pool_bytes=prog.pool_bytes)


def _myopic_routes(dev, card, *, budget, rule_name="EI", chunks=(0,), label="myopic"):
    """One myopic trial (hartmann6d, 64 starts, float64, `budget` cut) in
    the eager loop (`_eager_loops`) and through its chunk programs with each
    `steps_per_call` of `chunks`, in one process: the points and fitted
    lengthscale bit for bit (the same kernels at the same shapes on one
    card); the lane kernel launched once per BO iteration on every route
    (none for Random), the warm-up runs of the captures taken off. Prints
    the seconds per BO iteration of each route; the chunk programs that the
    program route took, each captured once, with their capture seconds and
    pool bytes."""
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    f, _ = _hartmann6d_state("cpu", 1, 1)
    x_init = np.random.default_rng(1906).uniform(f.lbs, f.ubs, (5, f.dim))
    want = 0 if rule_name == "Random" else budget
    taken = []

    def run(route, k):
        with contextlib.ExitStack() as stack:
            if route == "eager":
                stack.enter_context(_eager_loops())
            asked = stack.enter_context(_asked_programs())
            torch.cuda.synchronize()
            nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
            t0 = time.perf_counter()
            res = bo.run_myopic_bo(f, dr.RULES[rule_name](), budget=budget, num_starts=64,
                                   x_init=x_init, device=dev, steps_per_call=k)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = nl.LAUNCHES - (graphs.WARMUP_LAUNCHES - warm0)
        if launches != want:
            raise AssertionError(f"{label}, {rule_name}, {route} (steps per call {k}): "
                                 f"{launches} kernel launches, not {want}")
        if route == "program":
            taken.extend(asked)
        return res, seconds

    eager, eager_s = run("eager", 0)
    routes = []
    for k in chunks:
        res, s = run("program", k)
        if not (np.array_equal(res.X, eager.X)
                and torch.equal(res.state.kernel.theta, eager.state.kernel.theta)):
            raise AssertionError(f"{label}, {rule_name}, steps per call {k}: the points "
                                 f"{res.X[5:]} are not the eager loop's {eager.X[5:]}")
        routes.append((k, s))
    chunk_programs = _taken(taken, "myopic_chunk") + _taken(taken, "nm_observe")
    captures = sum(p.captures for p in chunk_programs)
    if len(chunk_programs) != 2 or captures != 2:
        raise AssertionError(f"{label}, {rule_name}: {captures} captures over "
                             f"{len(chunk_programs)} programs, not the solve's and the "
                             f"observe step's, one graph each, for every chunk length")
    capture_s = sum(p.capture_seconds for p in chunk_programs)
    pool = sum(p.pool_bytes for p in chunk_programs)
    print(f"{label}, {rule_name} (hartmann6d, 64 starts, float64, budget {budget}): eager "
          f"loop {eager_s / budget:.4f} s per BO iteration; "
          + ", ".join(f"steps per call {k}: {s / budget:.4f} s per BO iteration"
                      for k, s in routes)
          + f" (captures included); points bit for bit the eager loop's, {want} kernel "
          f"launches per route; {captures} capture(s) {capture_s:.3f} s, memory pools "
          f"{pool} B; on {card}")
    return dict(eager_s=eager_s / budget, program_s={k: s / budget for k, s in routes},
                capture_s=capture_s, pool_bytes=pool)


@contextlib.contextmanager
def _simulate_timing():
    """Per simulate call: its wall seconds (synchronized) and the device time
    between CUDA events recorded around each `newton_solve_batch` call in it."""
    from rollout_bo_tpu_torch.rollout import mc, solvers

    rec = dict(simulate_s=[], solver_ms=[])
    simulate, solve = mc.simulate_trajectory_mc, solvers.newton_solve_batch
    events = []

    def timed_solve(*args, **kw):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = solve(*args, **kw)
        stop.record()
        events.append((start, stop))
        return out

    def timed_simulate(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = simulate(*args, **kw)
        torch.cuda.synchronize()
        rec["simulate_s"].append(time.perf_counter() - t0)
        rec["solver_ms"].append(sum(a.elapsed_time(b) for a, b in events))
        events.clear()
        return out

    mc.simulate_trajectory_mc, solvers.newton_solve_batch = timed_simulate, timed_solve
    try:
        yield rec
    finally:
        mc.simulate_trajectory_mc, solvers.newton_solve_batch = simulate, solve


def _check_csv(path, budget, *, gaps=False, trials=1):
    """Header, sentinel row and `trials` rows of `budget` finite numbers;
    returns the last row."""
    with open(path) as fh:
        rows = list(csv.reader(fh))
    if (len(rows) != 2 + trials or rows[0] != ["trial"] + [str(i) for i in range(1, budget + 1)]
            or [float(v) for v in rows[1]] != [-1.0] * (budget + 1)):
        raise AssertionError(f"{path}: not header + sentinel + {trials} trial row(s)")
    for r in rows[2:]:
        row = np.asarray([float(v) for v in r])
        if row.shape != (budget,) or not np.all(np.isfinite(row)):
            raise AssertionError(f"{path}: a trial row is not {budget} finite numbers")
        # the optimizer locations are rounded, so a found optimum may pass 1 by a hair
        if gaps and not (np.all(row >= 0.0) and np.all(row <= 1.0 + 1e-3)
                         and np.all(np.diff(row) >= 0.0)):
            raise AssertionError(f"{path}: gaps outside [0, 1] or decreasing: {row}")
    return row


def _lengthscale_in_bounds(res, label):
    ell = float(res.state.kernel.theta[0])
    if not 0.1 <= ell <= 5.0:
        raise AssertionError(f"{label}: fitted lengthscale {ell} outside [0.1, 5]")
    return ell


def phase_myopic_cli(dev, card, budget=100):
    from rollout_bo_tpu_torch.experiments import myopic
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    acqs = ["ei", "poi", "lcb", "random"]
    with tempfile.TemporaryDirectory() as out, _recording() as rec:
        nl.LAUNCHES = 0
        myopic.main(["--function-name", "hartmann6d", "--trials", "1", "--budget",
                     str(budget), "--starts", "64", "--acquisitions", *acqs,
                     "--seed", "1906", "--output-dir", out])
        torch.cuda.synchronize()
        outdir = os.path.join(out, "hartmann6d")
        if not os.path.exists(os.path.join(outdir, "metadata.txt")):
            raise AssertionError("myopic CLI wrote no metadata.txt")
        gaps = {}
        for acq in acqs:
            for metric in myopic.METRICS:
                row = _check_csv(os.path.join(outdir, f"{acq}_{metric}.csv"), budget,
                                 gaps=metric == "gaps")
                if metric == "gaps":
                    gaps[acq] = row
    if len(rec["trials"]) != len(acqs):
        raise AssertionError(f"{len(rec['trials'])} trials ran, not {len(acqs)}")
    before = before_warm = 0
    for acq, trial in zip(acqs, rec["trials"]):
        res, launches = trial["res"], trial["launches"] - before
        before = trial["launches"]
        want = 0 if acq == "random" else budget
        if launches != want:
            raise AssertionError(f"myopic {acq}: {launches} kernel launches, not {want}")
        line = (f"myopic BO, hartmann6d, {acq}, one chunk program of {budget} iterations: "
                f"final gap {gaps[acq][-1]:.4f}, {launches} kernel launches (besides "
                f"{trial['warmup'] - before_warm} in the warm-up runs), "
                f"{res.times[0]:.4f} s per BO iteration (the chunk's time over {budget}: "
                f"solve, observe, condition, MLE; the lane kernel at this shape "
                f"{_kernel_ms('myopic')}), whole trial over the budget "
                f"{trial['seconds'] / budget:.4f} s")
        before_warm = trial["warmup"]
        if acq != "random":
            ell = _lengthscale_in_bounds(res, f"myopic {acq}")
            line += (f", fitted lengthscale {ell:.4f}, solves whose winner left its start "
                     f"{float(trial['moved'].mean()):.4f} (over the {len(trial['moved'])} "
                     f"solves a replay does not hide: the warm-up runs)")
        print(line + f"; on {card}")
    if not gaps["ei"][-1] > 0.0:
        raise AssertionError("myopic EI made no progress: final gap 0")
    # beside the CLI: the refit and the observe step timed apart from the
    # trials (a replay hides them from the recorder), and one trial at a cut
    # budget on both routes in this process
    _observe_routes(dev, card, cap=105, label="the myopic width")
    _myopic_routes(dev, card, budget=10, label="myopic trial, eager loop and program")


def phase_nonmyopic_cli(dev, card, budget=15, horizon=2):
    from rollout_bo_tpu_torch.experiments import nonmyopic
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    with tempfile.TemporaryDirectory() as out, _recording() as rec:
        nl.LAUNCHES = 0
        nonmyopic.main(["--function-name", "hartmann6d", "--horizon", str(horizon),
                        "--trials", "1", "--budget", str(budget), "--mc-samples", "200",
                        "--batch-size", "8", "--sgd-iterations", "50", "--starts", "16",
                        "--optimize", "--variance-reduction", "--seed", "1906",
                        "--output-dir", out])
        torch.cuda.synchronize()
        if not os.path.exists(os.path.join(out, "metadata.txt")):
            raise AssertionError("non-myopic CLI wrote no metadata.txt")
        for metric in ("times", "gaps", "observations"):
            row = _check_csv(os.path.join(out, "hartmann6d",
                                          f"rollout_h{horizon}_{metric}.csv"),
                             budget, gaps=metric == "gaps")
            if metric == "gaps":
                gaps = row
    (trial,) = rec["trials"]
    res = trial["res"]
    want = int(horizon * (res.sga_iterations + 1).sum() + res.fallbacks.sum())
    if trial["launches"] != want:
        raise AssertionError(f"non-myopic: {trial['launches']} kernel launches, not "
                             f"{want} = {horizon} x sum(SGA iterations + 1) + fallbacks")
    ell = _lengthscale_in_bounds(res, "non-myopic")
    timing = _observe_routes(dev, card, cap=5 + budget, label="the non-myopic width")
    print(f"non-myopic BO, hartmann6d, h {horizon}, 10 restarts x 200 trajectories, "
          f"budget {budget}, acquisition, observe and fallback programs: final gap "
          f"{gaps[-1]:.4f}, {trial['launches']} kernel "
          f"launches (besides {trial['warmup']} in the graphs' warm-up runs), acquisition "
          f"median {statistics.median(res.times):.4f} s "
          f"(min {res.times.min():.4f}, max {res.times.max():.4f}), whole BO iteration "
          f"{trial['seconds'] / budget:.4f} s (the lane kernel at this shape "
          f"{_kernel_ms('non-myopic')}, {trial['launches'] / budget:.2f} launches per BO "
          f"iteration), SGA iterations per acquisition "
          f"{res.sga_iterations.tolist()}, fallbacks {int(res.fallbacks.sum())}, MLE "
          f"refit {timing['refit_ms']:.2f} ms eager and observe {timing['replay_ms']:.2f} ms "
          f"replayed (timed apart, above), fitted lengthscale "
          f"{ell:.4f}, solver lanes that left their start "
          f"{float(trial['moved'].mean()):.4f} (over the {trial['solver_calls']} solver "
          f"calls a replay does not hide: the graphs' warm-up runs and the fallbacks); on "
          f"{card}")

    # the Gauss-Hermite (SAA) solver at the same width: 8 nodes, so
    # 8^(h+1) quadrature trajectories per restart; one BO iteration
    with tempfile.TemporaryDirectory() as out, _recording() as rec:
        nl.LAUNCHES = 0
        nonmyopic.main(["--function-name", "hartmann6d", "--horizon", str(horizon),
                        "--trials", "1", "--budget", "1", "--batch-size", "8",
                        "--sgd-iterations", "50", "--starts", "16", "--optimize",
                        "--deterministic-solve", "--ghq-nodes", "8", "--seed", "1906",
                        "--output-dir", out])
        torch.cuda.synchronize()
        _check_csv(os.path.join(out, "hartmann6d", f"rollout_h{horizon}_observations.csv"), 1)
    (trial,) = rec["trials"]
    res = trial["res"]
    solves, odd = divmod(trial["launches"] - int(res.fallbacks.sum()), horizon)
    if odd or not 2 <= solves <= 51:
        raise AssertionError(f"deterministic solve: {trial['launches']} kernel launches are "
                             f"not {horizon} x (1..50 Adam iterations + 1) + fallbacks")
    print(f"non-myopic BO, deterministic solve through its program, hartmann6d, h {horizon}, "
          f"10 restarts x {8 ** (horizon + 1)} Gauss-Hermite trajectories, 1 BO iteration "
          f"(the capture of its two graphs included): acquisition "
          f"{res.times[0]:.4f} s, {solves - 1} Adam iterations, {trial['launches']} kernel "
          f"launches, fallbacks {int(res.fallbacks.sum())}, solver lanes that left their "
          f"start {float(trial['moved'].mean()):.4f}; on {card}")


def phase_adaptive_cli(dev, card, budget=15, horizon=2):
    from rollout_bo_tpu_torch.experiments import adaptive
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    with tempfile.TemporaryDirectory() as out, _recording() as rec:
        nl.LAUNCHES = 0
        adaptive.main(["--function-name", "hartmann6d", "--horizon", str(horizon),
                       "--trials", "1", "--budget", str(budget), "--mc-samples", "100",
                       "--batch-size", "8", "--sgd-iterations", "50", "--starts", "16",
                       "--optimize", "--variance-reduction", "--dtype", "float64",
                       "--seed", "1906", "--output-dir", out])
        torch.cuda.synchronize()
        outdir = os.path.join(out, "hartmann6d")
        if os.path.exists(os.path.join(outdir, "hartmann6d_failed.txt")):
            with open(os.path.join(outdir, "hartmann6d_failed.txt")) as fh:
                raise AssertionError(f"the adaptive trial failed:\n{fh.read()}")
        rows = {m: _check_csv(os.path.join(outdir, f"rollout_h{horizon}_{m}.csv"), budget,
                              gaps=m == "gaps")
                for m in ("gaps", "observations", "times", "allocations")}
    (trial,) = rec["trials"]
    res, acqs = trial["res"], trial["acquisitions"]
    if not np.all(rows["allocations"] >= 0.0):
        raise AssertionError(f"adaptive: negative allocations {rows['allocations']}")
    hs = [a["h"] for a in acqs]
    if hs != [0 if b % 2 == 0 else horizon for b in range(budget)]:
        raise AssertionError(f"adaptive: horizons {hs} are not the alternating schedule")
    for b, a in enumerate(acqs):
        want = a["h"] * (a["iterations"] + 1) + a["fallback"]
        if a["launches"] != want:
            raise AssertionError(f"adaptive, BO iteration {b} (h {a['h']}): {a['launches']} "
                                 f"kernel launches, not {want} = h x (SGA iterations + 1) "
                                 f"+ fallback")
    if trial["launches"] != sum(a["launches"] for a in acqs):
        raise AssertionError("adaptive: kernel launches outside the acquisitions")
    times = {h: [float(res.times[b]) for b, a in enumerate(acqs) if a["h"] == h]
             for h in (0, horizon)}
    peak = [int(res.allocations[b]) for b, a in enumerate(acqs) if a["h"] == horizon]
    ell = _lengthscale_in_bounds(res, "adaptive")
    timing = _observe_routes(dev, card, cap=1 + budget, label="the adaptive width")
    print(f"adaptive BO, hartmann6d, h 0 / {horizon} alternating, 10 restarts x 100 "
          f"trajectories, budget {budget}: final gap {rows['gaps'][-1]:.4f}, "
          f"{trial['launches']} kernel launches (besides {trial['warmup']} in the graphs' "
          f"warm-up runs), acquisition median h 0 "
          f"{statistics.median(times[0]):.4f} s, h {horizon} "
          f"{statistics.median(times[horizon]):.4f} s (min {min(times[horizon]):.4f}, max "
          f"{max(times[horizon]):.4f}), SGA iterations per acquisition "
          f"{[a['iterations'] for a in acqs]}, fallbacks {int(res.fallbacks.sum())}, whole "
          f"BO iteration {trial['seconds'] / budget:.4f} s, MLE refit "
          f"{timing['refit_ms']:.2f} ms eager and observe {timing['replay_ms']:.2f} ms "
          f"replayed (timed apart, above), fitted lengthscale {ell:.4f}, peak "
          f"device bytes per h {horizon} acquisition {peak}; on {card}")
    _fallback_routes(dev, card, cap=1 + budget)
    return trial["launches"]


def _fallback_routes(dev, card, *, cap, reps=3):
    """The exploration fallback as a program (the `GraphProgram` of
    `bo._make_exploration_fallback` that `bo._fallback_program` caches: the
    lane kernel's LogEI solve, 16 + 2 starts, and the max-sigma explorer) on a
    hartmann6d state of cap observations, float64, against its function run
    eagerly: equal bit for bit on two states, one capture, one launch per
    call besides the warm-up runs; the median of `reps` in turns."""
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    f, state = _hartmann6d_state(dev, cap - 1, cap)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)  # noqa: E731
    fn = bo._make_exploration_fallback(dr.EI(), t([0.0]), t(f.lbs), t(f.ubs),
                                       t(qmc.generate_initial_guesses(16, f.lbs, f.ubs)), 12)
    prog = graphs.GraphProgram(fn, device=dev)
    states = (state, sg.condition(state, t(np.full(f.dim, 0.5)), t(-1.0)))
    seconds = {"eager": [], "program": []}
    for r, st in enumerate(states * reps):
        out = {}
        for name in ("eager", "program") if r % 2 == 0 else ("program", "eager"):
            torch.cuda.synchronize()
            nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
            t0 = time.perf_counter()
            out[name] = (fn if name == "eager" else prog)(st)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            if nl.LAUNCHES - (graphs.WARMUP_LAUNCHES - warm0) != 1:
                raise AssertionError(f"fallback, {name}: {nl.LAUNCHES} kernel launches")
        if not _tree_equal(out["program"], out["eager"]):
            raise AssertionError("fallback program: the replay is not the eager call bit for bit")
    if prog.captures != 1:
        raise AssertionError(f"fallback program: {prog.captures} captures, not 1")
    med = {name: statistics.median(v[1:]) for name, v in seconds.items()}
    print(f"fallback program (hartmann6d, n {cap}, 18 starts, float64): replay == eager bit "
          f"for bit on {len(states) * reps} calls, 1 kernel launch each; eager "
          f"{med['eager'] * 1e3:.2f} ms, replayed {med['program'] * 1e3:.2f} ms per call "
          f"(medians after the first); capture {prog.capture_seconds:.3f} s, memory pools "
          f"{prog.pool_bytes} B; on {card}")


def phase_cost_aware_cli(dev, card, budget=1):
    from rollout_bo_tpu_torch.experiments import cost_aware
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    from rollout_bo_tpu_torch.utils import graphs

    modes = ("uniform", "nonuniform", "gp")
    amp = 3.0
    # the trials run as users run them: their acquisitions through the
    # program cache (CUDA graphs); the time per simulate call and
    # newton_solve_batch's share of it, which a replay hides, come from
    # eager simulate calls at the same width (`_simulate_cost_against_kernel`)
    with tempfile.TemporaryDirectory() as out, _recording() as rec:
        cached, captures, before = set(graphs.PROGRAM_CACHE), graphs.CAPTURES, _cached_captures()
        nl.LAUNCHES = 0
        for mode in modes:
            cost_aware.main(["--function-name", "braninhoo", "--trials", "1", "--budget",
                             str(budget), "--modes", mode, "--cost-amp", str(amp),
                             "--seed", "1906", "--output-dir", out])
            torch.cuda.synchronize()
        base = os.path.join(out, "braninhoo")
        costs = {}
        for mode in modes:
            for metric in ("gaps", "observations", "times"):
                _check_csv(os.path.join(base, f"{mode}_rollout_h1_{metric}.csv"), budget,
                           gaps=metric == "gaps")
            costs[mode] = _check_csv(os.path.join(base, f"{mode}_costs.csv"), budget)
            if not np.all((costs[mode] >= 1.0) & (costs[mode] <= 1.0 + amp)):
                raise AssertionError(f"cost-aware {mode}: costs {costs[mode]} outside "
                                     f"[1, {1 + amp}]")
    new = {k: p for k, p in graphs.PROGRAM_CACHE.items() if k not in cached}
    acquisitions = [p for k, p in new.items() if k[0] == "nm_acquire"]
    observes = [p for k, p in new.items() if k[0] == "nm_observe"]
    counted = sum(n - before.get(k, 0) for k, n in _cached_captures().items())
    if (len(acquisitions) != len(modes)
            or any([g.captures for g in p.graphs] != [1, 1] for p in acquisitions)
            or any(p.captures != 1 for p in observes)
            or graphs.CAPTURES - captures != counted):
        raise AssertionError(f"cost-aware: {len(acquisitions)} acquisition programs, "
                             f"{graphs.CAPTURES - captures} captures ({counted} in the cached "
                             "programs), not one acquisition program of two graphs per mode "
                             "and one graph per observe program")
    simulate = _simulate_cost_against_kernel(dev, card, amp)
    before = 0
    for mode, trial in zip(modes, rec["trials"]):
        res, launches = trial["res"], trial["launches"] - before
        before = trial["launches"]
        if launches != int(res.fallbacks.sum()):
            raise AssertionError(f"cost-aware {mode}: {launches} kernel launches, not the "
                                 f"{int(res.fallbacks.sum())} fallbacks taken: a cost-aware "
                                 "solve reached the lane kernel")
        sim_s, share = simulate[mode]
        print(f"cost-aware BO, braninhoo, {mode}, 10 restarts x 100 trajectories, budget "
              f"{budget}, float32, through the program cache: acquisition median "
              f"{statistics.median(res.times):.4f} s, {launches} kernel launches = "
              f"fallbacks, SGA iterations {res.sga_iterations.tolist()}, cumulative cost "
              f"{costs[mode].sum():.4f}; an eager simulate call at this width "
              f"{sim_s:.4f} s (median), newton_solve_batch {share:.4f} of its time; "
              f"on {card}")


def _simulate_cost_against_kernel(dev, card, amp, reps=3):
    """One eager simulate call (with gradients) at phase 9's width on one
    braninhoo surrogate: plain EI, which the kernel solves, against the
    three cost-aware rules, which newton_solve_batch solves; timed in turns
    (forward, then backward order) after a warm-up of each, with CUDA
    events around each newton_solve_batch call (`_simulate_timing`).
    Returns {mode: (median seconds per call, newton_solve_batch's share of
    the calls' time)} of the cost-aware rules."""
    from rollout_bo_tpu_torch.experiments import cost_aware
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.ops import kernels as K
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc
    from rollout_bo_tpu_torch.rollout import mc
    from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

    f = testfns.get_function("braninhoo")
    dt = torch.float32
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    X = np.random.default_rng(1906).uniform(f.lbs, f.ubs, (3, f.dim))
    state = sg.fit(K.matern52(device=dev, dtype=dt), X, f.batch(torch.tensor(X)).numpy(),
                   capacity=4, noise=1e-6, device=dev, dtype=dt)
    tp = TrajectoryParams(x0=t(qmc.generate_batch(8, f.lbs, f.ubs)), theta=t([0.0]),
                          lbs=t(f.lbs), ubs=t(f.ubs),
                          rnstream=t(qmc.gen_low_discrepancy_sequence(100, f.dim, 2)))
    xstarts = t(qmc.generate_initial_guesses(8, f.lbs, f.ubs))
    c = cost_aware.make_true_cost(f, "braninhoo", amp, 2.0)
    rules = {"EI (kernel)": dr.EI()}
    for mode in ("uniform", "nonuniform", "gp"):
        rules[mode] = cost_aware.build_rule(mode, c, f, 16, 1906, dt, dev)
    call = lambda rule: mc.simulate_trajectory_mc(state, tp, rule, xstarts,
                                                  with_gradients=True)
    seconds = {name: [] for name in rules}
    solver_ms = {name: [] for name in rules}
    for name, rule in rules.items():
        call(rule)                                          # warm-up
    names = list(rules)
    with _simulate_timing() as sim:
        for r in range(reps):
            for name in names if r % 2 == 0 else names[::-1]:
                launches = nl.LAUNCHES
                call(rules[name])
                seconds[name].append(sim["simulate_s"][-1])
                solver_ms[name].append(sim["solver_ms"][-1])
                if nl.LAUNCHES - launches != (name == "EI (kernel)"):
                    raise AssertionError(f"simulate call with {name}: "
                                         f"{nl.LAUNCHES - launches} kernel launches")
    base = statistics.median(seconds["EI (kernel)"])
    print(f"simulate call, braninhoo, h 1, 10 restarts x 100 trajectories, 10 starts, "
          f"float32, median of {reps} in turns: " + ", ".join(
              f"{name} {statistics.median(v):.4f} s ({statistics.median(v) / base:.2f}x)"
              for name, v in seconds.items()) + f"; on {card}")
    return {name: (statistics.median(seconds[name]),
                   sum(solver_ms[name]) / 1e3 / sum(seconds[name]))
            for name in rules if name != "EI (kernel)"}


def phase_card_equals_cpu(dev):
    """Small float64 trials of every loop, the card against the CPU route
    (which the CPU tests hold to the JAX package)."""
    from rollout_bo_tpu_torch.models import cost_functions as cf
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.rollout import bo

    # hartmann3d: values of order 1 on the unit box, so EI keeps a gradient
    # (on braninhoo, |f| ~ 100, EI underflows after three iterations, the
    # starts tie to rounding and the two routes may pick different ones)
    f = testfns.get_function("hartmann3d")
    x_init = np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim))
    width = float(np.max(f.ubs - f.lbs))
    nonmyopic = dict(horizon=1, num_starts=8, num_restarts=2, sgd_iters=3, lr=0.05,
                     solver_iterations=8, x_init=x_init)
    cases = {
        "myopic, 4 iterations": lambda device: bo.run_myopic_bo(
            f, dr.EI(), budget=4, num_starts=8, x_init=x_init, device=device),
        "non-myopic, 2 iterations (h 1, 8 samples)": lambda device: bo.run_nonmyopic_bo(
            f, budget=2, mc_iters=8, device=device, **nonmyopic),
        "deterministic solve, 1 iteration (h 1, 4 nodes)": lambda device: bo.run_nonmyopic_bo(
            f, budget=1, deterministic=True, ghq_nodes=4, device=device, **nonmyopic),
        "adaptive, 3 iterations (h 0, 1, 0; 8 samples)": lambda device: bo.run_adaptive_bo(
            f, budget=3, mc_iters=8, mle_every=1, device=device, **nonmyopic),
        "cost-aware non-myopic, 2 iterations (h 1, 8 samples)": lambda device: (
            bo.run_nonmyopic_bo(f, budget=2, mc_iters=8, device=device, rule=cf.cost_aware(
                dr.EI(), cf.NonUniformCost(lambda x: 1.0 + torch.sum(x * x))), **nonmyopic)),
    }
    for label, run in cases.items():
        gpu, cpu = run(dev), run("cpu")
        torch.cuda.synchronize()
        apart = float(np.abs(gpu.X - cpu.X).max())
        th_gpu, th_cpu = float(gpu.state.kernel.theta[0]), float(cpu.state.kernel.theta[0])
        if apart > 1e-6 * width or not math.isclose(th_gpu, th_cpu, rel_tol=1e-6):
            raise AssertionError(f"{label}: card {gpu.X} theta {th_gpu} vs CPU route "
                                 f"{cpu.X} theta {th_cpu}")
        print(f"BO loop, small float64, {label}: card == CPU route (points within "
              f"{apart:.2e} of each other in a box of width {width}, fitted lengthscale "
              f"{th_gpu:.8f})")


# --------------------------------------------------------------------------
# phase 10: the sharded path, ranks of torch.distributed on the card
# --------------------------------------------------------------------------


def _tests_module(filename, name):
    """A module of tests/ that imports no jax, loaded from its file."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", filename)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _worker_problems():
    """tests/torch_parallel_ranks.py and the fused solves of its worker
    problem (float64, h 1, 8 restarts x 16 trajectories) at meshes (2, 1)
    and (1, 2), in the form of its `solve_case`."""
    ranks = _tests_module("torch_parallel_ranks.py", "torch_parallel_ranks")
    p, kw = ranks.worker_fields(), dict(max_iters=4, inner_iterations=10)
    return ranks, {f"m{r}x{m}": ("fused", (r, m), p, kw) for r, m in ((2, 1), (1, 2))}


def _start_ranks(fn, world, backend, tmp, **kw):
    """Run fn(rank, world, init_method, backend, tmp, kw) in `world` new
    processes (spawn; a rank that fails ends the others and raises here);
    returns the reports the ranks wrote to tmp/rank<i>.json."""
    import torch.multiprocessing as mp

    tag = f"{fn.__name__}-{backend}-{world}"
    mp.start_processes(fn, args=(world, f"file://{os.path.join(tmp, 'store-' + tag)}",
                                 backend, os.path.join(tmp, tag), kw),
                       nprocs=world, start_method="spawn")
    reports = []
    for r in range(world):
        with open(os.path.join(tmp, f"{tag}-rank{r}.json")) as fh:
            reports.append(json.load(fh))
    return reports


def _rank_sharded(rank, world, init_method, backend, prefix, kw):
    """One rank: the bench configuration's sharded fused solve at each mesh
    shape (launches counted from 0 just before the timed solve), through a
    program built for the mesh on NCCL and on the eager mesh route on gloo
    (by rule: no graph holds a gloo collective); with
    kw["small"] a small float64 trial of the non-myopic loop on the mesh,
    on the card and on the CPU route, and the float64 worker problem's
    sharded solves (`_worker_problems`)."""
    from bench_torch import bench_problem
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
    from rollout_bo_tpu_torch.parallel import sharded
    from rollout_bo_tpu_torch.rollout import bo, outer

    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method, world, rank, backend=backend)
    try:
        dev = mesh_mod.rank_device("cuda")
        report = dict(rank=rank, device=str(dev), solves=[])
        state, tp, xstarts, restarts = bench_problem(dev, torch.float32)
        solver = dict(max_iters=50, lr=0.01, inner_iterations=10, select_best=True)
        for r, m in kw["shapes"]:
            mesh = mesh_mod.make_mesh(restarts=r, mc=m)
            program = (outer.make_fused_sga_program(state, tp, dr.EI(), xstarts, mesh=mesh,
                                                    **solver)
                       if mesh_mod.programs_run_on(mesh, dev) else None)
            solve = lambda: sharded.sharded_stochastic_solve_fused(
                state, tp, dr.EI(), xstarts, restarts, mesh, program=program, **solver)
            solve()                                   # warm-up
            torch.cuda.synchronize()
            nl.LAUNCHES = 0
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            seconds = [time.perf_counter() - t0]
            report["solves"].append(_solve_report(res, [r, m], nl.LAUNCHES, seconds, None,
                                                  restarts.shape[0] // r * (tp.mc_iters // m),
                                                  tp))
        if kw.get("small"):
            f = testfns.get_function("hartmann3d")
            x_init = np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim))
            mesh = mesh_mod.make_mesh(restarts=world, mc=1)
            for device in (dev, torch.device("cpu")):
                res = bo.run_nonmyopic_bo(
                    f, horizon=1, budget=2, mc_iters=8, num_starts=8, num_restarts=2,
                    sgd_iters=3, lr=0.05, solver_iterations=8, x_init=x_init, device=device,
                    mesh=mesh)
                report[f"X_{device.type}"] = res.X.tolist()
            ranks, problems = _worker_problems()
            report["worker"] = {k: np.asarray(v).tolist() for k, v in
                                ranks.solve_case(problems, device="cuda").items()}
        with open(f"{prefix}-rank{rank}.json", "w") as fh:
            json.dump(report, fh)
    finally:
        mesh_mod.finalize_distributed()


def _solve_report(res, mesh, launches, seconds, plain_seconds, lanes, tp):
    """One rank's sharded bench solve, as `_check_sharded_solves` reads it."""
    x = res.x.cpu()
    return dict(mesh=mesh, iterations=res.iterations, launches=launches,
                seconds=statistics.median(seconds),
                plain_seconds=statistics.median(plain_seconds) if plain_seconds else None,
                lanes=lanes, x=x.tolist(), value=float(res.value),
                inside=bool(torch.all((x >= tp.lbs.cpu()) & (x <= tp.ubs.cpu()))))


def _cli_rank(rank, args, world, init_method):
    """One rank of the non-myopic CLI's `--nworkers` run, as the CLI starts
    it, recording per trial its kernel launches (from 0 at the trial's
    start, the warm-up runs of a capture taken off), SGA iterations and
    fallbacks to <output dir>/rank<i>.json."""
    from rollout_bo_tpu_torch.experiments import nonmyopic
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    trials, loop = [], bo.run_nonmyopic_bo

    def recorded(*a, **kw):
        nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
        t0 = time.perf_counter()
        res = loop(*a, **kw)
        torch.cuda.synchronize()
        trials.append(dict(launches=nl.LAUNCHES - (graphs.WARMUP_LAUNCHES - warm0),
                           seconds=time.perf_counter() - t0,
                           sga_iterations=res.sga_iterations.tolist(),
                           fallbacks=res.fallbacks.tolist(), times=res.times.tolist(),
                           X=res.X.tolist()))
        return res

    bo.run_nonmyopic_bo = recorded
    try:
        nonmyopic._rank_main(rank, args, world, init_method)
    finally:
        bo.run_nonmyopic_bo = loop
    with open(os.path.join(args.output_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(trials, fh)


def _check_sharded_solves(reports, label, card):
    """Every rank: the same finite winner inside the box, its launches =
    3 x (SGA iterations + 1); prints each rank's lanes per launch and
    seconds per acquisition."""
    for i, solves in enumerate(zip(*(r["solves"] for r in reports))):
        (r0, *_), mesh = solves, solves[0]["mesh"]
        for rep in solves:
            if rep["launches"] != 3 * (rep["iterations"] + 1):
                raise AssertionError(f"{label} mesh {mesh}: {rep['launches']} kernel launches "
                                     f"on a rank, not 3 x ({rep['iterations']} + 1)")
            if not (all(map(math.isfinite, rep["x"])) and rep["inside"]
                    and math.isfinite(rep["value"]) and rep["value"] >= 0.0):
                raise AssertionError(f"{label} mesh {mesh}: winner {rep['x']} value "
                                     f"{rep['value']} not finite inside the box")
            if (rep["x"], rep["value"], rep["iterations"]) != (r0["x"], r0["value"],
                                                              r0["iterations"]):
                raise AssertionError(f"{label} mesh {mesh}: the ranks disagree")
        print(f"sharded path, bench.py configuration, {label}, mesh (restarts {mesh[0]}, mc "
              f"{mesh[1]}): {r0['iterations']} SGA iterations, v_best {r0['value']:.6g}; "
              + "; ".join(f"rank {rep_i}: {rep['lanes']} lanes per launch, {rep['launches']} "
                          f"launches, {rep['seconds']:.4f} s per acquisition"
                          + ("" if rep["plain_seconds"] is None else
                             f" ({rep['plain_seconds']:.4f} s with no mesh in the same "
                             "process, medians of 3 in turns)")
                          for rep_i, rep in enumerate(solves)) + f"; on {card}")


def _check_worker_solves(out, card, dev, ranks_label):
    """The worker problem's sharded solves on two gloo ranks against the same
    solve with no mesh on the card: with its simulate calls split into the
    ranks' blocks of restarts and trajectories (`blocked`), equal to 1e-12,
    the gate of tests/test_torch_cuda.py; unblocked, one launch over all
    the lanes, whose dense products may round otherwise by batch size:
    the difference printed."""
    from rollout_bo_tpu_torch.rollout import mc as mc_mod

    ranks, problems = _worker_problems()
    simulate = mc_mod.simulate_trajectory_mc
    _, _, p, kw = next(iter(problems.values()))
    whole = ranks.unsharded_solve("fused", p, kw, device=dev)
    for name, (_, (r, m), p, kw) in problems.items():
        xs, vals = np.asarray(out[f"{name}_xs"]), np.asarray(out[f"{name}_vals"])
        mc_mod.simulate_trajectory_mc = ranks.blocked(simulate, r, m)
        try:
            ref = ranks.unsharded_solve("fused", p, kw, device=dev)
        finally:
            mc_mod.simulate_trajectory_mc = simulate
        np.testing.assert_allclose(xs, ref.x.cpu().numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=f"worker problem, mesh {name}, blocked")
        np.testing.assert_allclose(vals, ref.value.cpu().numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=f"worker problem, mesh {name}, blocked")
        if int(out[f"{name}_it"]) != ref.iterations:
            raise AssertionError(f"worker problem, mesh {name}: {out[f'{name}_it']} SGA "
                                 f"iterations, {ref.iterations} unsharded")
        def apart(a, b):
            return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

        blocked = (apart(xs, ref.x.cpu().numpy()), apart(vals, ref.value.cpu().numpy()))
        wx, wv = whole.x.cpu().numpy(), whole.value.cpu().numpy()
        print(f"sharded fused solve, worker problem (float64, h 1, 8 restarts x 16 "
              f"trajectories), {ranks_label} at mesh (restarts {r}, mc {m}) against one rank "
              f"with no mesh: blocked as the ranks launch, points {blocked[0]:.2e} / values "
              f"{blocked[1]:.2e} relative apart (gate 1e-12); unblocked (one launch of "
              f"{whole.x.shape[0] * 16} lanes), points {float(np.max(np.abs(xs - wx))):.2e} "
              f"absolute / values {apart(vals, wv):.2e} relative apart, SGA iterations "
              f"{int(out[f'{name}_it'])} vs {whole.iterations}; on {card}")


def _counted(run):
    """(result, kernel launches, seconds) of run() on the card: the launches
    counted from 0 just before it, those of the graphs' warm-up runs before
    a capture taken off."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.utils import graphs

    torch.cuda.synchronize()
    nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, nl.LAUNCHES - (graphs.WARMUP_LAUNCHES - warm0), time.perf_counter() - t0


def _in_turns(routes, reps=3):
    """Each route of {name: run} `reps` times in turns after one first call
    each (a program's capture): {name: [(result, launches, seconds), ...]},
    the first call first."""
    out = {name: [_counted(run)] for name, run in routes.items()}
    for r in range(reps):
        for name in (list(routes) if r % 2 == 0 else list(routes)[::-1]):
            out[name].append(_counted(routes[name]))
    return out


def _same(a, b):
    """Two lists of tensors equal bit for bit."""
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _bench_programs(dev, mesh, label):
    """bench.py's acquisition (trid10d, 8 restarts x 200 trajectories = 1600
    lanes, h 3, float32, 50 SGA iterations at most) through the sharded
    programs on `mesh`, each against the eager mesh route in the same
    process: the fused program (`sharded_stochastic_solve_fused(program=)`),
    the scanned one (windows of 10) and the batch one (kept per problem by
    `sharded_stochastic_solve_batch`), beside the single-device program.
    Bit for bit with the same SGA iterations; launches per rank 3 x (SGA
    iterations + 1) (the scanned program: 3 x 11 per window of 10),
    the warm-up runs off. Returns the report of the fused solves and the
    lines to print."""
    import bench_torch
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.parallel import sharded
    from rollout_bo_tpu_torch.rollout import outer
    from rollout_bo_tpu_torch.utils import graphs

    state, tp, xstarts, restarts = bench_torch.bench_problem(dev, torch.float32)
    kw = dict(max_iters=50, lr=0.01, inner_iterations=10)
    k = 10
    fused = outer.make_fused_sga_program(state, tp, EI(), xstarts, mesh=mesh, select_best=True,
                                         **kw)
    scanned = outer.make_scanned_sga_program(state, tp, EI(), xstarts, mesh=mesh,
                                             steps_per_call=k, lr=0.01, inner_iterations=10)
    single = bench_torch.fused_program(state, tp, xstarts)
    args = (state, tp, EI(), xstarts, restarts)
    runs = _in_turns({
        "fused program": lambda: sharded.sharded_stochastic_solve_fused(
            *args, mesh, select_best=True, program=fused, **kw),
        "fused eager": lambda: outer.stochastic_solve_fused(*args, mesh=mesh, select_best=True,
                                                            **kw),
        "scanned program": lambda: sharded.sharded_stochastic_solve_scanned(
            *args, mesh, program=scanned, steps_per_call=k, **kw),
        "scanned eager": lambda: outer.stochastic_solve_fused(*args, mesh=mesh,
                                                              steps_per_call=k, **kw),
        "batch program": lambda: sharded.sharded_stochastic_solve_batch(*args, mesh, **kw),
        "batch eager": lambda: outer.stochastic_solve_batch(*args, mesh=mesh, **kw),
        "single-device program": lambda: bench_torch.acquire(state, tp, xstarts, restarts,
                                                             program=single),
    })
    (batch_program,) = [p for key, p in graphs.PROGRAM_CACHE.items() if key[0] == "sharded_batch"
                        and key[2] == mesh]
    lines = []
    for (prog, eager), (a, b) in (
            (("fused program", "fused eager"), (lambda r: [r.x, r.value], ) * 2),
            (("scanned program", "scanned eager"), (list, lambda r: [r.x, r.value])),
            (("batch program", "batch eager"), (list, list))):
        for (res_p, launch_p, _), (res_e, launch_e, _) in zip(runs[prog], runs[eager]):
            if not _same(a(res_p), b(res_e)):
                raise AssertionError(f"{label}: the {prog} is not the {eager} route bit for bit")
            it = runs["fused eager"][0][0].iterations
            want_p = want_e = 3 * (it + 1)
            if prog == "fused program":
                if res_p.iterations != res_e.iterations:
                    raise AssertionError(f"{label}: {res_p.iterations} SGA iterations on the "
                                         f"fused program, {res_e.iterations} eager")
                want_p = want_e = 3 * (res_e.iterations + 1)
            elif prog == "scanned program":
                want_p, want_e = 3 * (k + 1) * (res_e.iterations // k), 3 * (res_e.iterations + 1)
            elif batch_program.iterations != it:
                raise AssertionError(f"{label}: the batch program ran {batch_program.iterations} "
                                     f"SGA iterations, the fused solve {it}")
            if (launch_p, launch_e) != (want_p, want_e):
                raise AssertionError(f"{label}: {prog} {launch_p} / eager {launch_e} kernel "
                                     f"launches per rank, not {want_p} / {want_e}")
    med = {name: statistics.median(t for _, _, t in r[1:]) for name, r in runs.items()}
    for name, program in (("fused", fused), ("scanned", scanned), ("batch", batch_program)):
        captures, capture_s, pool = _graph_numbers(program)
        lines.append(f"{name}: program {med[name + ' program']:.4f} s, eager mesh route "
                     f"{med[name + ' eager']:.4f} s per acquisition (medians of 3 in turns), "
                     f"{captures} captures, {capture_s:.3f} s, memory pools {pool} B")
    fs = runs["fused program"][1][0]
    lines.append(f"single-device program {med['single-device program']:.4f} s; "
                 f"{fs.iterations} SGA iterations, v_best {float(fs.value):.6g}; bit for bit "
                 f"on every call, launches 3 x (SGA iterations + 1) per rank on both routes "
                 f"(scanned: 3 x 11 per window)")
    solve = _solve_report(fs, [mesh.restarts, mesh.mc], runs["fused program"][1][1],
                          [t for _, _, t in runs["fused program"][1:]],
                          [t for _, _, t in runs["single-device program"][1:]],
                          restarts.shape[0] // mesh.restarts * (tp.mc_iters // mesh.mc), tp)
    return solve, lines


def _simulate_programs(dev, mesh, reps=5):
    """`sharded_simulate_mc` at the throughput width (4096 trajectories in
    all, h 3, float32, with gradients) through its cached program against
    the eager call on the same blocks, bit for bit (every field); the
    trajectories/s of its replays and of the single-device graph of the
    unsharded call (`scripts/throughput_torch.py`'s), medians of `reps`."""
    import bench_torch
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
    from rollout_bo_tpu_torch.parallel import sharded
    from rollout_bo_tpu_torch.rollout import mc as mc_mod
    from rollout_bo_tpu_torch.utils.graphs import GraphProgram

    state, tp, xstarts, _ = bench_torch.bench_problem(dev, torch.float32, mc=4096, horizon=3)
    kw = dict(with_gradients=True, iterations=10)
    group = mesh.group(mesh_mod.AXES)
    block = tp._replace(rnstream=mesh_mod.shard_leading(tp.rnstream, mesh, mesh_mod.AXES))
    single = GraphProgram(lambda st, t: mc_mod.simulate_trajectory_mc(st, t, EI(), xstarts, **kw),
                          device=dev)
    runs = _in_turns({
        "program": lambda: sharded.sharded_simulate_mc(state, tp, EI(), xstarts, mesh, **kw),
        "eager": lambda: mc_mod.simulate_trajectory_mc(state, block, EI(), xstarts, group=group,
                                                       **kw),
        "single": lambda: single(state, tp)}, reps)
    for (p, launch_p, _), (e, launch_e, _) in zip(runs["program"], runs["eager"]):
        if not _same(list(p), list(e)):
            raise AssertionError("sharded_simulate_mc: the replay is not the eager call bit "
                                 "for bit")
        if (launch_p, launch_e) != (3, 3):
            raise AssertionError(f"sharded_simulate_mc: {launch_p} / {launch_e} launches, not 3")
    return {name: tp.mc_iters / statistics.median(t for _, _, t in r[1:])
            for name, r in runs.items()}


def _mesh_loop_routes(dev, mesh, budget=3, horizon=2):
    """The non-myopic loop at the CLI's widths (hartmann6d, h 2, 200 QMC
    trajectories, 8 restarts, 16 + 2 starts, 50 SGA iterations, MLE on,
    float64, the CLI's first initial design; budget cut) on `mesh`,
    through `bo._cached_program` and then in the eager loop
    (`_eager_loops`): the same points bit for bit and the same fallbacks,
    every acquisition of the program route from the cache under a key that
    holds the mesh, the launch identity per acquisition on both routes.
    Returns {route: seconds per BO iteration} and the SGA iterations."""
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.rollout import bo

    f = testfns.get_function("hartmann6d")
    rng = np.random.default_rng(1906)
    x_init = np.asarray(f.lbs) + (np.asarray(f.ubs) - np.asarray(f.lbs)) * rng.uniform(
        size=(5, f.dim))
    kw = dict(horizon=horizon, mc_iters=200, budget=budget, n_init=5, num_starts=16,
              num_restarts=8, sgd_iters=50, seed=1906, mle_every=1, use_low_discrepancy=True,
              dtype=torch.float64, device=dev, mesh=mesh, x_init=x_init)
    trials = {}
    for route in ("program", "eager"):
        with contextlib.ExitStack() as stack:
            if route == "eager":
                stack.enter_context(_eager_loops())
            asked = stack.enter_context(_asked_programs())
            rec = stack.enter_context(_recording())
            bo.run_nonmyopic_bo(f, **kw)
            torch.cuda.synchronize()
        (trial,) = rec["trials"]
        for a in trial["acquisitions"]:
            if a["launches"] != horizon * (a["iterations"] + 1) + a["fallback"]:
                raise AssertionError(f"mesh loop, {route}: {a['launches']} kernel launches for "
                                     f"{a['iterations']} SGA iterations")
        acquisitions = [k for k in asked if k[0] == "nm_acquire"]
        want = budget if route == "program" else 0
        if (len(acquisitions) != want or any(
                k[-2] != ("mesh", mesh.restarts, mesh.mc, mesh.backend) for k in acquisitions)):
            raise AssertionError(f"mesh loop, {route}: acquisitions asked of the program "
                                 f"cache: {acquisitions}")
        trials[route] = trial
    p, e = trials["program"]["res"], trials["eager"]["res"]
    if not (np.array_equal(p.X, e.X) and np.array_equal(p.fallbacks, e.fallbacks)):
        raise AssertionError(f"mesh loop: the programs' points {p.X[-budget:]} are not the "
                             f"eager loop's {e.X[-budget:]} bit for bit")
    return ({route: t["seconds"] / budget for route, t in trials.items()},
            p.sga_iterations.tolist(), int(p.fallbacks.sum()))


def _rank_nccl_programs(rank, world, init_method, backend, prefix, kw):
    """One NCCL rank, one card each: the sharded programs at each mesh shape
    of kw["shapes"] (`_bench_programs`, `_simulate_programs`,
    `_mesh_loop_routes`), and with two or more ranks the float64 worker
    problem's sharded solves (`_worker_problems`). A failed check raises
    here and fails the phase."""
    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method, world, rank, backend=backend)
    try:
        dev = mesh_mod.rank_device("cuda")
        report = dict(rank=rank, device=str(dev), solves=[], shapes=[])
        for r, m in kw["shapes"]:
            mesh = mesh_mod.make_mesh(restarts=r, mc=m)
            solve, lines = _bench_programs(dev, mesh, f"NCCL mesh ({r}, {m})")
            report["solves"].append(solve)
            rates = _simulate_programs(dev, mesh)
            seconds, its, fallbacks = _mesh_loop_routes(dev, mesh)
            report["shapes"].append(dict(mesh=[r, m], lines=lines, rates=rates,
                                         loop_seconds=seconds, loop_iterations=its,
                                         loop_fallbacks=fallbacks))
        if world >= 2:
            ranks, problems = _worker_problems()
            report["worker"] = {k: np.asarray(v).tolist() for k, v in
                                ranks.solve_case(problems, device="cuda").items()}
        with open(f"{prefix}-rank{rank}.json", "w") as fh:
            json.dump(report, fh)
    finally:
        mesh_mod.finalize_distributed()


def _print_nccl_programs(reports, world, card):
    """The NCCL ranks' program lines (rank 0's; every rank checked its own)."""
    held = ("the graphs hold the world all-reduces (the active-restart count, the "
            "simulate statistics); the 'mc' all-reduce and the 'restarts' gather are the "
            "identity on a world of one and are captured only with two or more cards"
            if world == 1 else "the graphs hold the 'mc' all-reduces, the world-summed "
            "active-restart count and the 'restarts' gather")
    for shape in reports[0]["shapes"]:
        r, m = shape["mesh"]
        print(f"sharded programs, NCCL, {world} rank(s), mesh (restarts {r}, mc {m}), bench "
              f"width (trid10d, 8 restarts x 200 trajectories, h 3, float32): "
              + "; ".join(shape["lines"]) + f"; {held}; on {card}")
        rates = shape["rates"]
        print(f"sharded programs, NCCL mesh ({r}, {m}): sharded_simulate_mc at 4096 "
              f"trajectories (h 3, float32, with gradients), replay == eager call bit for "
              f"bit, 3 launches per call: program {rates['program']:.0f} trajectories/s, "
              f"eager {rates['eager']:.0f}/s, the single-device graph {rates['single']:.0f}/s "
              f"(medians of 5 in turns); on {card}")
        secs = shape["loop_seconds"]
        print(f"sharded programs, NCCL mesh ({r}, {m}): non-myopic loop at the CLI's widths "
              f"(hartmann6d, h 2, 8 restarts x 200 trajectories, 16 + 2 starts, float64, "
              f"budget 3): program route {secs['program']:.4f} s, eager route "
              f"{secs['eager']:.4f} s per BO iteration, points and fallbacks "
              f"({shape['loop_fallbacks']}) bit for bit, every acquisition from "
              f"_cached_program, SGA iterations {shape['loop_iterations']}; on {card}")


def phase_sharded(card, budget=3, horizon=2):
    from rollout_bo_tpu_torch.experiments import nonmyopic

    n_cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        # two gloo ranks sharing cuda:0 (no scaling: one card), then a small
        # float64 trial of the loop on the card and on the CPU route
        reports = _start_ranks(_rank_sharded, 2, "gloo", tmp, shapes=[(2, 1), (1, 2)],
                               small=True)
        _check_sharded_solves(reports, "2 gloo ranks sharing cuda:0", card)
        gpu, cpu = np.asarray(reports[0]["X_cuda"]), np.asarray(reports[0]["X_cpu"])
        apart = float(np.abs(gpu - cpu).max())
        if gpu.shape != (7, 3) or apart > 1e-6:     # hartmann3d's box is [0, 1]^3
            raise AssertionError(f"2-rank trial: card {gpu} vs CPU route {cpu}")
        print(f"sharded BO loop, small float64 (hartmann3d, h 1, 8 samples, 2 restarts on 2 "
              f"gloo ranks): card == CPU route (points within {apart:.2e})")
        _check_worker_solves(reports[0]["worker"], card, torch.device("cuda", 0),
                             "2 gloo ranks")

        # NCCL, one rank per card (NCCL refuses two ranks on one card): the
        # fused solve's program on every card that a power of two of ranks
        # fills, at (ranks, 1), where there are more than two (fewer are
        # among the meshes below)
        widest = max(w for w in (1, 2, 4, 8) if w <= n_cards)
        if widest > 2:
            reports = _start_ranks(_rank_sharded, widest, "nccl", tmp,
                                   shapes=[(widest, 1)])
            _check_sharded_solves(reports, f"NCCL program, {widest} ranks on {widest} cards",
                                  card)
        # the sharded programs, their graphs holding the collectives
        world = min(n_cards, 2)
        shapes = [(1, 1)] if world == 1 else [(2, 1), (1, 2)]
        reports = _start_ranks(_rank_nccl_programs, world, "nccl", tmp, shapes=shapes)
        _check_sharded_solves(reports, f"NCCL programs, {world} rank(s) on {world} card(s)",
                              card)
        _print_nccl_programs(reports, world, card)
        if world >= 2:
            _check_worker_solves(reports[0]["worker"], card, torch.device("cuda", 0),
                                 "2 NCCL ranks")

        # the CLI at its widths on two ranks (budget cut to 3)
        out = os.path.join(tmp, "cli")
        real = nonmyopic._rank_main
        nonmyopic._rank_main = _cli_rank
        try:
            t0 = time.perf_counter()
            nonmyopic.main(["--function-name", "hartmann6d", "--horizon", str(horizon),
                            "--trials", "1", "--budget", str(budget), "--mc-samples", "200",
                            "--batch-size", "8", "--sgd-iterations", "50", "--starts", "16",
                            "--optimize", "--variance-reduction", "--seed", "1906",
                            "--nworkers", "2", "--backend", "gloo", "--output-dir", out])
            seconds = time.perf_counter() - t0
        finally:
            nonmyopic._rank_main = real
        gaps = None
        for metric in ("times", "gaps", "observations"):
            row = _check_csv(os.path.join(out, "hartmann6d", f"rollout_h{horizon}_{metric}.csv"),
                             budget, gaps=metric == "gaps")
            gaps = row if metric == "gaps" else gaps
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as fh:
                (trial,) = json.load(fh)
            want = horizon * sum(i + 1 for i in trial["sga_iterations"]) + sum(trial["fallbacks"])
            if trial["launches"] != want:
                raise AssertionError(f"CLI rank {r}: {trial['launches']} kernel launches, not "
                                     f"{want} = {horizon} x sum(SGA iterations + 1) + fallbacks")
            ranks.append(trial)
        if ranks[0]["X"] != ranks[1]["X"]:
            raise AssertionError("CLI ranks sampled different points")
        print(f"non-myopic CLI, --nworkers 2 --backend gloo (2 ranks sharing cuda:0), "
              f"hartmann6d, h {horizon}, 8 restarts (4 per rank) x 200 trajectories, budget "
              f"{budget}: final gap {gaps[-1]:.4f}, SGA iterations "
              f"{ranks[0]['sga_iterations']}, fallbacks {sum(ranks[0]['fallbacks'])}; "
              + "; ".join(f"rank {r}: {t['launches']} kernel launches, acquisition median "
                          f"{statistics.median(t['times']):.4f} s, trial {t['seconds']:.2f} s"
                          for r, t in enumerate(ranks))
              + f"; CLI wall {seconds:.2f} s; on {card}")

        if n_cards >= 2:
            _bench_mc_workers(tmp, card)


def _bench_mc_workers(tmp, card):
    """Two processes of the multi-process worker, NCCL on two cards, with
    its sharded_simulate_mc timing (200 trajectories per rank)."""
    init = f"file://{os.path.join(tmp, 'worker-store')}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rollout_bo_tpu_torch.parallel.multihost_worker",
         "--process-id", str(i), "--num-processes", "2", "--port", "0", "--init-method",
         init, "--bench-mc", "200"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    try:
        outputs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, o) in enumerate(zip(procs, outputs)):
        if p.returncode != 0 or f"[p{i}] OK" not in o:
            raise AssertionError(f"worker {i} failed:\n{o}")
    print("multihost_worker, NCCL on 2 cards: " + " | ".join(
        line for o in outputs for line in o.splitlines() if "bench_mc" in line or "winner" in line)
        + f"; on {card}")


# --------------------------------------------------------------------------
# phase 11: the notebook-analog examples and the FD problems on the card
# --------------------------------------------------------------------------


def _fd_problems():
    """tests/test_torch_fd.py, whose `PROBLEMS` the card runs here (that file
    imports no jax)."""
    return _tests_module("test_torch_fd.py", "torch_fd_problems")


def _run_example(mod, argv):
    """mod.main(argv) with its printed lines held back: (its result, wall
    seconds to a synchronized end, kernel launches besides the warm-up runs
    of the programs it captures, simulate calls), the counts set to 0 just
    before the run and read just after."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.rollout import mc
    from rollout_bo_tpu_torch.utils import graphs

    simulate, calls = mc.simulate_trajectory_mc, []

    def counted(*args, **kw):
        calls.append(1)
        return simulate(*args, **kw)

    torch.cuda.synchronize()
    mc.simulate_trajectory_mc = counted
    nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = mod.main(argv)
        torch.cuda.synchronize()
    finally:
        mc.simulate_trajectory_mc = simulate
    launches = nl.LAUNCHES - (graphs.WARMUP_LAUNCHES - warm0)
    return out, time.perf_counter() - t0, launches, len(calls)


def phase_examples(dev, card):
    """The six examples at their default widths, each with its own gates and
    launch identity; then the FD problems of tests/test_torch_fd.py through
    the kernel in float64."""
    from rollout_bo_tpu_torch.examples import (derivs_ei, explanatory, fantasy_conditioning,
                                               laplace_approximation, overview, rollout_bo)

    t_phase = time.perf_counter()
    on_card = ["--device", str(dev)]

    out, s, n, _ = _run_example(derivs_ei, on_card)
    if n != 0 or not out["worst"] <= 1e-5:
        raise AssertionError(f"derivs_ei: {n} launches, worst relative error {out['worst']}")
    print(f"example derivs_ei: {s:.3f} s, {n} kernel launches, 17 checks, worst relative "
          f"error against centered FD {out['worst']:.3e} (gate 1e-5)")

    out, s, n, _ = _run_example(fantasy_conditioning, on_card)
    s0, s1 = out["reset_sigmas"]
    if n != 0 or not abs(s0 - s1) < 1e-12:
        raise AssertionError(f"fantasy_conditioning: {n} launches, reset {s0} vs {s1}")
    print(f"example fantasy_conditioning: {s:.3f} s, {n} kernel launches, rank-1 condition "
          f"{out['condition_s'] * 1e3:.4f} ms against a refit {out['refit_s'] * 1e3:.4f} ms "
          f"(CUDA events, capacity 64, n 24, d 4, h 8), reset restores sigma {s1:.6f} "
          f"(|diff| {abs(s0 - s1):.1e}); on {card}")

    out, s, n, _ = _run_example(laplace_approximation, on_card)
    if n != 0 or not math.isfinite(out["peak_mb"]):
        raise AssertionError(f"laplace_approximation: {n} launches, peak {out['peak_mb']}")
    print(f"example laplace_approximation: {s:.3f} s, {n} kernel launches, "
          f"{out['episodes']} episodes in {out['wall_s']:.4f} s "
          f"({out['us_per_episode']:.2f} us per episode, float32), peak device memory "
          f"{out['peak_mb']:.3f} MB of which {out['allocated_before_mb']:.3f} MB allocated "
          f"before the sweeps, one fantasy state {out['fantasy_state_bytes']} B; on {card}")

    out, s, n, _ = _run_example(overview, on_card)
    if n != 15 or out["gaps"].shape != (15,) or not np.all(np.diff(out["gaps"]) >= 0.0):
        raise AssertionError(f"overview: {n} kernel launches (not 1 per BO iteration of "
                             f"15), gaps {out['gaps']}")
    print(f"example overview: {s:.3f} s, {n} kernel launches (1 per BO iteration), "
          f"myopic EI on gramacylee budget 15, final gap {out['final_gap']:.4f}; on {card}")

    out, s, n, calls = _run_example(explanatory, on_card)
    horizon = 2
    if calls != 3 or n != horizon * calls:
        raise AssertionError(f"explanatory: {n} kernel launches for {calls} simulate calls "
                             f"(not {horizon} per call, 3 calls)")
    cpu, s_cpu, _, _ = _run_example(explanatory, ["--device", "cpu"])
    rows, cpu_rows = out["rows"], cpu["rows"]
    d_alpha = float(np.abs(rows[:, 1] - cpu_rows[:, 1]).max())
    d_grad = float(np.abs(rows[:, 2] - cpu_rows[:, 2]).max())
    if abs(out["fd_agree"] - cpu["fd_agree"]) > 2:
        raise AssertionError(f"explanatory: {out['fd_agree']} rows agree with FD on the "
                             f"card, {cpu['fd_agree']} on the CPU route")
    print(f"example explanatory: {s:.3f} s, {n} kernel launches ({calls} simulate calls x "
          f"h {horizon}), rows agreeing with FD (|g - fd| <= 5e-3 |fd| + 5e-6): card "
          f"{out['fd_agree']} of {len(rows)}, CPU route {cpu['fd_agree']} of "
          f"{len(cpu_rows)} ({s_cpu:.3f} s); card vs CPU route max |d alpha| "
          f"{d_alpha:.3e}, max |d grad| {d_grad:.3e}; max relative |adjoint - FD| over "
          f"active rows {out['max_rel_active']:.3e}; on {card}")

    out, s, n, calls = _run_example(rollout_bo, on_card)
    (i, k), err = out["adjoint_path"], out["adjoint_rel_err"]
    if not (out["adjoint_case3_interior"] and err <= 1e-7):
        raise AssertionError(f"rollout_bo: dual back-substitution vs autograd, path "
                             f"{(i, k)}, improving interior {out['adjoint_case3_interior']}, "
                             f"relative error {err:.3e} (gate 1e-7)")
    print(f"example rollout_bo: {s:.3f} s, {n} kernel launches over {calls} simulate calls "
          f"and the BO loops, dual back-substitution vs autograd {err:.3e} relative "
          f"(probe {out['probe'][i]}, z[{k}]), SGA {out['sga_iterations']} iterations, "
          f"final gaps rollout {out['gaps_rollout'][-1]:.4f} / myopic "
          f"{out['gaps_myopic'][-1]:.4f}, BO SGA iterations "
          f"{out['sga_iterations_bo'].tolist()}; on {card}")

    _fd_checks(dev)
    torch.cuda.synchronize()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


def _fd_checks(dev):
    """The FD problems of tests/test_torch_fd.py through the kernel on `dev`."""
    from rollout_bo_tpu_torch.ops import newton_lanes as nl

    # Each problem on the card: the gradient against the JAX test's centered
    # difference at u0, at the JAX test's eps and tolerance: the gate. Beside
    # it, as diagnostics, the mean of 11 such differences at points 1e-7
    # apart (`averaged_fd`) and the function's rounding floor (`jitter`),
    # which one difference carries as ~sqrt(2) jitter / (2 eps) of slope.
    # On the MC 1-D problems the card's floor is also held to 3x the CPU
    # route's on the same problem: the lane solver's Li form, whose floor
    # is the JAX package's (tests/test_torch_value_floor.py holds the CPU
    # route to that).
    fd_mod, missed = _fd_problems(), []
    floor_problems = ("MC 1-D, h 1", "MC 1-D, h 2")
    for label, problem in fd_mod.PROBLEMS.items():
        torch.cuda.synchronize()
        nl.LAUNCHES = 0
        res = problem(dev)
        torch.cuda.synchronize()
        n = nl.LAUNCHES
        mean_fd, floor = fd_mod.averaged_fd(res), fd_mod.jitter(res)
        close = lambda fd: bool(np.allclose(res.grad, fd, rtol=res.rtol,  # noqa: E731
                                            atol=res.atol))
        ratio = lambda fd: np.divide(res.grad, fd, out=np.full_like(res.grad, np.nan),  # noqa: E731
                                     where=fd != 0.0)
        floor_note, floor_ok = "", True
        if label in floor_problems:
            cpu_floor = fd_mod.jitter(problem(torch.device("cpu")))
            floor_ok = floor <= 3.0 * cpu_floor
            floor_note = (f" (CPU route {cpu_floor:.2e}: {floor / cpu_floor:.2f}x, "
                          f"{'within' if floor_ok else 'OUTSIDE'} 3x)")
        print(f"FD on the card, {label}: gradient {res.grad}; one centered difference "
              f"{res.fd}, ratio {ratio(res.fd)}, {'within' if close(res.fd) else 'OUTSIDE'} "
              f"rtol {res.rtol:g} / atol {res.atol:g}; mean of 11 {mean_fd}, ratio "
              f"{ratio(mean_fd)}, {'within' if close(mean_fd) else 'OUTSIDE'}; "
              f"{n} kernel launches; the function's jitter {floor:.2e}{floor_note}, one "
              f"difference's noise ~{math.sqrt(2.0) * floor / (2 * res.eps):.2e} of slope")
        if n == 0 or not res.branch or not close(res.fd) or not floor_ok:
            missed.append(label)
    if missed:
        raise AssertionError(f"FD problems outside the JAX tests' tolerances (or not "
                             f"through the kernel, off their branch, or above 3x the CPU "
                             f"route's rounding floor) on the card: {missed}")


# --------------------------------------------------------------------------
# phase 12: the measurement entry points, as a user runs them
# --------------------------------------------------------------------------


def _run_entry_point(args, timeout):
    """`python3 <args>` from the repository root; its stdout lines and wall
    seconds. A non-zero exit raises with the end of its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines(), time.perf_counter() - t0


def _listed(lines, prefix):
    """The first [...] list on the line that starts with `prefix`."""
    line = next(ln for ln in lines if ln.startswith(prefix))
    return json.loads(line[line.index("["):line.index("]") + 1])


def phase_measurement(card):
    t_phase = time.perf_counter()
    lines, wall = _run_entry_point(["bench_torch.py"], 600)
    bench = json.loads(lines[-1])
    its = _listed(lines, "SGA iterations per acquisition")
    launches = _listed(lines, "lane-kernel launches per acquisition")
    if (list(bench) != ["metric", "value", "unit", "vs_baseline"]
            or bench["metric"] != "trid10d_h3_rollout_acq_opt_seconds_per_iter"
            or not math.isfinite(bench["value"]) or bench["value"] <= 0):
        raise AssertionError(f"bench_torch.py's last line is not bench.py's: {lines[-1]}")
    if launches != [3 * (i + 1) for i in its]:
        raise AssertionError(f"bench_torch.py: launches {launches} != 3 x ({its} + 1)")
    print(f"bench_torch.py: {bench['value']:.4f} s per acquisition (median; "
          f"{', '.join(f'{t:.4f}' for t in _listed(lines, 'seconds per acquisition'))} s), "
          f"vs_baseline {bench['vs_baseline']:.1f}x; SGA iterations {its}, lane-kernel "
          f"launches {launches}; {wall:.1f} s wall; on {card}")
    for prefix in ("eager route:", "program:"):
        print(f"  bench_torch.py {next(ln for ln in lines if ln.startswith(prefix))}")

    lines, wall = _run_entry_point(["scripts/throughput_torch.py"], 600)
    tput = json.loads(lines[-1])
    if (tput["mc_per_call"] != 4096 or tput["horizon"] != 3 or tput["backend"] != "cuda"
            or tput["lane_kernel_launches_per_call"] != 3
            or not (math.isfinite(tput["value"]) and tput["value"] > 0)):
        raise AssertionError(f"scripts/throughput_torch.py: {lines[-1]}")
    print(f"scripts/throughput_torch.py: {tput['value']:.1f} trajectories/s/card "
          f"({tput['mc_per_call']} trajectories, h {tput['horizon']}, with gradients: "
          f"{tput['seconds_per_call'] * 1e3:.2f} ms per call, median of 5; "
          f"{tput['lane_kernel_launches_per_call']:g} lane-kernel launches per call of "
          f"{tput['lane_kernel_lanes']} lanes, "
          f"{', '.join(f'{t:.3f}' for t in tput['lane_kernel_ms'])} ms against bounds of "
          f"{', '.join(f'{t:.4f}' for t in tput['lane_kernel_bound_ms'])} ms (by "
          f"{tput['lane_kernel_bound_by']}), the starts ran "
          f"{', '.join(f'{r:.2f}' for r in tput['lane_kernel_iterations_run'])} iterations "
          f"on average); {wall:.1f} s wall; on {card} (before the float32 kernel's fixed-point "
          f"stop: {_RECORDED['throughput']})")
    for prefix in ("eager route:", "program:"):
        print(f"  scripts/throughput_torch.py "
              f"{next(ln for ln in lines if ln.startswith(prefix))}")

    with tempfile.TemporaryDirectory(prefix="profile_bench_torch-") as tmp:
        lines, wall = _run_entry_point(["scripts/profile_bench_torch.py", "--outdir", tmp], 900)
    prof = json.loads(lines[-1])
    eager = json.loads(next(ln for ln in lines if ln.startswith("eager route:"))
                       .split(":", 1)[1])
    lane = [i for i, k in enumerate(prof["top"]) if "newton_lanes_kernel" in k["name"]]
    if not (prof["busy_share"] is not None and 0.0 < prof["busy_share"] <= 1.0) or not lane:
        raise AssertionError(f"scripts/profile_bench_torch.py: busy share "
                             f"{prof['busy_share']}, lane kernel among the top kernels: "
                             f"{bool(lane)}")
    k = prof["top"][lane[0]]
    print(f"scripts/profile_bench_torch.py: {prof['ms_per_step']:.2f} ms per SGA step "
          f"({prof['traced_ms_per_step']:.2f} traced), device busy {prof['busy_share']:.4f} "
          f"of the {prof['window_ms']:.1f} ms traced window, {prof['launches']} kernels of "
          f"{prof['device_ms']:.2f} ms over {prof['steps']} steps "
          f"({prof['device_ms_over_untraced_wall']:.4f} "
          f"of the untraced steps' wall); the lane kernel #{lane[0] + 1} by device "
          f"time ({k['ms']:.2f} ms, {k['count']}x); {wall:.1f} s wall; on {card}")
    for i, k in enumerate(prof["top"][:8]):
        print(f"  {i + 1}. {k['ms']:8.2f} ms {k['count']:6d}x  {k['name'][:100]}")
    print(f"  eager route: {eager['ms_per_step']:.2f} ms per SGA step "
          f"({eager['traced_ms_per_step']:.2f} traced), device busy {eager['busy_share']:.4f} "
          f"of the {eager['window_ms']:.1f} ms traced window, {eager['launches']} kernels of "
          f"{eager['device_ms']:.2f} ms ({eager['device_ms_over_untraced_wall']:.4f} of the "
          f"untraced steps' wall)")
    print("  " + next(ln for ln in lines if ln.startswith("program:")))
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 13: the SGA programs (CUDA graphs) against the eager loop
# --------------------------------------------------------------------------


def _graph_numbers(program):
    """(captures, capture seconds, memory-pool bytes) of a program's graphs."""
    gs = program.graphs
    return (sum(g.captures for g in gs), sum(g.capture_seconds for g in gs),
            sum(g.pool_bytes for g in gs))


def _routes_at_bench_width(dev, card, dtype, reps=3):
    """bench.py's acquisition in the eager loop and through the fused
    program: a warm-up of each (the program's capture), then `reps` rounds
    in turns, each on a new stream tensor. Both routes run the same
    kernels at the same shapes on one card, so the gate is bit for bit:
    the same SGA iterations, winner and value on every stream. Kernel
    launches 3 x (SGA iterations + 1) on both routes, on the program's
    first call besides its graphs' warm-up runs, and on every later call
    with none besides."""
    import bench_torch
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.ops import qmc
    from rollout_bo_tpu_torch.utils import graphs

    state, tp, xstarts, restarts = bench_torch.bench_problem(dev, dtype)
    d = tp.lbs.shape[0]
    program = bench_torch.fused_program(state, tp, xstarts)
    routes = {"eager": None, "program": program}
    seconds = {name: [] for name in routes}

    warm = 0

    def run(name, rnstream):
        nonlocal warm
        torch.cuda.synchronize()
        nl.LAUNCHES, warm0 = 0, graphs.WARMUP_LAUNCHES
        t0 = time.perf_counter()
        res = bench_torch.acquire(state, tp._replace(rnstream=rnstream), xstarts, restarts,
                                  program=routes[name])
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        warm += graphs.WARMUP_LAUNCHES - warm0
        if nl.LAUNCHES - (graphs.WARMUP_LAUNCHES - warm0) != 3 * (res.iterations + 1):
            raise AssertionError(f"programs, {dtype}, {name}: {nl.LAUNCHES} kernel launches "
                                 f"({graphs.WARMUP_LAUNCHES - warm0} warm-up) != 3 x "
                                 f"({res.iterations} + 1)")
        return res, s

    first = {name: run(name, tp.rnstream) for name in routes}
    if warm != graphs.WARMUP * 2 * 3:
        raise AssertionError(f"programs, {dtype}: {warm} warm-up launches, not "
                             f"{graphs.WARMUP} x 2 graphs x 3")
    captures, capture_s, pool = _graph_numbers(program)
    if captures != 2:
        raise AssertionError(f"programs, {dtype}: {captures} captures, not one per graph")
    its = []
    for r in range(reps):
        z = torch.tensor(qmc.gen_low_discrepancy_sequence(tp.mc_iters, d, tp.horizon + 1),
                         dtype=dtype, device=dev)
        out = {}
        for name in (list(routes) if r % 2 == 0 else list(routes)[::-1]):
            out[name], t = run(name, z)
            seconds[name].append(t)
        a, b = out["eager"], out["program"]
        if not (a.iterations == b.iterations and torch.equal(a.x, b.x)
                and torch.equal(a.value, b.value)):
            raise AssertionError(f"programs, {dtype}: the program's winner {b} is not the "
                                 f"eager loop's {a} bit for bit")
        its.append(b.iterations)
    if warm != graphs.WARMUP * 2 * 3:
        raise AssertionError(f"programs, {dtype}: warm-up launches after the capture")
    med = {name: statistics.median(v) for name, v in seconds.items()}
    print(f"programs, bench width ({dtype}, 8 restarts x 200 trajectories, h 3): eager "
          f"{med['eager']:.4f} s, program {med['program']:.4f} s per acquisition (median "
          f"of {reps} in turns: eager {', '.join(f'{t:.4f}' for t in seconds['eager'])}; "
          f"program {', '.join(f'{t:.4f}' for t in seconds['program'])}), first calls "
          f"eager {first['eager'][1]:.4f} s, program {first['program'][1]:.4f} s; winners "
          f"equal bit for bit on every stream; SGA iterations {its}, kernel launches "
          f"3 x (SGA iterations + 1) on both routes; capture {capture_s:.3f} s (2 graphs), "
          f"memory pools {pool} B, {warm} warm-up launches; on {card}")
    return dict(eager_s=med["eager"], program_s=med["program"], capture_s=capture_s,
                pool_bytes=pool)


def _nonmyopic_cli_routes(card, budget=3, horizon=2, extra=(), label="fused solver"):
    """One non-myopic trial through the CLI at phase 6's widths (`extra`
    arguments added), budget cut, through the program cache, then the same
    trial in the eager loop (`_eager_loops`: every program run eagerly):
    the program route takes one acquisition program, its two graphs
    captured once each (in this trial or an earlier one with its key), and
    one observe program, its MLE graph captured once; every capture of the
    route is in a cached program and the eager route captures nothing; the
    same points within 1e-9; the launch identity on both routes (for the
    solvers that count SGA iterations)."""
    from rollout_bo_tpu_torch.experiments import nonmyopic
    from rollout_bo_tpu_torch.ops import newton_lanes as nl
    from rollout_bo_tpu_torch.utils import graphs

    argv = ["--function-name", "hartmann6d", "--horizon", str(horizon), "--trials", "1",
            "--budget", str(budget), "--mc-samples", "200", "--batch-size", "8",
            "--sgd-iterations", "50", "--starts", "16", "--optimize",
            "--variance-reduction", "--seed", "1906", *extra]
    trials = {}
    for route in ("program", "eager"):
        captures, before = graphs.CAPTURES, _cached_captures()
        with tempfile.TemporaryDirectory() as out, contextlib.ExitStack() as stack:
            if route == "eager":
                stack.enter_context(_eager_loops())
            asked = stack.enter_context(_asked_programs())
            rec = stack.enter_context(_recording())
            nl.LAUNCHES = 0
            nonmyopic.main(argv + ["--output-dir", out])
            torch.cuda.synchronize()
        (trial,) = rec["trials"]
        res, acqs = trial["res"], trial["acquisitions"]
        for a in acqs:
            if a["iterations"] < 0:          # batch / Gauss-Hermite: no SGA count
                continue
            if a["launches"] != horizon * (a["iterations"] + 1) + a["fallback"]:
                raise AssertionError(f"non-myopic CLI, {label}, {route}: {a['launches']} "
                                     f"kernel launches for {a['iterations']} SGA iterations")
        if trial["launches"] != sum(a["launches"] for a in acqs):
            raise AssertionError(f"non-myopic CLI, {label}, {route}: kernel launches outside "
                                 "the acquisitions")
        counted = sum(n - before.get(k, 0) for k, n in _cached_captures().items())
        trials[route] = (trial, graphs.CAPTURES - captures, counted, asked)
    (prog_trial, captures, counted, asked), (eager_trial, eager_captures, *_) = (
        trials["program"], trials["eager"])
    acquisition, observe = _taken(asked, "nm_acquire"), _taken(asked, "nm_observe")
    if (len(acquisition) != 1 or [g.captures for g in acquisition[0].graphs] != [1, 1]
            or [p.captures for p in observe] != [1] or captures != counted
            or eager_captures != 0):
        raise AssertionError(f"non-myopic CLI, {label}: {len(acquisition)} acquisition "
                             f"programs taken, {captures} captures ({counted} in the cached "
                             f"programs; eager route {eager_captures}), not one acquisition "
                             "program's 2 graphs and one observe graph")
    apart = float(np.abs(prog_trial["res"].X - eager_trial["res"].X).max())
    if apart > 1e-9:
        raise AssertionError(f"non-myopic CLI, {label}: the program's points are {apart:.3e} "
                             "from the eager loop's")
    _, capture_s, pool = _graph_numbers(acquisition[0])
    line = ", ".join(
        f"{route} {t['seconds'] / budget:.4f} s per BO iteration (acquisitions "
        f"{', '.join(f'{x:.4f}' for x in t['res'].times)} s)"
        for route, (t, *_) in trials.items())
    print(f"programs, non-myopic CLI trial, {label} (hartmann6d, h {horizon}, 10 restarts, "
          f"float64, budget {budget}): {line}; acquisition program captured once "
          f"({capture_s:.3f} s, memory pools {pool} B), observe program once "
          f"({observe[0].capture_seconds:.3f} s, {observe[0].pool_bytes} B), points within "
          f"{apart:.1e} of the eager loop's, SGA iterations "
          f"{prog_trial['res'].sga_iterations.tolist()}; on {card}")
    return dict(capture_s=capture_s, pool_bytes=pool)


def phase_programs(dev, card):
    t_phase = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        _routes_at_bench_width(dev, card, dtype)
    _nonmyopic_cli_routes(card)
    _nonmyopic_cli_routes(card, budget=2, extra=("--outer-solver", "batch"),
                          label="batch solver")
    _nonmyopic_cli_routes(card, budget=1, extra=("--deterministic-solve", "--ghq-nodes", "8"),
                          label="Gauss-Hermite solver")
    for rule_name in ("EI", "Random"):
        _myopic_routes(dev, card, budget=4, rule_name=rule_name, chunks=(1, 4),
                       label="programs, myopic chunks of 1 and 4")
    _observe_routes(dev, card, cap=20, label="programs, the non-myopic width")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 14: the regret-parity sweep and its report
# --------------------------------------------------------------------------


def phase_parity_sweep(card):
    """scripts/parity_sweep_torch.py on two cells of its parity plan, each
    in a process of its own as the sweep runs them, then
    scripts/parity_report_torch.py on their output."""
    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import parity_report_torch as report
    import parity_sweep_torch as sweep

    from rollout_bo_tpu_torch.experiments import myopic

    plan = sweep.plan_cells("parity")
    cells = [dataclasses.replace(sweep.select(plan, ["sixhump:ei"])[0], trials=2),
             dataclasses.replace(sweep.select(plan, ["gramacylee:h1"])[0], trials=1)]
    with tempfile.TemporaryDirectory(prefix="parity_sweep_torch-") as out:
        if sweep.run(cells, out, "cuda") != 0:
            raise AssertionError("the parity sweep failed a cell (its output is above)")
        metrics = {"myopic": myopic.METRICS, "nonmyopic": ["times", "gaps", "observations"]}
        for cell in cells:
            for metric in metrics[cell.cli]:
                _check_csv(os.path.join(cell.directory(out), f"{cell.prefix}_{metric}.csv"),
                           cell.budget, gaps=metric == "gaps", trials=cell.trials)
        rows, text = report.report(out, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "results"))
        timing = {(r["function"], r["cell"]): r for r in report.timing_table(out)[0]}
    if len(rows) != 2 or len(timing) != 2:
        raise AssertionError(f"the report holds {len(rows)} gap rows and {len(timing)} "
                             "timing rows, not 2 and 2")
    for cell in cells:
        t = timing[cell.function, cell.label]
        if not t["launches_per_iter"] > 0:
            raise AssertionError(f"sweep cell {cell.function} {cell.label} launched no lane "
                                 "kernel")
        sga = (f", {t['sga_per_acq']:.2f} SGA iterations per acquisition (launches / h - 1)"
               if cell.cli == "nonmyopic" else "")
        print(f"parity sweep cell {cell.cli} {cell.function} {cell.label} ({cell.trials} "
              f"trial(s), budget {cell.budget}): {t['s_per_iter']:.4f} s per BO iteration "
              f"(median over iterations 2.. of each trial), {t['launches_per_iter']:.2f} "
              f"lane-kernel launches per BO iteration{sga}; the cell's process "
              f"{t['cell_seconds']:.1f} s; on {card}")
    for line in text.splitlines():
        if line and not line.startswith("card:"):
            print(f"  report: {line}")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 15: the MLE kernel
# --------------------------------------------------------------------------


def _autograd_mle(state, lb, ub, iterations=60, lr=0.1):
    """The MLE as the port ran it before the kernel: each Adam step autograd
    through the masked Cholesky of the whole capacity. A yardstick of time
    only; nothing on the path calls it."""
    from rollout_bo_tpu_torch.models import surrogate as sg

    state = sg._detached(state)
    log_lb, log_ub = torch.log(lb), torch.log(ub)
    lt = torch.clamp(torch.log(state.kernel.theta), log_lb, log_ub)
    m, v = torch.zeros_like(lt), torch.zeros_like(lt)
    for i in range(iterations):
        with torch.enable_grad():
            leaf = lt.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(-sg._ll_of_theta(torch.exp(leaf), state), leaf)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat, vhat = m / (1 - 0.9 ** (i + 1)), v / (1 - 0.999 ** (i + 1))
        lt = torch.clamp(lt - lr * mhat / (torch.sqrt(vhat) + 1e-8), log_lb, log_ub)
    return torch.exp(lt)


def _mle_args(dev, dtype, cap, n, kind="matern52", seed=5):
    """(kind, X, y, n, noise, theta, lb, ub) of one GP and its state:
    hartmann6d for matern52, else points in [-1, 1]^3 (1-D for periodic)."""
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    if kind == "matern52":
        f = testfns.get_function("hartmann6d")
        X = rng.uniform(f.lbs, f.ubs, (n, f.dim))
        y = f.batch(torch.tensor(X)).numpy()
    else:
        X = rng.uniform(-1.0, 1.0, (n, 1 if kind == "periodic" else 3))
        y = np.sin(2.0 * X[:, 0]) + 0.3 * X.sum(axis=1) ** 2
    theta = (0.8, 2.5) if kind == "periodic" else (0.7,)
    st = sg.fit(K.RBFKernel(torch.tensor(theta, dtype=dtype, device=dev), kind), X, y,
                capacity=cap, noise=1e-6 if dtype == torch.float64 else 1e-3, device=dev,
                dtype=dtype)
    bounds = [torch.full((len(theta),), b, dtype=dtype, device=dev) for b in (0.1, 5.0)]
    return (kind, st.X, st.y, st.n, st.noise, st.kernel.theta, *bounds), st


def phase_mle(dev, card):
    """The MLE kernel: build, checks against the plain version, times."""
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.ops import _build
    from rollout_bo_tpu_torch.ops import gp_mle
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs, profiling

    t_phase = time.perf_counter()
    _build.load("gp_mle")
    built = _build.build_seconds("gp_mle")
    print(f"phase 15: gp_mle.cu built in {built:.2f} s" if built is not None
          else "phase 15: gp_mle.cu cached")
    for line in _build.build_log("gp_mle").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    rtol = {torch.float64: 1e-12, torch.float32: 1e-5}
    rows = []
    for dtype in (torch.float64, torch.float32):
        above = 160 if dtype == torch.float64 else 240
        for cap, n in ((20, 5), (20, 19), (105, 5), (105, 55), (105, 105), (above, 150)):
            args, st = _mle_args(dev, dtype, cap, n)
            layout = gp_mle._layout(cap, st.dim, st.X.element_size(), 60)
            got = gp_mle.gp_mle(*args)
            want = gp_mle.gp_mle_ref(*args)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want.abs()).max())
            if not (torch.isfinite(got).all() and rel <= rtol[dtype]):
                raise AssertionError(f"gp_mle {dtype} cap {cap} n {n}: theta {got.tolist()} "
                                     f"against the plain version's {want.tolist()}")
            gp_mle.gp_mle(*args)
            ms, _ = _events_ms(lambda: gp_mle.gp_mle(*args), 5)
            flops, nbytes = gp_mle.mle_work(n, st.dim, 1, 60, st.X.element_size())
            bound_ms = 1e3 * max(flops / _PEAK_FLOPS[dtype], nbytes / _PEAK_BYTES)
            old = ""
            if dtype == torch.float64 and cap in (20, 105):
                _autograd_mle(st, args[6], args[7])
                old_ms, _ = _events_ms(lambda: _autograd_mle(st, args[6], args[7]), 2)
                old = f", the autograd loop {1e3 * old_ms:.1f} us (yardstick)"
            rows.append(dict(dtype=str(dtype), cap=cap, n=n, us=1e3 * ms, rel=rel,
                             bound_us=1e3 * bound_ms))
            print(f"gp_mle {str(dtype)[6:]} cap {cap} n {n} "
                  f"({'staged' if layout.staged else 'scratch buffer'}, {layout.smem} B "
                  f"shared): {1e3 * ms:.1f} us per launch ({1e3 * ms / 60:.2f} us a step), "
                  f"bound {1e3 * bound_ms:.3f} us ({100 * bound_ms / ms:.4f}%), theta "
                  f"{float(got[0]):.12g}, max rel to the plain version {rel:.2e}{old}")
    for kind in gp_mle.KINDS:
        args, _ = _mle_args(dev, torch.float64, 20, 12, kind=kind)
        got, want = gp_mle.gp_mle(*args), gp_mle.gp_mle_ref(*args)
        rel = float(((got - want).abs() / want.abs()).max())
        if rel > 1e-10 or torch.equal(want, args[5]):
            raise AssertionError(f"gp_mle {kind}: {got.tolist()} against {want.tolist()}")
        print(f"gp_mle {kind} float64 n 12 of 20: theta {got.tolist()}, max rel {rel:.2e}")
    # a myopic trial whose programs are cached: one launch per refit
    f = testfns.get_function("hartmann6d")
    kw = dict(budget=10, num_starts=64, device=dev,
              x_init=np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim)))
    graphs.PROGRAM_CACHE.clear()
    for _ in range(2):
        bo.run_myopic_bo(f, dr.EI(), **kw)
    rec = profiling.RECORDS[-1]
    if rec.captures or rec.mle_launches != sum(rec.refits) or not all(rec.refits):
        raise AssertionError(f"myopic trial: {rec.mle_launches} MLE launches for "
                             f"{sum(rec.refits)} refits ({rec.captures} captures)")
    print(f"myopic trial (hartmann6d, budget 10, cached programs): {rec.mle_launches} "
          f"gp_mle launches for {sum(rec.refits)} refits, {rec.lane_launches} lane-kernel "
          f"launches; on {card}")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return rows


_PHASES = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", type=int, nargs="+", default=list(_PHASES),
                   choices=_PHASES, help="phases to run after 1 (device) "
                   "and 2 (build); a partial run prints no closing lines")
    phases = set(p.parse_args(argv).phases)
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    torch.cuda.synchronize()
    if 3 in phases:
        bench = phase_kernel_checks(dev, smi)
    if 4 in phases:
        launches, _ = phase_main_path(dev, smi)
    if 5 in phases:
        phase_myopic_cli(dev, smi)
    if 6 in phases:
        phase_nonmyopic_cli(dev, smi)
    if 7 in phases:
        phase_card_equals_cpu(dev)
    if 8 in phases:
        phase_adaptive_cli(dev, smi)
    if 9 in phases:
        phase_cost_aware_cli(dev, smi)
    if 10 in phases:
        phase_sharded(smi)
    if 11 in phases:
        phase_examples(dev, smi)
    if 12 in phases:
        phase_measurement(smi)
    if 13 in phases:
        phase_programs(dev, smi)
    if 14 in phases:
        phase_parity_sweep(smi)
    if 15 in phases:
        mle_rows = phase_mle(dev, smi)
    torch.cuda.synchronize()
    if phases != set(_PHASES):
        print(f"partial run (phases {sorted(phases)}): no closing lines")
        return 0
    print(json.dumps({"kernels": [{
        "name": "newton_lanes",
        "route": "cuda",
        "source": "rollout_bo_tpu_torch/csrc/newton_lanes.cu",
        "replaces": "rollout_bo_tpu/ops/pallas_newton.py:654",
        "launches": launches,
        "max_abs_err": bench["max_abs_err"],
        "ms": bench["ms"],
        "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"],
        "library_ms": None,     # no single PyTorch call computes a multistart Newton solve
    }, {
        "name": "gp_mle",
        "route": "cuda",
        "source": "rollout_bo_tpu_torch/csrc/gp_mle.cu",
        "replaces": None,       # the JAX package runs its MLE as XLA ops
        "shapes": mle_rows,
        "library_ms": None,     # no single PyTorch call runs an Adam MLE of a GP
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
