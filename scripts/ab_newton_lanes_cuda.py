#!/usr/bin/env python3
"""Measurements of the Newton-lane CUDA kernel on one card, in one process.

    python3 scripts/ab_newton_lanes_cuda.py [--old-source PATH/newton_lanes.cu]
                                            [--variants]

The kernel is the package's `csrc/newton_lanes.cu` (a warp per (lane,
start); float32 lanes in the W = K^{-1} form; float64 lanes in the Li =
L^{-1} form; a lane's starts over several blocks when the lanes leave SMs
idle). `--old-source` adds an earlier source to compare it
with: that tree's `csrc/newton_lanes.cu`, built with the package's flags and
launched with that tree's own C signature and block shape
(`ops/newton_lanes.py` beside it: its `_block_shape`, `_ARGTYPES` and, from
the start blocks on, `_layout_args`), fed what the package's lanes read (W
in float32, Li in float64). Unpack the tree with `git archive <commit> |
tar -x -C build/parent`. Each kernel is timed on its launch alone, the
matrix it reads formed before the timed launches. The float32 arithmetic
is the same in both (a start that stops at its fixed point gives what all
its iterations give), so the float32 values must agree bit for bit: the
script exits 1 when they do not. It prints, per shape, the lanes whose
values differ, the largest difference, the argmax agreement of both
kernels with the plain version and the lanes on which each misses
criterion (a) of chip_smoke.py. `--variants` also times, at the BO loops'
two float64 shapes, the float64 kernel for d <= 8 built with other
register budgets (-DNEWTON_LI_MAXNREG8=128, 64 or 48; the package's is
56).

All builds start together. Then:
- per shape, the kernels run in turns (old, new, new, old), each turn the
  mean of `--reps` launches between two CUDA events after a warm-up launch:
  (i)   the bench shape: 1600 lanes of 13-15 trid10d points in capacity 24,
        d 10, 10 starts, 10 iterations, matern52 / EI, float32;
  (ii)  the same shape on lanes whose Newton steps move (lengthscale 0.8 in
        [-1, 1]^10), float32;
  (iii) d 16 (the kernel's maximum), float64: 64 lanes, and 1600 lanes;
  (iv)  the BO loops' shapes of chip_smoke.py phase 3, hartmann6d, float64,
        12 iterations: the myopic loop's (1 lane, n 104 of capacity 105, 64
        + 2 starts) and the non-myopic loop's (2000 lanes, n 6..21 of
        capacity 23, 16 + 2 starts);
  (v)   the regret ladder's float32 shapes (ackley2d at h 3: 8 restarts x 200
        trajectories = 1600 lanes, n 4..16 of capacity 20, d 2, 8 + 2
        starts, 12 iterations; the same at lengthscale 3, where most
        lanes' starts move; gramacylee: 2000 lanes, n 1..16 of capacity 20,
        d 1, lengthscale 0.15);
  (vi)  the throughput call's shape (4096 lanes of 13-15 trid10d points in
        capacity 24, d 10, 10 starts, 10 iterations, float32) and the myopic
        loop's shape in float32 (hartmann6d, `--dtype float32`: 1 lane, n
        104 of capacity 105, d 6, 64 + 2 starts, 12 iterations);
  with the layout (blocks, warps, start blocks, resident warps), the
  iterations the starts ran (a start stops at a fixed point), the work and
  the bound from `lane_solve_work` in the lanes' dtype counted from them
  (the fewest operations the function needs: both kernels' share is of
  it), the values against the old kernel's (in float32 bit for bit), the
  value floor (each kernel run on the same lanes cast
  to float32 and to float64: the largest |v - v64| over the lanes, v64 the
  plain version's value in float64), and the cycles per phase of a Newton
  iteration (a build with -DNEWTON_LANES_PROFILE: `clock64` around each
  phase on thread 0 of every warp, so the cycles include the waits on the
  SM's other warps);
- at the bench shape, the kernel with its blocks padded so that an SM holds
  only one or two of them (how far more resident warps still help);
- the compilers' register / stack / spill reports and the blocks an SM holds;
- how far criterion (b) of chip_smoke.py (the kernel's solution is never
  worse than the plain solver's beyond tolerance) depends on float32
  rounding: on chip_smoke's small float32 lanes, under several seeds and
  iteration counts, the lanes on which each float32 solver (the plain
  version, the kernels) trails another by more than (b) grants, in both
  directions, and against the plain version run in float64 on the same
  inputs; every point is valued by one float64 evaluation of the
  acquisition. For each lane that misses (b) at chip_smoke's own seed, the
  value of every start after every iteration, per solver (`--trace`);
- the kernel's launches inside one acquisition at the bench.py
  configuration (CUDA events around each wrapper call on the main path,
  then the kernel's device time by name from `torch.profiler`).
Results go to stdout and, with `--json PATH`, to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402  (the bench problem)
import chip_smoke  # noqa: E402  (the lanes, their timing and bounds)
from rollout_bo_tpu_torch.models import surrogate as sg  # noqa: E402
from rollout_bo_tpu_torch.models import testfns  # noqa: E402
from rollout_bo_tpu_torch.ops import _build  # noqa: E402
from rollout_bo_tpu_torch.ops import newton_lanes as nl  # noqa: E402
from rollout_bo_tpu_torch.ops import qmc  # noqa: E402

_PROFILE = ("-DNEWTON_LANES_PROFILE",)
_PHASES = ("passes, rule, active set", "Q strips (Li form: P = Li G, rows C)", "H entries",
           "Gershgorin + Cholesky", "directions", "candidates' values", "winner")
_SMOKE_SEED = 11


def build_old(source: Path):
    """nvcc on the earlier source, with the package's flags; and that tree's
    wrapper module (its `_block_shape` and `_ARGTYPES`)."""
    out = _build.BUILD_DIR / "newton_lanes-old.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    path = source.resolve().parent.parent / "ops" / "newton_lanes.py"
    spec = importlib.util.spec_from_file_location("old_newton_lanes", path)
    wrapper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wrapper)
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr, wrapper


def package_form(Li):
    """The matrix the kernels read: W in float32, Li in float64."""
    return nl._lane_matrix(Li)[0]


def solver(lib, wrapper=None):
    """A build's launch on Li arguments: the package's (`wrapper` None) or
    an earlier tree's.
    `prepare` (which forms the matrix the kernel reads) and `launch` split
    the two, so that a timing holds the launch alone, the same for every
    build."""
    def prepare(args):
        return args[:1] + (package_form(args[1]).contiguous(),) + args[2:]

    def launch(*args, **kw):
        return launch_with(lib, args, kw, wrapper=wrapper)

    def solve(*args, **kw):
        return launch(*prepare(args), **kw)

    solve.prepare, solve.launch = prepare, launch
    return solve


def launch_with(lib, args, kw, smem=None, *, wrapper=None):
    """The wrapper's launch on another build (`lib`), or with more dynamic
    shared memory than the layout needs (`smem`); with `wrapper`, an
    earlier tree's launch (its block shape and
    C signature). The lanes' second argument is the matrix the kernel reads
    (`solver`)."""
    X, M, c, n, fmini, th0, ell, lbs, ubs, xstarts, period = args
    dt, dev = X.dtype, X.device
    L, cap, d = X.shape
    S = xstarts.shape[0]
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    params = torch.stack([as_t(ell).reshape(()), as_t(period).reshape(())])
    xout = torch.empty((L, d), dtype=dt, device=dev)
    vout = torch.empty((L,), dtype=dt, device=dev)
    fn = getattr(lib, nl._ENTRY[dt])
    head = (X.data_ptr(), M.data_ptr(), c.data_ptr(), n.data_ptr(), fmini.data_ptr(),
            th0.data_ptr(), params.data_ptr(), lbs.data_ptr(), ubs.data_ptr(),
            xstarts.data_ptr(), xout.data_ptr(), vout.data_ptr())
    shape = (cap, d, S, kw["iterations"], nl._KIND_IDS[kw["kind"]], nl._RULE_IDS[kw["rule"]])
    tail = (1e-8, 1e-10, 1e-8, kw.get("f_tol", 0.0), kw.get("x_tol", 0.0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if wrapper is not None and not hasattr(wrapper, "_layout_args"):
        # a tree before start blocks: (lanes, groups, stage_m, smem), no part
        lanes, groups, stage_m, need = wrapper._block_shape(cap, d, S, X.element_size())
        fn.argtypes, fn.restype = wrapper._ARGTYPES, ctypes.c_int
        err = fn(*head, L, *shape, lanes, groups, int(stage_m), *tail,
                 need if smem is None else smem, stream)
    else:
        mod = wrapper or nl
        layout = mod._block_shape(cap, d, S, X.element_size(), L, sms=nl._sm_count(dev.index))
        part = torch.empty((L, layout.start_blocks, d + 2), dtype=dt, device=dev)
        fn.argtypes, fn.restype = mod._ARGTYPES, ctypes.c_int
        err = fn(*head, part.data_ptr(), None, L, *shape, *mod._layout_args(layout), *tail,
                 layout.smem if smem is None else smem, stream)
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")
    return xout, vout


def phase_cycles(args, kw, runs=None):
    """Mean cycles per (lane, start, iteration) in each phase (iterations as
    run: `runs`, where the kernel stops starts early)."""
    lib = _build.load("newton_lanes", _PROFILE)
    buf = (ctypes.c_ulonglong * 8)()
    lib.newton_lanes_phase_cycles(buf)              # sets the counts to 0
    solver(lib)(*args, **kw)
    torch.cuda.synchronize()
    lib.newton_lanes_phase_cycles(buf)
    solves = (args[0].shape[0] * args[9].shape[0] * kw["iterations"] if runs is None
              else int(runs.sum()))
    return {name: buf[i] / solves for i, name in enumerate(_PHASES)}


def residency_times(args, kw, reps):
    """ms per launch with 1, 2, ... blocks resident per SM: the dynamic
    shared memory is padded until only that many fit."""
    lib = nl._library()
    X, S = args[0], args[9].shape[0]
    layout = nl._block_shape(X.shape[1], X.shape[2], S, X.element_size(), X.shape[0])
    threads, smem = layout.threads, layout.smem
    occupancy = lambda nbytes: lib.newton_lanes_blocks_per_sm(
        X.element_size(), X.shape[2], int(layout.stage_m), threads, nbytes)
    most = occupancy(smem)
    out = {}
    for blocks in range(1, most + 1):
        padded = smem if blocks == most else max(smem, nl._SMEM_LIMIT // (blocks + 1) + 4096)
        got = occupancy(padded)
        solve = lambda *a, **k: launch_with(
            lib, a[:1] + (package_form(a[1]),) + a[2:], k, padded)
        out[f"{got} blocks ({got * threads // 32} warps) per SM"] = \
            time_turns({"new": solve}, ["new"], args, kw, reps)[0][1]
    return out


def ptxas_lines(log):
    keep = []
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            keep.append(line.strip())
    return keep


def shapes(dev):
    """name -> (lane arguments, keywords, active counts)."""
    out = {}
    f = testfns.get_function("trid10d")
    bench_lanes = {13: 534, 14: 533, 15: 533}

    def pack(st, lo, hi, dt, starts=8, iterations=10):
        t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
        th0 = torch.zeros(st.X.shape[0], dtype=dt, device=dev)
        args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), th0, st.kernel.theta[0],
                t(lo), t(hi), t(qmc.generate_initial_guesses(starts, lo, hi)),
                torch.ones((), dtype=dt, device=dev))
        return args, dict(kind="matern52", rule="EI", iterations=iterations), st.n.tolist()

    st = chip_smoke._lane_state(bench_lanes, f.dim, 24, "matern52", (1.0,), f.lbs, f.ubs,
                                torch.float32, dev, 7, f=f)
    out["bench f32 (1600 lanes, cap 24, d 10, S 10)"] = pack(st, f.lbs, f.ubs, torch.float32)
    st = chip_smoke._lane_state({13: 1366, 14: 1365, 15: 1365}, f.dim, 24, "matern52", (1.0,),
                                f.lbs, f.ubs, torch.float32, dev, 7, f=f)
    out["throughput f32 (4096 lanes, cap 24, d 10, S 10)"] = pack(st, f.lbs, f.ubs,
                                                                  torch.float32)
    lo, hi = np.full(10, -1.0), np.full(10, 1.0)
    st = chip_smoke._lane_state(bench_lanes, 10, 24, "matern52", (0.8,), lo, hi,
                                torch.float32, dev, 5)
    out["moving d10 f32 (1600 lanes, cap 24, S 10)"] = pack(st, lo, hi, torch.float32)
    lo, hi = np.full(16, -1.0), np.full(16, 1.0)
    st = chip_smoke._lane_state({9: 32, 15: 32}, 16, 24, "matern52", (0.8,), lo, hi,
                                torch.float64, dev, 5)
    out["d16 f64 (64 lanes, cap 24, S 10)"] = pack(st, lo, hi, torch.float64)
    st = chip_smoke._lane_state({9: 800, 15: 800}, 16, 24, "matern52", (0.8,), lo, hi,
                                torch.float64, dev, 5)
    out["d16 f64 (1600 lanes, cap 24, S 10)"] = pack(st, lo, hi, torch.float64)
    f = testfns.get_function("hartmann6d")
    for name, sizes, cap, starts in (
            ("myopic f64 (1 lane, n 104 of cap 105, d 6, S 66)", {104: 1}, 105, 64),
            ("non-myopic f64 (2000 lanes, n 6..21 of cap 23, d 6, S 18)",
             {6: 500, 12: 500, 17: 500, 21: 500}, 23, 16)):
        st = chip_smoke._lane_state(sizes, f.dim, cap, "matern52", (0.6,), f.lbs, f.ubs,
                                    torch.float64, dev, 17, f=f)
        out[name] = pack(st, f.lbs, f.ubs, torch.float64, starts, 12)
    f = testfns.get_function("ackley2d")
    st = chip_smoke._lane_state({4: 400, 8: 400, 12: 400, 16: 400}, f.dim, 20, "matern52",
                                (0.6,), f.lbs, f.ubs, torch.float32, dev, 23, f=f)
    out["ladder f32 (ackley2d h 3: 1600 lanes, n 4..16 of cap 20, d 2, S 10)"] = pack(
        st, f.lbs, f.ubs, torch.float32, 8, 12)
    # the same at lengthscale 3, where most lanes' Newton steps move
    st = chip_smoke._lane_state({4: 400, 8: 400, 12: 400, 16: 400}, f.dim, 20, "matern52",
                                (3.0,), f.lbs, f.ubs, torch.float32, dev, 23, f=f)
    out["ladder f32, moving (ackley2d, lengthscale 3: 1600 lanes, n 4..16 of cap 20, d 2, "
        "S 10)"] = pack(st, f.lbs, f.ubs, torch.float32, 8, 12)
    # gramacylee at lengthscale 0.15 (chip_smoke.py phase 3's first gramacylee
    # lanes: its 16 random points in [0.5, 2.5] leave K on a few lanes in a
    # thousand too ill-conditioned for the float32 W form, in the plain
    # version too)
    f = testfns.get_function("gramacylee")
    st = chip_smoke._lane_state({1: 400, 4: 400, 8: 400, 12: 400, 16: 400}, f.dim, 20,
                                "matern52", (0.15,), f.lbs, f.ubs, torch.float32, dev, 23, f=f)
    out["ladder f32 (gramacylee: 2000 lanes, n 1..16 of cap 20, d 1, S 10)"] = pack(
        st, f.lbs, f.ubs, torch.float32, 8, 12)
    f = testfns.get_function("hartmann6d")
    st = chip_smoke._lane_state({104: 1}, f.dim, 105, "matern52", (0.6,), f.lbs, f.ubs,
                                torch.float32, dev, 17, f=f)
    out["myopic f32 (1 lane, n 104 of cap 105, d 6, S 66)"] = pack(
        st, f.lbs, f.ubs, torch.float32, 64, 12)
    return out


def time_turns(solvers, order, args, kw, reps):
    """ms per launch for each turn of `order` (names into `solvers`)."""
    turns = []
    for name in order:
        solve, run_args = solvers[name], args
        prepare = getattr(solve, "prepare", None)
        if prepare is not None:           # W formed outside the timed launches
            solve, run_args = solve.launch, prepare(args)
        fn = lambda: solve(*run_args, **kw)
        fn()
        torch.cuda.synchronize()
        ms, _ = chip_smoke._events_ms(fn, reps)
        turns.append((name, ms))
    return turns


# --------------------------------------------------------------------------
# criterion (b) under float32 rounding
# --------------------------------------------------------------------------


def _as_f64(args):
    return _cast(args, torch.float64)


def _cast(args, dt):
    return tuple(a.to(dt) if torch.is_tensor(a) and a.is_floating_point() else a
                 for a in args)


def value_floor(solvers, args, kw):
    """Per solver and dtype (float32, float64): the largest |v - v64| over
    the lanes, each solver run on the lanes cast to that dtype, v64 the
    plain version's value in float64 (equal infinities count as 0)."""
    _, v64 = nl.newton_solve_lanes_ref(*_as_f64(args), **kw)
    out = {}
    for dt in (torch.float32, torch.float64):
        cast = _cast(args, dt)
        for name, solve in solvers.items():
            v = solve(*cast, **kw)[1].double()
            out[f"{name} {str(dt).split('.')[1]}"] = float(
                torch.where(v == v64, 0.0, (v - v64).abs()).max())
    return out


def acquisition_f64(args, kw, x):
    """The acquisition at one point per lane, x (L, d), from the lane
    arguments in float64: the one yardstick for every solver's points, on
    the matrix the lanes' dtype reads (float32: W as formed in float32)."""
    M, li = nl._lane_matrix(args[1])
    X, M, c, n, fmini, th0, ell, _, _, _, period = _as_f64(args[:1] + (M,) + args[2:])
    kind, cap = kw["kind"], X.shape[1]
    ml = (torch.arange(cap, device=X.device) < n[:, None]).double()[:, None]
    zero = torch.zeros((), dtype=torch.float64, device=X.device)
    k0 = nl._profile_terms(kind, zero, zero, ell, period)[0]
    mu, sigma = nl._posterior_value(x.double()[:, None], X[:, None], M[:, None], li,
                                    c[:, None], ml, kind, ell, period, k0, 1e-10)
    v = nl.rule_value(kw["rule"], mu, sigma, th0[:, None], fmini[:, None], 1e-8)[:, 0]
    return torch.where(torch.isfinite(v), v, -torch.inf)


def misses_a(args, kw, x, v):
    """Lanes on which a float32 solver's value v misses chip_smoke's criterion
    (a) at its point x: |v - acq(x)| > 2e-3 |acq(x)| + 1e-5 max(1, |acq(x)|)
    (2e-3 in place of 1e-5 for the Log rules), acq the acquisition in the Li
    form in the lanes' dtype, as the surrogate evaluates it."""
    X, Li, c, n, fmini, th0, ell, _, _, _, period = args
    kind, cap = kw["kind"], X.shape[1]
    ml = (torch.arange(cap, device=X.device) < n[:, None]).to(X.dtype)[:, None]
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    k0 = nl._profile_terms(kind, zero, zero, ell, period)[0]
    mu, sigma = nl._posterior_value(x[:, None], X[:, None], Li[:, None], True, c[:, None], ml,
                                    kind, ell, period, k0, 1e-10)
    acq = nl.rule_value(kw["rule"], mu, sigma, th0[:, None], fmini[:, None], 1e-8)[:, 0]
    atol = 2e-3 if kw["rule"].startswith("Log") else 1e-5
    return int(((v - acq).abs() > 2e-3 * acq.abs() + atol * acq.abs().clamp(min=1.0)).sum())


def _small_cases(dev, seed):
    """chip_smoke's small float32 lanes: (label, lane arguments, keywords)
    for every kernel kind x rule, 64 lanes each."""
    d, cap, dt = 3, 12, torch.float32
    lo, hi = np.full(d, -1.0), np.full(d, 1.0)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    xs = t(qmc.generate_initial_guesses(6, lo, hi))
    for kind in nl.SUPPORTED_KINDS:
        theta = (0.9, 3.0) if kind == "periodic" else (0.8,)
        try:
            st = chip_smoke._lane_state({3: 16, 6: 16, 9: 16, 12: 16}, d, cap, kind, theta,
                                        lo, hi, dt, dev, seed)
        except torch.linalg.LinAlgError:
            print(f"  seed {seed}, {kind}: no float32 fit (not positive definite), left out")
            continue
        kth = st.kernel.theta
        period = kth[1] if kind == "periodic" else torch.ones_like(kth[0])
        for name in nl.SUPPORTED_RULES:
            th0 = torch.full((64,), 0.5 if name == "LCB" else 0.0, dtype=dt, device=dev)
            yield (f"{kind}/{name}",
                   (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), th0, kth[0], t(lo),
                    t(hi), xs, period), dict(kind=kind, rule=name))


def _trails(va, vb):
    """Lanes on which a point of value va trails one of value vb by more
    than chip_smoke's criterion (b) grants in float32."""
    slack = chip_smoke._TOL[torch.float32]["worse"] * vb.abs().clamp(min=1.0) + 1e-6
    return va < vb - slack


def criterion_b_counts(solvers, dev, seeds, iterations, trace):
    """Per seed and iteration count, over the 25 x 64 small float32 lanes:
    how many lanes each float32 solver trails the plain float32 version on
    (and the reverse; `where_determined`: only lanes on which the plain
    version's float32 and float64 runs are within the same tolerance of
    each other, either way), and how many it trails the plain float64
    version on. With `trace`, prints every start's value after every iteration for
    the lanes that a kernel trails the plain float32 version on at
    chip_smoke's seed."""
    plain = lambda *a, **k: nl.newton_solve_lanes_ref(*a, **k)
    out = {}
    for seed in seeds:
        for iters in iterations:
            count = {k: dict(trails_plain32=0, where_determined=0, plain32_trails=0,
                             trails_plain64=0) for k in solvers}
            count["plain32"] = dict(trails_plain64=0)
            for label, args, kw in _small_cases(dev, seed):
                kw = dict(kw, iterations=iters)
                v32 = acquisition_f64(args, kw, plain(*args, **kw)[0])
                v64 = acquisition_f64(args, kw, chip_smoke._plain64(args, kw)[0])
                count["plain32"]["trails_plain64"] += int(_trails(v32, v64).sum())
                determined = ~(_trails(v32, v64) | _trails(v64, v32))
                for k, solve in solvers.items():
                    v = acquisition_f64(args, kw, solve(*args, **kw)[0])
                    miss = _trails(v, v32)
                    count[k]["trails_plain32"] += int(miss.sum())
                    count[k]["where_determined"] += int((miss & determined).sum())
                    count[k]["plain32_trails"] += int(_trails(v32, v).sum())
                    count[k]["trails_plain64"] += int(_trails(v, v64).sum())
                    if trace and seed == _SMOKE_SEED:
                        for lane in torch.nonzero(miss)[:, 0].tolist():
                            trace_lane(dict(solvers, plain32=plain), args, kw, lane,
                                       f"seed {seed}, {iters} iterations, {label}, lane "
                                       f"{lane}: {k} trails the plain version")
            out[f"seed {seed}, {iters} iterations"] = count
    return out


def trace_lane(solvers, args, kw, lane, title):
    """Prints the float64 value of each start of one lane after 1, 2, ...
    iterations, for each float32 solver and for the plain version in
    float64 (a start's path does not depend on the other starts)."""
    one = tuple(a[lane:lane + 1].contiguous() for a in args[:6]) + tuple(args[6:])
    runs = dict(solvers, plain64=lambda *a, **k: chip_smoke._plain64(a, k))
    print(f"  trace, {title} (n = {int(args[3][lane])}); rows: start, solver; "
          f"columns: value after 1..{kw['iterations']} iterations")
    for s in range(args[9].shape[0]):
        start = one[:9] + (args[9][s:s + 1].contiguous(),) + one[10:]
        for name, solve in runs.items():
            row = [float(acquisition_f64(start, kw, solve(*start, **dict(kw, iterations=k))[0]))
                   for k in range(1, kw["iterations"] + 1)]
            print(f"    start {s} {name:>8}: " + " ".join(f"{v:.6g}" for v in row))


def acquisition_launch_times(dev):
    """CUDA-event ms of every kernel launch inside one bench.py acquisition."""
    from rollout_bo_tpu_torch.rollout import solvers as rs

    problem = bench_torch.bench_problem(dev, torch.float32)
    acquire = lambda: bench_torch.acquire(*problem)
    acquire()
    torch.cuda.synchronize()
    events = []
    inner = nl.newton_solve_lanes

    def timed(*a, **k):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = inner(*a, **k)
        stop.record()
        events.append((start, stop))
        return out

    rs.newton_lanes.newton_solve_lanes = timed
    try:
        walls = []
        per_call = []
        for _ in range(3):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acquire()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_call.append([a.elapsed_time(b) for a, b in events])
    finally:
        rs.newton_lanes.newton_solve_lanes = inner
    # the kernel's own device time in one more acquisition, by name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        acquire()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    kernel_us = sum(r.self_device_time_total for r in rows if "newton_lanes_kernel" in r.key)
    device_us = sum(r.self_device_time_total for r in rows)
    return walls, per_call, dict(kernel_ms=kernel_us / 1e3, device_ms=device_us / 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-source", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--criterion-b-seeds", type=int, nargs="*",
                    default=list(range(_SMOKE_SEED, _SMOKE_SEED + 12)))
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)

    variants = {f"{r} registers": (f"-DNEWTON_LI_MAXNREG8={r}",) for r in (128, 64, 48)} \
        if a.variants else {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        old = pool.submit(build_old, a.old_source) if a.old_source else None
        builds = [pool.submit(_build.load, "newton_lanes", defines) for defines in ((), _PROFILE)]
        tried = {k: pool.submit(_build.load, "newton_lanes", v) for k, v in variants.items()}
        for fut in builds:
            fut.result()
        for k, fut in tried.items():
            try:
                fut.result()
            except RuntimeError as e:       # a cap this nvcc refuses: reported, not timed
                print(f"variant {k} did not build: {str(e)[-400:]}")
                variants.pop(k)
        old_lib, old_log, old_wrapper = old.result() if old else (None, "", None)
    print(f"builds: {time.perf_counter() - t0:.1f} s (all started together)")
    report = {"card": card, "shapes": {}, "variants": {},
              "ptxas": {"old": ptxas_lines(old_log),
                        "new": ptxas_lines(_build.build_log("newton_lanes")),
                        **{k: ptxas_lines(_build.build_log("newton_lanes", v))
                           for k, v in variants.items()}}}
    for name, lines in report["ptxas"].items():
        for line in lines:
            print(f"  ptxas {name}: {line}")

    lib = nl._library()
    new = solver(lib)
    solvers = {"old": solver(old_lib, old_wrapper), "new": new} if old_lib else {"new": new}
    order = ["old", "new", "new", "old"] if old_lib else ["new", "new"]
    float32_differs = []
    for name, (args, kw, counts) in shapes(dev).items():
        layout = chip_smoke.kernel_layout(args[0], args[9].shape[0])
        report["shapes"][name] = dict(layout=layout)
        print(f"{name}: new kernel's blocks {layout}")
        X, S = args[0], args[9].shape[0]
        vs_old = None
        if old_lib:
            (xo, vo), (xn, vn) = solvers["old"](*args, **kw), new(*args, **kw)
            xr, vr = nl.newton_solve_lanes_ref(*args, **kw)
            torch.cuda.synchronize()
            width = float(torch.max(args[8] - args[7]))
            near = lambda x, y: float(((x - y).abs().amax(-1) <= 1e-3 * width).double().mean())
            vs_old = dict(
                bitwise_equal=bool(torch.equal(xn, xo) and torch.equal(vn, vo)),
                lanes_differ=int((vn != vo).sum()),
                max_abs_dv=float(torch.where(vn == vo, 0.0, (vn - vo).abs()).max()),
                argmax_agreement=near(xn, xo),
                argmax_agreement_with_plain={"old": near(xo, xr), "new": near(xn, xr)},
                lanes_missing_criterion_a={k: misses_a(args, kw, x_, v_) for k, (x_, v_) in
                                           dict(old=(xo, vo), new=(xn, vn),
                                                plain=(xr, vr)).items()})
            if X.dtype == torch.float32 and not vs_old["bitwise_equal"]:
                float32_differs.append(name)
        turns = time_turns(solvers, order, args, kw, a.reps)
        # a start stops at a fixed point: count the work these lanes need
        runs = nl._iterations_run(*args, **kw)
        work = chip_smoke.lane_bound(counts, X.shape[1], X.shape[2], S, kw["iterations"],
                                     X.dtype, runs)
        flops, nbytes, bound_ms = work["flops"], work["bytes"], work["bound_ms"]
        mean = {k: float(np.mean([ms for n_, ms in turns if n_ == k])) for k in solvers}
        phases = phase_cycles(args, kw, runs)
        floor = value_floor(solvers, args, kw)
        report["shapes"][name].update(turns=turns, mean_ms=mean, vs_old=vs_old,
                                      mean_runs=None if runs is None else
                                      float(runs.double().mean()),
                                      gflop=flops / 1e9, bytes=nbytes, bound_ms=bound_ms,
                                      phase_cycles=phases, value_floor=floor)
        print(f"  " + ", ".join(f"{n_} {ms:.3f}" for n_, ms in turns) + " ms")
        print(f"  iterations run per start: mean {float(runs.double().mean()):.3f} of "
              f"{kw['iterations']} ({layout['start_blocks']} start blocks, "
              f"{layout['warps_per_sm']} warps per SM)")
        print(f"  mean ms {mean}; {flops / 1e9:.3f} GFLOP, {nbytes} B, bound {bound_ms:.4f} "
              f"ms, share of bound { {k: round(bound_ms / mean[k], 4) for k in solvers} }"
              + (f"; speedup {mean['old'] / mean['new']:.2f}x; new vs old {vs_old}"
                 if old_lib else ""))
        print(f"  largest |v - v64| over the lanes (v64: the plain version in float64): "
              f"{ {k: float(f'{v:.3e}') for k, v in floor.items()} }")
        if name.startswith("bench"):
            report["shapes"][name]["residency_ms"] = residency_times(args, kw, a.reps)
            print(f"  new kernel by resident blocks: {report['shapes'][name]['residency_ms']}")
        print(f"  cycles per (lane, start, iteration), new kernel: "
              f"{ {k: round(v) for k, v in phases.items()} }, "
              f"{round(sum(phases.values()))} in all")
        if a.variants and X.dtype == torch.float64 and ("myopic" in name):
            runs = {k: solver(_build.load("newton_lanes", v)) for k, v in variants.items()}
            for k, run in runs.items():
                xv, vv = run(*args, **kw)
                xn, vn = new(*args, **kw)
                torch.cuda.synchronize()
                got = time_turns({"new": new, k: run}, ["new", k, k, "new"], args, kw, a.reps)
                ms = {n_: float(np.mean([t for m_, t in got if m_ == n_])) for n_ in ("new", k)}
                report["variants"][f"{name}: {k}"] = dict(
                    turns=got, mean_ms=ms,
                    max_abs_dv=float(torch.where(vv == vn, 0.0, (vv - vn).abs()).max()))
                print(f"  variant {k}: " + ", ".join(f"{n_} {t:.3f}" for n_, t in got)
                      + f" ms; max |v - v_new| "
                      f"{report['variants'][f'{name}: {k}']['max_abs_dv']:.3e}")

    if a.criterion_b_seeds:
        print(f"criterion (b) on the 25 x 64 small float32 lanes (chip_smoke's seed is "
              f"{_SMOKE_SEED}); lanes that trail by more than 5e-4 max(1, |v|) + 1e-6:")
        report["criterion_b"] = criterion_b_counts(solvers, dev, a.criterion_b_seeds, (8, 12),
                                                   a.trace)
        total = {}
        for key, count in report["criterion_b"].items():
            print(f"  {key}: {count}")
            for k, c in count.items():
                for what, v in c.items():
                    slot = (key.split(", ")[1], k, what)
                    total[slot] = total.get(slot, 0) + v
        print("  summed over the seeds: "
              + "; ".join(f"{i}, {k} {what} {v}" for (i, k, what), v in sorted(total.items())))

    walls, per_call, profiled = acquisition_launch_times(dev)
    report["acquisition"] = dict(wall_s=walls, kernel_ms=per_call, profiled=profiled)
    for w, ms in zip(walls, per_call):
        print(f"acquisition {w * 1e3:.1f} ms wall: {len(ms)} kernel launches, "
              f"{sum(ms):.3f} ms in all ({', '.join(f'{v:.3f}' for v in ms)}), "
              f"{sum(ms) / (w * 1e3):.3f} of the wall")
    print(f"one profiled acquisition (torch.profiler): the lane kernel "
          f"{profiled['kernel_ms']:.3f} ms of {profiled['device_ms']:.3f} ms device self time")
    if a.json is not None:
        a.json.parent.mkdir(parents=True, exist_ok=True)
        a.json.write_text(json.dumps(report, indent=1))
    if float32_differs:
        print(f"float32 values differ from the old source's at: {float32_differs}")
        raise SystemExit(1)
    if old_lib:
        print("float32 values bit for bit the old source's at every float32 shape")


if __name__ == "__main__":
    main()
