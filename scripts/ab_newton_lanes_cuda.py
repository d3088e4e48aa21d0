#!/usr/bin/env python3
"""Measurements of the Newton-lane CUDA kernel on one card, in one process.

    python3 scripts/ab_newton_lanes_cuda.py [--old-source PATH/newton_lanes.cu]

The kernel is the package's `csrc/newton_lanes.cu` (a warp per (lane,
start); float32 lanes in the W = K^{-1} form, float64 lanes in the Li =
L^{-1} form). `--old-source` adds an earlier source of the same design and
C interface to compare it with: the W form in both dtypes, fed each lane's
W = Li^T Li formed in the lanes' dtype (unpack it from the commit before
the float64 Li form, e.g. `git archive <commit> | tar -x -C
build/parent`). Each kernel is timed on its launch alone, the matrix it
reads formed before the timed launches. In float32 the two run the same code, so their
values must agree bit for bit.

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
  with the work and the bound from `lane_solve_work` in the lanes' dtype
  (the fewest operations the function needs: both kernels' share is of
  it), the values against the old kernel's (in float32 bit for bit), the value floor (each kernel run on the same lanes cast
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
    """nvcc on the earlier source, with the package's flags."""
    out = _build.BUILD_DIR / "newton_lanes-old.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def w_form(Li):
    """W = Li^T Li in the lanes' dtype, as the W-form kernel's caller formed it."""
    return Li.transpose(-1, -2) @ Li


def package_form(Li):
    """The matrix the package's kernel reads: W in float32, Li in float64."""
    return nl._lane_matrix(Li)[0]


def solver(lib, matrix):
    """A build's launch on Li arguments, `matrix(Li)` being what that build
    reads. `prepare` (which forms it) and `launch` split the two, so that a
    timing holds the launch alone, the same for every build."""
    def prepare(args):
        return args[:1] + (matrix(args[1]).contiguous(),) + args[2:]

    def launch(*args, **kw):
        return launch_with(lib, args, kw)

    def solve(*args, **kw):
        return launch(*prepare(args), **kw)

    solve.prepare, solve.launch = prepare, launch
    return solve


def launch_with(lib, args, kw, smem=None):
    """The wrapper's launch on another build (`lib`), or with more dynamic
    shared memory than the layout needs (`smem`). The lanes' second argument
    is the matrix that build reads (`solver`)."""
    X, M, c, n, fmini, th0, ell, lbs, ubs, xstarts, period = args
    dt, dev = X.dtype, X.device
    L, cap, d = X.shape
    lanes, groups, stage_m, need = nl._block_shape(cap, d, xstarts.shape[0], X.element_size())
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    params = torch.stack([as_t(ell).reshape(()), as_t(period).reshape(())])
    xout = torch.empty((L, d), dtype=dt, device=dev)
    vout = torch.empty((L,), dtype=dt, device=dev)
    fn = getattr(lib, nl._ENTRY[dt])
    fn.argtypes, fn.restype = nl._ARGTYPES, ctypes.c_int
    err = fn(X.data_ptr(), M.data_ptr(), c.data_ptr(), n.data_ptr(), fmini.data_ptr(),
             th0.data_ptr(), params.data_ptr(), lbs.data_ptr(), ubs.data_ptr(),
             xstarts.data_ptr(), xout.data_ptr(), vout.data_ptr(), L, cap, d,
             xstarts.shape[0], kw["iterations"], nl._KIND_IDS[kw["kind"]],
             nl._RULE_IDS[kw["rule"]], lanes, groups, int(stage_m), 1e-8, 1e-10, 1e-8,
             kw.get("f_tol", 0.0), kw.get("x_tol", 0.0), need if smem is None else smem,
             torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None)
    if err != 0:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")
    return xout, vout


def phase_cycles(args, kw):
    """Mean cycles per (lane, start, iteration) in each phase."""
    lib = _build.load("newton_lanes", _PROFILE)
    buf = (ctypes.c_ulonglong * 8)()
    lib.newton_lanes_phase_cycles(buf)              # sets the counts to 0
    solver(lib, package_form)(*args, **kw)
    torch.cuda.synchronize()
    lib.newton_lanes_phase_cycles(buf)
    solves = args[0].shape[0] * args[9].shape[0] * kw["iterations"]
    return {name: buf[i] / solves for i, name in enumerate(_PHASES)}


def residency_times(args, kw, reps):
    """ms per launch with 1, 2, ... blocks resident per SM: the dynamic
    shared memory is padded until only that many fit."""
    lib = nl._library()
    X, S = args[0], args[9].shape[0]
    lanes, groups, stage_m, smem = nl._block_shape(X.shape[1], X.shape[2], S, X.element_size())
    threads = lanes * groups * nl._GROUP
    most = lib.newton_lanes_blocks_per_sm(X.element_size(), int(stage_m), threads, smem)
    out = {}
    for blocks in range(1, most + 1):
        padded = smem if blocks == most else max(smem, nl._SMEM_LIMIT // (blocks + 1) + 4096)
        got = lib.newton_lanes_blocks_per_sm(X.element_size(), int(stage_m), threads, padded)
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

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        old = pool.submit(build_old, a.old_source) if a.old_source else None
        builds = [pool.submit(_build.load, "newton_lanes"),
                  pool.submit(_build.load, "newton_lanes", _PROFILE)]
        for fut in builds:
            fut.result()
        old_lib, old_log = old.result() if old else (None, "")
    print(f"builds: {time.perf_counter() - t0:.1f} s (all started together)")
    report = {"card": card, "shapes": {},
              "ptxas": {"old": ptxas_lines(old_log),
                        "new": ptxas_lines(_build.build_log("newton_lanes"))}}
    for name, lines in report["ptxas"].items():
        for line in lines:
            print(f"  ptxas {name}: {line}")

    lanes, groups, stage_m, smem = nl._block_shape(24, 10, 10, 4)
    report["bench_block"] = dict(
        threads=lanes * groups * nl._GROUP, shared_bytes=smem,
        blocks_per_sm=nl._library().newton_lanes_blocks_per_sm(
            4, int(stage_m), lanes * groups * nl._GROUP, smem))
    print(f"bench shape, new kernel: {report['bench_block']}")

    new = solver(nl._library(), package_form)
    solvers = {"old": solver(old_lib, w_form), "new": new} if old_lib else {"new": new}
    order = ["old", "new", "new", "old"] if old_lib else ["new", "new"]
    for name, (args, kw, counts) in shapes(dev).items():
        vs_old = None
        if old_lib:
            (xo, vo), (xn, vn) = solvers["old"](*args, **kw), new(*args, **kw)
            torch.cuda.synchronize()
            width = float(torch.max(args[8] - args[7]))
            vs_old = dict(
                bitwise_equal=bool(torch.equal(xn, xo) and torch.equal(vn, vo)),
                max_abs_dv=float(torch.where(vn == vo, 0.0, (vn - vo).abs()).max()),
                argmax_agreement=float(((xn - xo).abs().amax(-1) <= 1e-3 * width)
                                       .double().mean()))
        turns = time_turns(solvers, order, args, kw, a.reps)
        X, S = args[0], args[9].shape[0]
        work = chip_smoke.lane_bound(counts, X.shape[1], X.shape[2], S, kw["iterations"],
                                     X.dtype)
        flops, nbytes, bound_ms = work["flops"], work["bytes"], work["bound_ms"]
        mean = {k: float(np.mean([ms for n_, ms in turns if n_ == k])) for k in solvers}
        phases = phase_cycles(args, kw)
        floor = value_floor(solvers, args, kw)
        report["shapes"][name] = dict(turns=turns, mean_ms=mean, vs_old=vs_old,
                                      gflop=flops / 1e9, bytes=nbytes, bound_ms=bound_ms,
                                      phase_cycles=phases, value_floor=floor)
        print(f"{name}: " + ", ".join(f"{n_} {ms:.3f}" for n_, ms in turns) + " ms")
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


if __name__ == "__main__":
    main()
