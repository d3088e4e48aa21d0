"""PyTorch port: the CUDA Newton lane kernel, built by g++ and run on the CPU.

There is no CUDA compiler or card where the CPU tests run, so the kernel's
own control flow (the warp-cooperative passes, shuffles, tiles, the block
layout that `_block_shape` mirrors) would be tested only on the card. Here
`tests/cuda_emulation/cuda_emu.h` maps the CUDA features the source uses
onto OS threads and barriers, g++ builds `csrc/newton_lanes.cu` with its
`<<<...>>>` launch replaced by a loop over blocks, and the same C entry
points run on CPU tensors, both instantiations: float (the W = K^{-1}
form) and double (the Li form). Each case is held to the criteria of
tests/test_torch_cuda.py against the plain version: (a) the kernel's value
matches a plain re-evaluation of the acquisition at its argmax (float32
rtol 2e-3, float64 1e-6); (b) its solution is never worse than the plain
solver's beyond 5e-4 relative in float32 / 1e-6 in float64. The double
instantiation must read no word of Li above its diagonal, staged in shared
memory or left in device memory: NaN written there changes no bit.

This checks the arithmetic and the indexing, not the compiler or the card:
tests/test_torch_cuda.py and chip_smoke.py do that. Skipped without g++.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.ops import qmc

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE.parent / "rollout_bo_tpu_torch" / "csrc" / "newton_lanes.cu"
# what the emulation replaces in the source, with what, and how often (the
# header defines the launch macro, LANES_LAUNCH, before the source does)
_PATCHES = (
    ("#include <cuda_runtime.h>", '#include "cuda_emu.h"', 1),
    ("extern __shared__ __align__(16) unsigned char smem_raw[];",
     "unsigned char* smem_raw = emu_smem;", 3),
)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's C entry points, built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation of the kernel")
    text = _SOURCE.read_text()
    for old, new, count in _PATCHES:
        assert text.count(old) == count, f"the emulation expects {count} {old!r} in the source"
        text = text.replace(old, new)
    out = tmp_path_factory.mktemp("kernel_emulation")
    (out / "newton_lanes_emu.cpp").write_text(text)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{_HERE / 'cuda_emulation'}", "-o", str(out / "emu.so"),
         str(out / "newton_lanes_emu.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "emu.so"))
    for name in nl._ENTRY.values():
        getattr(lib, name).argtypes = nl._ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _solve(lib, X, Li, c, n, fmini, th0, ell, lbs, ubs, xstarts, period, *, kind, rule,
           iterations, f_tol=0.0, x_tol=0.0, sms=nl._SMS, runs=None):
    """The wrapper's launch, on CPU pointers: same block shape, same arguments
    (the lane matrix of the dtype: W in float32, Li in float64). `sms`
    passes to `_block_shape`: a smaller card spreads fewer blocks; `runs`
    (int32 (L, S)) takes the iterations each start ran."""
    dt = X.dtype
    L, cap, d = X.shape
    S = xstarts.shape[0]
    assert all(a.is_contiguous() for a in (X, Li, c, n, fmini, th0, lbs, ubs, xstarts))
    layout = nl._block_shape(cap, d, S, X.element_size(), L, sms=sms)
    M = nl._lane_matrix(Li)[0]
    params = torch.tensor([float(ell), float(period)], dtype=dt)
    xout = torch.full((L, d), float("nan"), dtype=dt)
    vout = torch.full((L,), float("nan"), dtype=dt)
    part = torch.full((L, layout.start_blocks, d + 2), float("nan"), dtype=dt)
    err = getattr(lib, nl._ENTRY[dt])(
        X.data_ptr(), M.data_ptr(), c.data_ptr(), n.data_ptr(), fmini.data_ptr(),
        th0.data_ptr(), params.data_ptr(), lbs.data_ptr(), ubs.data_ptr(),
        xstarts.data_ptr(), xout.data_ptr(), vout.data_ptr(), part.data_ptr(),
        None if runs is None else runs.data_ptr(), L, cap, d, S, iterations,
        nl._KIND_IDS[kind], nl._RULE_IDS[rule], *nl._layout_args(layout),
        1e-8, 1e-10, 1e-8, f_tol, x_tol, layout.smem, None)
    assert err == 0
    return xout, vout


# name: (lanes by active count, d, capacity, starts, kind, rule, dtype, emptied)
_CASES = {
    "matern52_EI_f32": ({3: 2, 6: 2, 9: 2}, 3, 12, 6, "matern52", "EI", torch.float32, 0),
    "matern52_EI_f64_d10_like_the_bench": ({13: 1, 15: 1}, 10, 24, 10, "matern52", "EI",
                                           torch.float64, 0),
    "periodic_LogEI_f64": ({4: 2, 7: 2}, 2, 8, 4, "periodic", "LogEI", torch.float64, 0),
    "matern32_POI_loose_f64": ({5: 2, 8: 2}, 3, 12, 4, "matern32", "POI", torch.float64, 0),
    "sqexp_LogPOI_f64": ({5: 2, 8: 1}, 3, 12, 5, "squared_exponential", "LogPOI",
                         torch.float64, 0),
    "matern12_LCB_n0_and_full_one_start": ({12: 9}, 2, 12, 1, "matern12", "LCB",
                                           torch.float64, 3),
    "forty_starts_in_chunks": ({4: 2, 7: 1}, 2, 8, 40, "matern52", "EI", torch.float64, 0),
    "d16_capacity_64_f64": ({40: 1, 64: 1}, 16, 64, 3, "matern52", "EI", torch.float64, 0),
    "W_left_in_device_memory_f32": ({5: 2, 11: 1}, 4, 240, 3, "matern52", "EI",
                                    torch.float32, 0),
    "Li_left_in_device_memory_f64": ({5: 2, 11: 1}, 4, 240, 3, "matern52", "EI",
                                     torch.float64, 0),
    # the myopic loop's shape: one lane's 66 starts in 66 blocks of one group
    "myopic_cap105_n104_d6_66_starts_f64": ({104: 1}, 6, 105, 66, "matern52", "EI",
                                            torch.float64, 0),
}
# the paper's ladder in float32 (d 1 and 2, n 4..16 of capacity 20, 8 + 2
# starts), by its rule (EI) and two others
_CASES.update({
    f"ladder_d{d}_f32_{rule}": ({4: 1, 9: 1, 16: 1}, d, 20, 10, "matern52", rule,
                                torch.float32, 0)
    for d in (1, 2) for rule in ("EI", "LCB", "LogEI")})
# every kind x rule in float64, n below the group of 32 (and a lane with n =
# 0 where the rule reads no incumbent)
_CASES.update({
    f"{kind}_{rule}_f64_n_below_the_group": ({3: 1, 7: 1}, 2, 8, 4, kind, rule, torch.float64,
                                             1 if rule == "LCB" else 0)
    for kind in nl.SUPPORTED_KINDS for rule in nl.SUPPORTED_RULES})


def _case_inputs(case):
    """(state, rule, solver arguments, keywords) of one case of _CASES (its
    name, or a tuple laid out as its entries)."""
    sizes, d, cap, S, kind, rule_name, dtype, emptied = \
        _CASES[case] if isinstance(case, str) else case
    rng = np.random.default_rng(3)
    f32 = dtype == torch.float32
    theta = (0.9, 3.0) if kind == "periodic" else (0.8,)
    kern = K.RBFKernel(torch.tensor(theta, dtype=dtype), kind)
    parts = []
    for n, count in sizes.items():
        X = rng.uniform(-1.0, 1.0, (count, n, d))
        y = np.sin(2.0 * X.sum(axis=-1)) + 0.2 * rng.standard_normal((count, n))
        parts.append(sg.fit(kern, X, y, capacity=cap, noise=1e-3 if f32 else 1e-4,
                            device="cpu", dtype=dtype))
    cat = {f: torch.cat([getattr(p, f) for p in parts])
           for f in ("X", "y", "L", "c", "n", "Li")}
    st = sg.SurrogateState(kern, noise=parts[0].noise, **cat)
    if emptied:
        n = st.n.clone()
        n[:emptied] = 0
        st = st._replace(n=n)
    rule = dr.RULES[rule_name]()            # POI: the loose freeze
    L = st.X.shape[0]
    lo, hi = -np.ones(d), np.ones(d)
    starts = qmc.generate_initial_guesses(S - 2, lo, hi) if S > 2 else \
        rng.uniform(lo, hi, (S, d))
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    th = torch.full((L, 1), 0.5 if rule_name == "LCB" else 0.0, dtype=dtype)
    period = kern.theta[1] if kind == "periodic" else 1.0
    args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), th[:, 0].contiguous(),
            kern.theta[0], t(lo), t(hi), t(starts), period)
    kw = dict(kind=kind, rule=rule_name, iterations=5, f_tol=rule.solve_f_tol,
              x_tol=rule.solve_x_tol)
    assert nl._block_shape(cap, d, S, st.X.element_size()).stage_m == (cap < 200)
    return st, rule, th, args, kw


def _hold_to_plain_version(st, rule, th, args, kw, xk, vk):
    """Criteria (a) and (b) of the module docstring for the kernel's (xk, vk)."""
    f32, rule_name = st.X.dtype == torch.float32, kw["rule"]
    xr, _ = nl.newton_solve_lanes_ref(*args, **kw)
    assert bool(torch.all(torch.isfinite(xk))) and bool(torch.all(torch.isfinite(vk)))
    vk_cross = sg.acquisition(st, rule, xk, th)
    vr_cross = sg.acquisition(st, rule, xr, th)
    log = rule_name.startswith("Log")
    torch.testing.assert_close(vk, vk_cross, rtol=2e-3 if f32 else 1e-6,
                               atol=(2e-3 if f32 else 1e-6) if log else (1e-6 if f32 else 1e-9))
    if rule.solve_f_tol > 0:
        slack = rule.solve_f_tol * (vr_cross.abs() + 1.0)
    else:
        slack = (5e-4 if f32 else 1e-6) * vr_cross.abs().clamp(min=1.0) + 1e-6
    assert torch.all(vk_cross >= vr_cross - slack)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_emulated_kernel_matches_plain_version(emulated, case):
    st, rule, th, args, kw = _case_inputs(case)
    _hold_to_plain_version(st, rule, th, args, kw, *_solve(emulated, *args, **kw))


def test_emulated_double_kernel_stops_a_start_at_its_fixed_point(emulated):
    """A start whose iteration returns its point unchanged stops there: the
    iteration is a function of the point alone, so every later one would
    return it too. Over 3 lanes x 40 starts some stop before the 5
    iterations, some run them all; the result meets the criteria against
    the plain version (every start run to the end); and a start that
    stopped, solved alone, gives bit for bit the same with 4 iterations
    more."""
    st, rule, th, args, kw = _case_inputs("forty_starts_in_chunks")
    L, S, its = args[0].shape[0], args[9].shape[0], kw["iterations"]
    runs = torch.full((L, S), -1, dtype=torch.int32)
    xk, vk = _solve(emulated, *args, **kw, runs=runs)
    assert bool(torch.all((runs >= 1) & (runs <= its)))
    assert bool(torch.any(runs < its)) and bool(torch.any(runs == its))
    _hold_to_plain_version(st, rule, th, args, kw, xk, vk)
    for lane, start in torch.nonzero(runs < its)[:4].tolist():
        one = tuple(a[lane:lane + 1].contiguous() for a in args[:6]) + args[6:9] + \
            (args[9][start:start + 1].contiguous(), args[10])
        x1, v1 = _solve(emulated, *one, **kw)
        x2, v2 = _solve(emulated, *one, **dict(kw, iterations=its + 4))
        assert torch.equal(x1, x2) and torch.equal(v1, v2)


def test_emulated_float_kernel_stops_a_start_at_its_fixed_point(emulated):
    """The float32 kernel (d 2, its 16 starts over start blocks) stops a
    start at a fixed point of its iteration as the double one does, and
    fills `runs`: over 3 lanes x 16 starts some stop
    before the 5 iterations, some run them all; the result meets the
    criteria; and a start that stopped, solved alone, gives bit for bit
    what 4 iterations more give, which run every one of the iterations it
    stopped before."""
    st, rule, th, args, kw = _case_inputs(
        ({4: 2, 7: 1}, 2, 8, 16, "matern52", "EI", torch.float32, 0))
    L, S, its = args[0].shape[0], args[9].shape[0], kw["iterations"]
    assert nl._block_shape(8, 2, S, 4, L).start_blocks > 1
    runs = torch.full((L, S), -1, dtype=torch.int32)
    xk, vk = _solve(emulated, *args, **kw, runs=runs)
    assert bool(torch.all((runs >= 1) & (runs <= its)))
    assert bool(torch.any(runs < its)) and bool(torch.any(runs == its))
    _hold_to_plain_version(st, rule, th, args, kw, xk, vk)
    for lane, start in torch.nonzero(runs < its)[:4].tolist():
        one = tuple(a[lane:lane + 1].contiguous() for a in args[:6]) + args[6:9] + \
            (args[9][start:start + 1].contiguous(), args[10])
        x1, v1 = _solve(emulated, *one, **kw)
        x2, v2 = _solve(emulated, *one, **dict(kw, iterations=its + 4))
        assert torch.equal(x1, x2) and torch.equal(v1, v2)


@pytest.mark.parametrize("sms", [132, 8])
def test_emulated_float_kernel_start_blocks_change_no_bit(emulated, sms):
    """The ladder's float32 lanes (3 lanes of d 2, 10 starts) over start
    blocks (132 SMs: a block per start; 8: two starts a block) give bit for
    bit what one block per lane gives (3 SMs, which the 3 lanes fill): each
    start runs the same iterations wherever it runs, and the best start
    across blocks is the one a block picks, the lowest on a tie."""
    st, rule, th, args, kw = _case_inputs("ladder_d2_f32_EI")
    L, cap, d = args[0].shape
    assert nl._block_shape(cap, d, 10, 4, L, sms=sms).start_blocks > 1
    assert nl._block_shape(cap, d, 10, 4, L, sms=L).start_blocks == 1
    xs, vs = _solve(emulated, *args, **kw, sms=sms)
    x1, v1 = _solve(emulated, *args, **kw, sms=L)
    assert torch.equal(xs, x1) and torch.equal(vs, v1)


@pytest.mark.parametrize("sms,dt", [
    pytest.param(sms, dt, id=f"{sms}" if dt == torch.float64 else f"{sms}-float32")
    for dt in (torch.float64, torch.float32) for sms in (132, 8, 3)])
def test_emulated_double_kernel_ties_across_start_blocks(emulated, sms, dt):
    """One lane, 66 starts over 66, 8 or 3 start blocks, in the double
    kernel and in the float one. Four data points in a corner at
    lengthscale 0.001: starts 0-23 sit on them (EI near 0, no step leaves
    them), starts 24-65 lie where every k(x, X_j) underflows to 0, so their
    values tie exactly and none moves (a zero gradient). The lowest of the
    tied starts, 24, must win across the blocks, as in the plain version,
    whose x is start 24 itself."""
    d = 2
    X = np.array([[-0.9, -0.9], [-0.9, -0.8], [-0.8, -0.9], [-0.8, -0.8]])
    kern = K.RBFKernel(torch.tensor([0.001], dtype=dt), "matern52")
    st = sg.fit(kern, X[None], np.array([[1.0, 1.5, 2.0, 2.5]]), capacity=8, noise=1e-4,
                device="cpu", dtype=dt)
    st = st._replace(Li=st.Li.contiguous())
    lo, hi = np.full(d, -1.0), np.full(d, 1.0)
    starts = torch.tensor(np.concatenate(
        [np.repeat(X, 6, axis=0), qmc.generate_initial_guesses(40, np.zeros(d), hi)]), dtype=dt)
    assert starts.shape == (66, d)
    args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), torch.zeros(1, dtype=dt),
            kern.theta[0], torch.tensor(lo, dtype=dt), torch.tensor(hi, dtype=dt), starts, 1.0)
    kw = dict(kind="matern52", rule="EI", iterations=5)
    itemsize = st.X.element_size()
    assert nl._block_shape(8, d, 66, itemsize, 1, sms=sms).start_blocks == min(sms, 66)
    xr, vr = nl.newton_solve_lanes_ref(*args, **kw)
    assert torch.equal(xr[0], starts[24])
    runs = torch.zeros((1, 66), dtype=torch.int32)
    xk, vk = _solve(emulated, *args, **kw, sms=sms, runs=runs)
    assert torch.equal(xk[0], starts[24])
    assert bool(torch.all(runs == 1))       # no start moves: a fixed point at once
    # the same value up to the normal CDF's rounding on each route
    torch.testing.assert_close(vk, vr, rtol=1e-12 if dt == torch.float64 else 1e-6, atol=0.0)


@pytest.mark.parametrize("case", ["matern52_EI_f64_d10_like_the_bench",
                                  "Li_left_in_device_memory_f64"])
def test_emulated_double_kernel_reads_only_the_lower_triangle_of_li(emulated, case):
    """Li is zero above its diagonal, and the double instantiation neither
    stages nor reads that part, in shared memory (the first case) or in
    device memory (the second): NaN written there changes no bit, and the
    result still meets the criteria. (The words of shared memory that are
    not staged hold NaN patterns in the emulation, so that a read of them
    shows as a solve that misses the criteria.)"""
    st, rule, th, args, kw = _case_inputs(case)
    Li = args[1]
    upper = torch.ones_like(Li, dtype=torch.bool).triu(1)
    assert torch.all(Li[upper] == 0)
    poisoned = torch.where(upper, torch.full_like(Li, float("nan")), Li)
    xk, vk = _solve(emulated, *args, **kw)
    xp, vp = _solve(emulated, args[0], poisoned, *args[2:], **kw)
    assert nl._block_shape(*args[0].shape[1:], args[9].shape[0], 8, args[0].shape[0]) \
        .start_blocks > 1          # the lane's starts over several blocks
    assert torch.equal(xk, xp) and torch.equal(vk, vp)
    _hold_to_plain_version(st, rule, th, args, kw, xp, vp)


# --------------------------------------------------------------------------
# The float64 lane block (a block per lane, its starts together): where a
# launch's lanes fill the card. `_lane_sms` is the largest SM count at which
# `_block_shape` gives L lanes the lane block.
# --------------------------------------------------------------------------


def _lane_sms(L):
    return int(L / nl._LANE_CROSSOVER)


def _lane_block_cases():
    """The float64 cases of _CASES at d <= 8 whose lane fits the lane block
    (Li left in device memory does not: that launch keeps a warp per start)."""
    out = []
    for name, (sizes, d, cap, S, _, _, dt, _) in sorted(_CASES.items()):
        if dt == torch.float64 and d <= 8:
            fits = nl._lane_block_shape(cap, d, S) is not None
            assert fits == (cap < 200), name
            if fits:
                out.append(name)
    return out


@pytest.mark.parametrize("case", _lane_block_cases())
def test_emulated_lane_block_matches_plain_version(emulated, case):
    """Every float64 case at d <= 8 through the lane block, held to the
    criteria against the plain version as the warp per start is (the test
    above); the myopic shape's 66 starts and the forty starts in passes of
    at most 32."""
    st, rule, th, args, kw = _case_inputs(case)
    L, cap, d = args[0].shape
    S = args[9].shape[0]
    lay = nl._block_shape(cap, d, S, 8, L, sms=_lane_sms(L))
    assert lay.slots == min(S, nl._MAX_SLOTS, lay.slots) >= 1 and lay.start_blocks == 1
    assert lay.slots == min(S, 32) or cap > 100          # cap 105: fewer slots fit
    _hold_to_plain_version(st, rule, th, args, kw,
                           *_solve(emulated, *args, **kw, sms=_lane_sms(L)))


def test_emulated_lane_block_stops_a_start_at_its_fixed_point(emulated):
    """As for the warp per start: 3 lanes x 40 starts (two passes, 32 and 8
    starts), some stopping before the 5 iterations, some running them all;
    `runs` filled; the criteria met; and a start that stopped, solved alone
    on the lane block, gives bit for bit what 4 iterations more give."""
    st, rule, th, args, kw = _case_inputs("forty_starts_in_chunks")
    L, S, its = args[0].shape[0], args[9].shape[0], kw["iterations"]
    assert nl._block_shape(8, 2, S, 8, L, sms=_lane_sms(L)).slots == 32
    runs = torch.full((L, S), -1, dtype=torch.int32)
    xk, vk = _solve(emulated, *args, **kw, sms=_lane_sms(L), runs=runs)
    assert bool(torch.all((runs >= 1) & (runs <= its)))
    assert bool(torch.any(runs < its)) and bool(torch.any(runs == its))
    _hold_to_plain_version(st, rule, th, args, kw, xk, vk)
    for lane, start in torch.nonzero(runs < its)[:4].tolist():
        one = tuple(a[lane:lane + 1].contiguous() for a in args[:6]) + args[6:9] + \
            (args[9][start:start + 1].contiguous(), args[10])
        assert nl._block_shape(8, 2, 1, 8, 1, sms=0).slots == 1
        x1, v1 = _solve(emulated, *one, **kw, sms=0)
        x2, v2 = _solve(emulated, *one, **dict(kw, iterations=its + 4), sms=0)
        assert torch.equal(x1, x2) and torch.equal(v1, v2)


def test_emulated_lane_block_lowest_start_wins_a_tie(emulated):
    """The tie of test_emulated_double_kernel_ties_across_start_blocks on
    the lane block: 66 starts in passes of 32, 32 and 2; starts 24-65 tie
    exactly and none moves; start 24, in the first pass, must win over its
    equals in the later ones."""
    d, dt = 2, torch.float64
    X = np.array([[-0.9, -0.9], [-0.9, -0.8], [-0.8, -0.9], [-0.8, -0.8]])
    kern = K.RBFKernel(torch.tensor([0.001], dtype=dt), "matern52")
    st = sg.fit(kern, X[None], np.array([[1.0, 1.5, 2.0, 2.5]]), capacity=8, noise=1e-4,
                device="cpu", dtype=dt)
    st = st._replace(Li=st.Li.contiguous())
    hi = np.full(d, 1.0)
    starts = torch.tensor(np.concatenate(
        [np.repeat(X, 6, axis=0), qmc.generate_initial_guesses(40, np.zeros(d), hi)]), dtype=dt)
    args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), torch.zeros(1, dtype=dt),
            kern.theta[0], torch.tensor(-hi, dtype=dt), torch.tensor(hi, dtype=dt), starts, 1.0)
    kw = dict(kind="matern52", rule="EI", iterations=5)
    assert nl._block_shape(8, d, 66, 8, 1, sms=0).slots == 32
    xr, vr = nl.newton_solve_lanes_ref(*args, **kw)
    assert torch.equal(xr[0], starts[24])
    runs = torch.zeros((1, 66), dtype=torch.int32)
    xk, vk = _solve(emulated, *args, **kw, sms=0, runs=runs)
    assert torch.equal(xk[0], starts[24])
    assert bool(torch.all(runs == 1))
    torch.testing.assert_close(vk, vr, rtol=1e-12, atol=0.0)


def test_emulated_lane_block_reads_only_the_lower_triangle_of_li(emulated):
    """The lane block stages Li's lower triangle only: NaN above the
    diagonal changes no bit, and the result meets the criteria."""
    st, rule, th, args, kw = _case_inputs("matern32_POI_loose_f64")
    Li, L = args[1], args[0].shape[0]
    upper = torch.ones_like(Li, dtype=torch.bool).triu(1)
    poisoned = torch.where(upper, torch.full_like(Li, float("nan")), Li)
    assert nl._block_shape(*args[0].shape[1:], args[9].shape[0], 8, L,
                           sms=_lane_sms(L)).slots > 0
    xk, vk = _solve(emulated, *args, **kw, sms=_lane_sms(L))
    xp, vp = _solve(emulated, args[0], poisoned, *args[2:], **kw, sms=_lane_sms(L))
    assert torch.equal(xk, xp) and torch.equal(vk, vp)
    _hold_to_plain_version(st, rule, th, args, kw, xp, vp)


def test_the_lane_block_launches_are_counted_apart(emulated, monkeypatch):
    """The wrapper's launch (`_launch`, on CPU tensors through the emulated
    library) counts every solve in LAUNCHES and the lane block's also in
    LANE_BLOCK_LAUNCHES, and a BO iteration's record counts the lane
    block's launches in it: a launch whose lanes fill the card (here a card
    of as few SMs as 4 lanes fill) takes the lane block and gives what
    `_solve` gives; at 132 SMs, and in float32, the same lanes take a warp
    per start."""
    from types import SimpleNamespace

    from rollout_bo_tpu_torch.utils import profiling

    sms = {"n": _lane_sms(4)}
    monkeypatch.setattr(nl, "_library", lambda: emulated)
    monkeypatch.setattr(nl, "_sm_count", lambda index: sms["n"])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    st, rule, th, args, kw = _case_inputs("matern32_POI_loose_f64")
    assert args[0].shape[0] == 4

    def launch(a):
        return nl._launch(*a[:7], *(torch.as_tensor(v, dtype=a[0].dtype) for v in a[7:10]),
                          a[10], **dict(kw, sigma_tol=1e-8, sigma_floor=1e-10, ridge=1e-8))

    counts = lambda: (nl.LAUNCHES, nl.LANE_BLOCK_LAUNCHES)
    before = counts()
    with profiling.record("bo.iteration", serial=-1, b=0, loop="nonmyopic",
                          device="cpu") as rec:
        xk, vk = launch(args)
    assert counts() == (before[0] + 1, before[1] + 1)
    assert rec.lane_block_launches == 1
    x1, v1 = _solve(emulated, *args, **kw, sms=_lane_sms(4))
    assert torch.equal(xk, x1) and torch.equal(vk, v1)
    sms["n"] = nl._SMS
    launch(args)
    launch(tuple(a.float() if torch.is_tensor(a) and a.is_floating_point() else a
                 for a in args))
    assert counts() == (before[0] + 3, before[1] + 1)
