"""PyTorch port on the card: the CUDA Newton lane kernel vs its plain version,
the sharded path (ranks of torch.distributed that each launch the kernel
on their share of the lanes) vs the same solve with no mesh, and the
programs (CUDA graphs, `utils.graphs`: the SGA programs, and the BO
loops' observe step, myopic chunk, fallback and batch and Gauss-Hermite
acquisitions, and the sharded programs on an NCCL group) vs the eager
route; every test function and the MLE inside a capture.

Every test here is marked `cuda` and skips without a CUDA device (the
kernel has no CPU mode). This file imports no jax, so it also runs on a
GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and its plain version take each lane's Li, and solve float32
lanes in the W = K^{-1} = Li^T Li form and float64 lanes in the Li form.
Criteria as in chip_smoke.py and tests/test_pallas_newton.py, on the same
CUDA lanes: (a) the kernel's value matches a plain re-evaluation of the
acquisition at its argmax (float32 rtol 2e-3, log rules atol 2e-3 in log
space; float64 rtol 1e-6); (b) its solution is never worse than the plain
solver's beyond 5e-4 relative in float32 / 1e-6 in float64 — or beyond
the acceptance tolerance f_tol (|v| + 1) under the loose freeze, whose
stopping iteration rounding near the threshold may shift. A program's
replay runs the kernels its eager body runs, at the same shapes, on the
same card: the two are held equal bit for bit.
"""

import numpy as np
import pytest
import torch

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout import solvers

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _lane_state(L, d, cap, kind, dtype, device, seed):
    """L single-lane fits with active counts 3..9, stacked into one state.

    float32 lanes get noise 1e-3: with 1e-4 a squared-exponential K on
    these points is conditioned beyond what float32 resolves, and the
    W = K^{-1} (kernel) and Li (re-evaluation) variance forms then differ
    by far more than the criteria's tolerance on a lane or two."""
    rng = np.random.default_rng(seed)
    theta = (0.9, 3.0) if kind == "periodic" else (0.8,)
    kern = K.RBFKernel(torch.tensor(theta, dtype=dtype, device=device), kind)
    lanes = []
    for _ in range(L):
        n = int(rng.integers(3, 10))
        X = rng.uniform(-1.0, 1.0, (n, d))
        lanes.append(sg.fit(kern, X, np.sin(2.0 * X.sum(axis=1)), capacity=cap,
                            noise=1e-3 if dtype == torch.float32 else 1e-4,
                            device=device, dtype=dtype))
    cat = {f: torch.stack([getattr(s, f) for s in lanes])
           for f in ("X", "y", "L", "c", "n", "Li")}
    return sg.SurrogateState(kern, noise=lanes[0].noise, **cat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", nl.SUPPORTED_KINDS)
@pytest.mark.parametrize("rule_name", nl.SUPPORTED_RULES)
def test_kernel_matches_plain_version(dev, rule_name, kind, dtype):
    L, d = 64, 3
    st = _lane_state(L, d, 12, kind, dtype, dev, 1)
    rule = dr.RULES[rule_name]()          # POI: the loose freeze
    lbs = torch.full((d,), -1.0, dtype=dtype, device=dev)
    ubs = torch.full((d,), 1.0, dtype=dtype, device=dev)
    xstarts = torch.tensor(qmc.generate_initial_guesses(6, -np.ones(d), np.ones(d)),
                           dtype=dtype, device=dev)
    th = torch.full((L, 1), 0.5 if rule_name == "LCB" else 0.0, dtype=dtype, device=dev)
    args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), th[:, 0].contiguous(),
            st.kernel.theta[0], lbs, ubs, xstarts,
            st.kernel.theta[1] if kind == "periodic" else 1.0)
    kw = dict(kind=kind, rule=rule_name, iterations=8, f_tol=rule.solve_f_tol,
              x_tol=rule.solve_x_tol)
    before = nl.LAUNCHES
    xk, vk = nl.newton_solve_lanes(*args, **kw)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before + 1
    xr, vr = nl.newton_solve_lanes_ref(*args, **kw)
    assert nl.LAUNCHES == before + 1
    vk_cross = sg.acquisition(st, rule, xk, th)
    vr_cross = sg.acquisition(st, rule, xr, th)
    f32 = dtype == torch.float32
    rtol = 2e-3 if f32 else 1e-6
    atol = (2e-3 if f32 else 1e-6) if rule_name.startswith("Log") else (1e-6 if f32 else 1e-9)
    torch.testing.assert_close(vk, vk_cross, rtol=rtol, atol=atol)
    if rule.solve_f_tol > 0:
        slack = rule.solve_f_tol * (vr_cross.abs() + 1.0)
    else:
        slack = (5e-4 if f32 else 1e-6) * vr_cross.abs().clamp(min=1.0) + 1e-6
    assert torch.all(vk_cross >= vr_cross - slack)


def test_maximize_hot_launches_once_for_all_lane_axes(dev):
    flat = _lane_state(12, 2, 8, "matern52", torch.float32, dev, 3)
    lanes = {f: getattr(flat, f).reshape((3, 4) + getattr(flat, f).shape[1:])
             for f in ("X", "y", "L", "c", "n", "Li")}
    st = sg.SurrogateState(flat.kernel, noise=flat.noise, **lanes)
    before = nl.LAUNCHES
    x, v = solvers.maximize_hot(st, dr.EI(), torch.zeros((3, 4, 1), device=dev),
                                torch.full((2,), -1.0, device=dev),
                                torch.full((2,), 1.0, device=dev),
                                torch.zeros((4, 2), device=dev), iterations=4)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before + 1
    assert x.shape == (3, 4, 2) and bool(torch.all(torch.isfinite(v)))


def test_kernel_raises_instead_of_falling_back(dev):
    """Shapes beyond the kernel's maxima raise for CUDA tensors."""
    d = nl.MAX_D + 1
    X = torch.zeros((2, 4, d), device=dev)
    Li = torch.eye(4, device=dev).expand(2, 4, 4).contiguous()
    z = torch.zeros(2, device=dev)
    with pytest.raises(ValueError, match="outside"):
        nl.newton_solve_lanes(X, Li, torch.zeros((2, 4), device=dev),
                              torch.tensor([2, 2], device=dev), z, z, 0.8,
                              torch.full((d,), -1.0, device=dev),
                              torch.full((d,), 1.0, device=dev),
                              torch.zeros((3, d), device=dev), iterations=1)


# (lanes by active count, d, capacity, starts, dtype, lanes emptied to n = 0)
_EDGE_SHAPES = {
    "one_start": ({5: 20, 9: 21}, 3, 12, 1, torch.float64, 0),
    "forty_starts": ({5: 8, 9: 9}, 3, 12, 40, torch.float64, 0),
    "seven_lanes_block_not_filled": ({6: 7}, 2, 8, 1, torch.float32, 0),
    "1601_lanes_last_block_of_one": ({4: 800, 7: 801}, 2, 8, 2, torch.float64, 0),
    "n_zero_and_n_capacity": ({12: 12}, 3, 12, 6, torch.float64, 4),
    "capacity_64_d_16_float64": ({40: 4, 64: 4}, 16, 64, 6, torch.float64, 0),
    # the shapes the BO loops give the kernel at the CLIs' defaults (d = 6):
    # one lane of 104 observations with 64 + 2 starts (Li staged, 3 warps),
    # and 10 restarts x 200 trajectories at fantasy capacity 23, 16 + 2 starts
    "myopic_loop_one_lane_capacity_105": ({104: 1}, 6, 105, 66, torch.float64, 0),
    "nonmyopic_loop_2000_lanes_capacity_23": (
        {6: 500, 12: 500, 17: 500, 21: 500}, 6, 23, 18, torch.float64, 0),
}


def _edge_case(dev, shape):
    """(state, rule, theta, solver arguments, keywords) of one _EDGE_SHAPES entry."""
    sizes, d, cap, S, dtype, emptied = _EDGE_SHAPES[shape]
    rng = np.random.default_rng(13)
    kern = K.RBFKernel(torch.tensor((0.8,), dtype=dtype, device=dev), "matern52")
    parts = []
    for n, count in sizes.items():
        X = rng.uniform(-1.0, 1.0, (count, n, d))
        parts.append(sg.fit(kern, X, np.sin(2.0 * X.sum(axis=-1)), capacity=cap,
                            noise=1e-3 if dtype == torch.float32 else 1e-4,
                            device=dev, dtype=dtype))
    cat = {f: torch.cat([getattr(p, f) for p in parts])
           for f in ("X", "y", "L", "c", "n", "Li")}
    st = sg.SurrogateState(kern, noise=parts[0].noise, **cat)
    rule, theta = dr.EI(), 0.0
    if emptied:
        # LCB does not read the incumbent, which a lane without data lacks
        n = st.n.clone()
        n[:emptied] = 0
        st, rule, theta = st._replace(n=n), dr.DecisionRule("LCB"), 0.5
    L = st.X.shape[0]
    lo, hi = -np.ones(d), np.ones(d)
    starts = qmc.generate_initial_guesses(S - 2, lo, hi) if S > 2 else \
        rng.uniform(lo, hi, (S, d))
    xstarts = torch.tensor(starts, dtype=dtype, device=dev)
    lbs = torch.full((d,), -1.0, dtype=dtype, device=dev)
    th = torch.full((L, 1), theta, dtype=dtype, device=dev)
    args = (st.X, st.Li, st.c, st.n, sg.get_active_minimum(st), th[:, 0].contiguous(),
            st.kernel.theta[0], lbs, -lbs, xstarts)
    return st, rule, th, args, dict(kind="matern52", rule=rule.name, iterations=6)


def _meets_criteria(st, rule, th, args, kw, xk, vk):
    """Criteria (a) and (b) of the module docstring against the plain version."""
    xr, vr = nl.newton_solve_lanes_ref(*args, **kw)
    L, d = st.X.shape[0], st.X.shape[2]
    assert xk.shape == (L, d) and vk.shape == (L,)
    vk_cross = sg.acquisition(st, rule, xk, th)
    vr_cross = sg.acquisition(st, rule, xr, th)
    f32 = st.X.dtype == torch.float32
    torch.testing.assert_close(vk, vk_cross, rtol=2e-3 if f32 else 1e-6,
                               atol=1e-6 if f32 else 1e-9)
    slack = (5e-4 if f32 else 1e-6) * vr_cross.abs().clamp(min=1.0) + 1e-6
    assert torch.all(vk_cross >= vr_cross - slack)


@pytest.mark.parametrize("shape", sorted(_EDGE_SHAPES))
def test_kernel_at_the_edges_of_the_block_layout(dev, shape):
    """One and many starts per warp, a last block that is not full, a lane
    without data beside a full one, and the shared-memory edge: the same
    criteria (a) and (b) against the plain version."""
    st, rule, th, args, kw = _edge_case(dev, shape)
    before = nl.LAUNCHES
    xk, vk = nl.newton_solve_lanes(*args, **kw)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before + 1
    _meets_criteria(st, rule, th, args, kw, xk, vk)


def test_lane_block_at_the_nonmyopic_shape_repeats_bit_for_bit(dev):
    """The non-myopic loop's solve (2000 lanes, capacity 23, d 6, 16 + 2
    starts) takes the lane block: two launches on the same inputs agree bit
    for bit (every sum in a fixed order, no atomics), both count in
    LANE_BLOCK_LAUNCHES, and the result meets criteria (a) and (b)."""
    st, rule, th, args, kw = _edge_case(dev, "nonmyopic_loop_2000_lanes_capacity_23")
    L, cap, d = st.X.shape
    assert nl._block_shape(cap, d, 18, 8, L, sms=nl._sm_count(dev.index or 0)).slots == 18
    before = (nl.LAUNCHES, nl.LANE_BLOCK_LAUNCHES)
    x1, v1 = nl.newton_solve_lanes(*args, **kw)
    x2, v2 = nl.newton_solve_lanes(*args, **kw)
    torch.cuda.synchronize()
    assert (nl.LAUNCHES, nl.LANE_BLOCK_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert torch.equal(x1, x2) and torch.equal(v1, v2)
    _meets_criteria(st, rule, th, args, kw, x1, v1)


@pytest.mark.parametrize("rule_name,theta", [("EI", 0.0), ("LCB", 2.0), ("POI", 0.0)])
def test_multistart_maximize_card_matches_cpu_route(dev, rule_name, theta):
    """One surrogate, S starts: one launch on the card, and the same argmax
    as the plain version on the CPU (float64: 1e-6 of the box width)."""
    from rollout_bo_tpu_torch.models import testfns

    f = testfns.get_function("hartmann3d")
    X = np.random.default_rng(2).uniform(f.lbs, f.ubs, (9, 3))
    y = f.batch(torch.tensor(X)).numpy()
    xstarts = qmc.generate_initial_guesses(14, f.lbs, f.ubs)
    rule = dr.RULES[rule_name]()
    out = {}
    for device in (dev, torch.device("cpu")):
        st = sg.fit(K.matern52((0.4,), device=device), X, y, capacity=20, noise=1e-6,
                    device=device)
        before = nl.LAUNCHES
        out[device.type] = solvers.multistart_maximize(st, rule, (theta,), f.lbs, f.ubs,
                                                       xstarts, iterations=12)
        assert nl.LAUNCHES == before + (device.type == "cuda")
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.x.device.type == "cuda" and gpu.x.shape == (3,) and gpu.value.shape == ()
    if rule.solve_f_tol:     # the loose freeze may stop a start an iteration apart
        assert float(gpu.value) >= float(cpu.value) - rule.solve_f_tol * (
            abs(float(cpu.value)) + 1.0)
    else:
        torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-6)
        torch.testing.assert_close(gpu.value.cpu(), cpu.value, rtol=1e-6, atol=1e-9)


def test_random_rule_draws_the_same_stream_on_the_card(dev):
    st = {d.type: sg.fit(K.matern52(device=d), np.zeros((1, 2)), np.zeros(1), capacity=4,
                         device=d) for d in (dev, torch.device("cpu"))}
    draw = lambda s: solvers.multistart_maximize(
        s, dr.RandomAcquisition(), (0.0,), [0.0, -1.0], [1.0, 3.0], np.zeros((2, 2)),
        generator=torch.Generator().manual_seed(4))
    before = nl.LAUNCHES
    gpu, cpu = draw(st["cuda"]), draw(st["cpu"])
    assert nl.LAUNCHES == before and gpu.x.device.type == "cuda"
    assert torch.equal(gpu.x.cpu(), cpu.x)


def test_myopic_bo_on_the_card_matches_cpu_route(dev):
    """Through its chunk program (a CUDA graph of one BO iteration): one
    lane-kernel launch per BO iteration besides the warm-up runs of the
    capture, and the CPU route's points."""
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    f = testfns.get_function("hartmann3d")
    x_init = np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, 3))
    before, warm = nl.LAUNCHES, graphs.WARMUP_LAUNCHES
    gpu = bo.run_myopic_bo(f, dr.EI(), budget=4, num_starts=8, x_init=x_init, device=dev)
    launches = nl.LAUNCHES - before - (graphs.WARMUP_LAUNCHES - warm)
    assert launches == 4 and gpu.state.X.device.type == "cuda"
    cpu = bo.run_myopic_bo(f, dr.EI(), budget=4, num_starts=8, x_init=x_init, device="cpu")
    np.testing.assert_allclose(gpu.X, cpu.X, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(float(gpu.state.kernel.theta[0]),
                               float(cpu.state.kernel.theta[0]), rtol=1e-6)


# --------------------------------------------------------------------------
# the cost-aware route: the torch newton_solve_batch, never the kernel
# --------------------------------------------------------------------------


def _cost_rule():
    from rollout_bo_tpu_torch.models import cost_functions as cf

    return cf.cost_aware(dr.EI(), cf.NonUniformCost(lambda x: 1.0 + torch.sum(x * x)))


def _hartmann3d_state(device, lanes=()):
    from rollout_bo_tpu_torch.models import testfns

    f = testfns.get_function("hartmann3d")
    X = np.random.default_rng(2).uniform(f.lbs, f.ubs, lanes + (9, 3))
    y = f.batch(torch.tensor(X)).numpy()
    return f, sg.fit(K.matern52((0.4,), device=device), X, y, capacity=14, noise=1e-6,
                     device=device)


def test_newton_solve_batch_card_matches_cpu_route(dev):
    """A small lane batch (3 lanes x 10 starts) with a cost-aware rule: the
    same per-start solutions on the card as on the CPU (float64, 1e-6 of
    the box width), and no kernel launch."""
    out = {}
    for device in (dev, torch.device("cpu")):
        f, st = _hartmann3d_state(device, (3,))
        xstarts = qmc.generate_initial_guesses(8, f.lbs, f.ubs)
        before = nl.LAUNCHES
        out[device.type] = solvers.newton_solve_batch(
            st, _cost_rule(), torch.zeros((3, 1), dtype=torch.float64, device=device),
            f.lbs, f.ubs, xstarts, iterations=12)
        assert nl.LAUNCHES == before
    (xg, vg), (xc, vc) = out["cuda"], out["cpu"]
    assert xg.device.type == "cuda" and xg.shape == (3, 10, 3) and vg.shape == (3, 10)
    torch.testing.assert_close(xg.cpu(), xc, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-6, atol=1e-12)


def test_cost_aware_multistart_maximize_card_matches_cpu_route(dev):
    from rollout_bo_tpu_torch.models import testfns

    f = testfns.get_function("hartmann3d")
    xstarts = qmc.generate_initial_guesses(14, f.lbs, f.ubs)
    out = {}
    for device in (dev, torch.device("cpu")):
        _, st = _hartmann3d_state(device)
        before = nl.LAUNCHES
        out[device.type] = solvers.multistart_maximize(st, _cost_rule(), (0.0,), f.lbs, f.ubs,
                                                       xstarts, iterations=12)
        assert nl.LAUNCHES == before
    torch.testing.assert_close(out["cuda"].x.cpu(), out["cpu"].x, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(out["cuda"].value.cpu(), out["cpu"].value, rtol=1e-6,
                               atol=1e-12)


def test_maximize_hot_never_launches_the_kernel_for_a_cost_aware_rule(dev):
    """A CostAwareRule keeps the name "EI", which the kernel supports: the
    routing must send it to newton_solve_batch all the same."""
    f, st = _hartmann3d_state(dev, (2, 3))
    rule = _cost_rule()
    assert rule.name == "EI" and nl.supported("matern52", rule.name)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=dev)
    before = nl.LAUNCHES
    x, v = solvers.maximize_hot(st, rule, torch.zeros((2, 3, 1), dtype=torch.float64,
                                                      device=dev),
                                t(f.lbs), t(f.ubs), t(qmc.generate_initial_guesses(6, f.lbs,
                                                                                   f.ubs)),
                                iterations=6)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before
    assert x.shape == (2, 3, 3) and bool(torch.all(torch.isfinite(v)))
    x, v = solvers.maximize_hot(st, dr.EI(), torch.zeros((2, 3, 1), dtype=torch.float64,
                                                         device=dev),
                                t(f.lbs), t(f.ubs), t(qmc.generate_initial_guesses(6, f.lbs,
                                                                                   f.ubs)),
                                iterations=6)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before + 1                  # the plain rule takes the kernel


# --------------------------------------------------------------------------
# the sharded path on the card: ranks of torch.distributed, each launching
# the kernel on its share of the lanes (tests/torch_parallel_ranks.py)
# --------------------------------------------------------------------------


def _sharded_vs_unsharded(dev, tmp_path, monkeypatch, world, backend, shapes,
                          kinds=("fused",)):
    """The sharded solves of the worker's problem (float64, h 1; the fused
    one, and the batch and scanned ones where `kinds` names them) on `world`
    ranks at each mesh shape, against the same solve with no mesh on the
    card, its simulate calls split into the blocks of restarts and
    trajectories that the ranks launch (`torch_parallel_ranks.blocked`; the
    batch solve splits its restarts only):
    equal to 1e-12, and for the fused solve per rank h x (SGA iterations +
    1) launches (on an NCCL mesh the solves run as CUDA graphs, whose
    warm-up runs are taken off).

    The blocks are needed on the card: cuBLAS picks its batched-GEMM
    kernel by the batch, so the trajectory's dense products round
    differently at 64 and at 128 lanes. When the float64 lane solver still
    took W = Li^T Li, formed by one such product (2.4e-11 apart between the
    two batch sizes on this problem, measured on an H100), that moved the
    multistart Newton solve's discrete choices (a backtracking step taken
    or not, one of two nearly tied local maxima) and one trajectory's
    reward with them: a value moved by 6e-3 relative against the unblocked
    128-lane solve. It now reads Li itself; chip_smoke.py phase 10 prints
    the unblocked difference beside the blocked gate. On the CPU the lanes
    round alike in any batch (test_torch_parallel.py holds the sharded
    solves to the unblocked one)."""
    import torch_parallel_ranks as ranks

    from rollout_bo_tpu_torch.rollout import mc as mc_mod

    p = ranks.worker_fields()
    kws = dict(fused=dict(max_iters=4, inner_iterations=10),
               batch=dict(max_iters=4, inner_iterations=10),
               scanned=dict(max_iters=3, steps_per_call=2, inner_iterations=10))
    problems = {f"{kind}_m{r}x{m}": (kind, (r, m), p, kws[kind])
                for kind in kinds for r, m in shapes}
    out = ranks.Ranks(ranks.solve_case, world, str(tmp_path), backend=backend,
                      problems=problems, device="cuda").result()
    simulate = mc_mod.simulate_trajectory_mc
    for name, (kind, (r, m), _, kw) in problems.items():
        # the batch solve keeps the stream whole on every rank (its restarts
        # alone are split), so its launches are blocked by restarts only
        blocks = (r, 1) if kind == "batch" else (r, m)
        monkeypatch.setattr(mc_mod, "simulate_trajectory_mc", ranks.blocked(simulate, *blocks))
        before = nl.LAUNCHES
        ref = ranks.unsharded_solve(kind, p, kw, device=dev)
        xs, vals = (ref.x, ref.value) if kind == "fused" else ref
        np.testing.assert_allclose(out[f"{name}_xs"], xs.cpu().numpy(), rtol=1e-12,
                                   atol=1e-14, err_msg=name)
        np.testing.assert_allclose(out[f"{name}_vals"], vals.cpu().numpy(), rtol=1e-12,
                                   atol=1e-14, err_msg=name)
        if kind == "fused":
            assert nl.LAUNCHES - before == r * m * (ref.iterations + 1)
            assert int(out[f"{name}_it"]) == ref.iterations
            assert out[f"{name}_launches"].tolist() == [ref.iterations + 1] * world, name


def test_sharded_fused_solve_on_an_nccl_group_of_one(dev, tmp_path, monkeypatch):
    _sharded_vs_unsharded(dev, tmp_path, monkeypatch, 1, "nccl", [(1, 1)])


def test_sharded_fused_solve_on_two_gloo_ranks_sharing_the_card(dev, tmp_path, monkeypatch):
    _sharded_vs_unsharded(dev, tmp_path, monkeypatch, 2, "gloo", [(2, 1), (1, 2)])


def test_sharded_fused_solve_on_two_nccl_ranks_on_two_cards(dev, tmp_path, monkeypatch):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL runs one rank per card")
    _sharded_vs_unsharded(dev, tmp_path, monkeypatch, 2, "nccl", [(2, 1), (1, 2)],
                          kinds=("fused", "batch", "scanned"))


_SHARDED_KW = dict(simulate=dict(iterations=10), batch=dict(max_iters=4, inner_iterations=10),
                   fused=dict(max_iters=4, inner_iterations=10),
                   scanned=dict(max_iters=3, steps_per_call=2, inner_iterations=10),
                   ghq=dict(horizon=1, num_nodes=4, max_iters=3, inner_iterations=10))


def test_sharded_programs_replay_the_eager_mesh_route_on_an_nccl_group_of_one(dev, tmp_path):
    """Every sharded program (the simulate call, the batch, fused, scanned
    and Gauss-Hermite solves) on an NCCL group of one rank, its graphs
    holding the world all-reduces: the replays equal the eager mesh route
    bit for bit, and the launches (warm-up runs off) are 1 per simulate
    call and h x (SGA iterations + 1) per fused solve (h 1)."""
    import torch_parallel_ranks as ranks

    p = ranks.worker_fields()
    problems = {kind: (kind, (1, 1), p, kw) for kind, kw in _SHARDED_KW.items()}
    out = ranks.Ranks(ranks.sharded_programs_case, 1, str(tmp_path), backend="nccl",
                      problems=problems, device="cuda").result()
    for kind in problems:
        outputs = [k for k in out if k.startswith(f"{kind}_prog")]
        assert outputs, kind
        for key in outputs:
            assert np.array_equal(out[key], out[key.replace("_prog", "_eager")],
                                  equal_nan=True), key
        assert int(out[f"{kind}_it"]) == int(out[f"{kind}_eager_it"]), kind
    assert out["simulate_launches"].tolist() == [1]
    assert out["fused_launches"].tolist() == [int(out["fused_it"]) + 1]


def test_a_program_on_a_gloo_mesh_on_the_card_raises(dev, tmp_path):
    """A gloo collective runs on the host, so no graph holds it: a program
    asked for on a gloo mesh with CUDA tensors raises, naming --backend
    nccl, and the BO loop on such a mesh takes no acquisition program."""
    import torch_parallel_ranks as ranks

    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
    from rollout_bo_tpu_torch.rollout import bo, outer
    from rollout_bo_tpu_torch.utils import graphs

    mesh_mod.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo")
    try:
        mesh = mesh_mod.make_mesh()
        assert mesh.backend == "gloo" and not mesh.capturable
        st, tp, xstarts, _ = ranks.port_problem(ranks.worker_fields(), dev)
        with pytest.raises(ValueError, match="--backend nccl"):
            outer.make_fused_sga_program(st, tp, dr.EI(), xstarts, mesh=mesh)
        with pytest.raises(ValueError, match="--backend nccl"):
            outer.make_deterministic_program(st, tp.theta, tp.lbs, tp.ubs, xstarts, dr.EI(),
                                             horizon=1, mesh=mesh)
        keys = set(graphs.PROGRAM_CACHE)
        f = testfns.get_function("gramacylee")
        bo.run_nonmyopic_bo(f, horizon=1, mc_iters=4, budget=1, num_starts=4, num_restarts=2,
                            sgd_iters=2, device=dev, mesh=mesh)
        assert not [k for k in set(graphs.PROGRAM_CACHE) - keys if k[0] == "nm_acquire"]
    finally:
        mesh_mod.finalize_distributed()


def test_mesh_collectives_issue_no_host_sync(dev, tmp_path):
    """`all_reduce_sum`, `gather_leading` and `broadcast` on an NCCL group of
    one under `set_sync_debug_mode("error")`: no host read."""
    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        mesh = mesh_mod.make_mesh()
        x = torch.arange(6.0, device=dev).reshape(3, 2)
        mesh_mod.all_reduce_sum(x, mesh)       # NCCL makes its communicator here
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            s = mesh_mod.all_reduce_sum(x, mesh)
            g = mesh_mod.gather_leading(x, mesh, mesh_mod.AXES)
            b = mesh_mod.broadcast(x, mesh)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(s, x) and torch.equal(g, x) and torch.equal(b, x)
    finally:
        mesh_mod.finalize_distributed()


def test_finalize_resets_the_collective_graphs_a_rank_still_holds(dev, tmp_path):
    """A rank that still holds a mesh program leaves its NCCL group: NCCL
    keeps a communicator while a graph that holds its collectives lives,
    so `finalize_distributed` resets those graphs before the destroy. The
    rank ends within the deadline, and the held program raises when called
    after it."""
    import time

    import torch.multiprocessing as mp

    import torch_parallel_ranks as ranks

    out = tmp_path / "held.npz"
    ctx = mp.start_processes(ranks.held_program_rank,
                             args=(f"file://{tmp_path / 'store'}", str(out)), nprocs=1,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the rank did not leave its NCCL group"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    with np.load(out) as z:
        assert str(z["raised"]), "the held program replayed after the group was destroyed"


def test_nccl_refuses_two_ranks_on_one_card(dev):
    from rollout_bo_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.check_backend("nccl", torch.cuda.device_count())
    with pytest.raises(RuntimeError, match="--backend gloo"):
        mesh_mod.check_backend("nccl", torch.cuda.device_count() + 1)


# --------------------------------------------------------------------------
# the SGA programs: CUDA graphs against the eager route
# --------------------------------------------------------------------------

PROGRAMS = ("make_batched_grad_step", "make_batched_sga_step", "make_scanned_sga_program",
            "make_fused_sga_program")


def _program_problem(dev, dtype, restarts=4):
    """bench_torch.bench_problem cut small: trid2d, h 2, 8 trajectories."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench_torch

    return bench_torch.bench_problem(dev, dtype, name="trid2d", n_obs=6, capacity=10, mc=8,
                                     horizon=2, starts=4, restarts=restarts)


def _same(a, b):
    """Two results (nested tuples of tensors) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _tensors(x)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("factory", PROGRAMS)
def test_program_replays_equal_the_eager_route(dev, factory, dtype):
    """Each factory's program against its eager route: the fused program
    against `stochastic_solve_fused` with no program, the others against
    their own function run eagerly. Per call: the same result bit for bit;
    a replay launches the lane kernel as often as the eager route (horizon
    2 per simulate), and a call that captures as often besides its warm-up
    runs' launches; a second call on a new stream equals the eager route
    on that stream and leaves the first call's tensors as they were (no
    aliasing); three restarts instead of four capture a second graph."""
    from rollout_bo_tpu_torch.rollout import outer
    from rollout_bo_tpu_torch.utils import graphs

    st, tp, xstarts, restarts = _program_problem(dev, dtype)
    rule, kw = dr.EI(), dict(lr=0.05, inner_iterations=6)
    z2 = torch.tensor(np.random.default_rng(7).standard_normal(tuple(tp.rnstream.shape)),
                      dtype=dtype, device=dev)
    if factory == "make_batched_grad_step":
        kw.pop("lr")
    extra = {"make_scanned_sga_program": dict(steps_per_call=3),
             "make_fused_sga_program": dict(max_iters=5, select_best=True)}.get(factory, {})
    prog = getattr(outer, factory)(st, tp, rule, xstarts, **kw, **extra)
    graph = prog.step if factory == "make_fused_sga_program" else getattr(prog, "_fn", prog)
    captured = lambda: sum(g.captures for g in getattr(prog, "graphs", (prog,)))  # noqa: E731

    def carry(xs):
        return (xs, outer.adam_init(xs), torch.zeros(xs.shape[0], dtype=torch.bool, device=dev),
                torch.zeros(xs.shape[0], dtype=dtype, device=dev))

    def args(z, xs):
        return (st, z, xs if factory in ("make_batched_grad_step", "make_fused_sga_program")
                else carry(xs))

    def eager(z, xs):
        if factory == "make_fused_sga_program":
            res = outer.stochastic_solve_fused(st, tp._replace(rnstream=z), rule, xstarts, xs,
                                               **kw, **extra)
            return (res.x, res.value), res.iterations
        return graph.fn(*args(z, xs)), None

    def call(z, xs):
        captures, warm0, before = captured(), graphs.WARMUP_LAUNCHES, nl.LAUNCHES
        out = prog(*args(z, xs))
        torch.cuda.synchronize()
        launches, warm = nl.LAUNCHES - before, graphs.WARMUP_LAUNCHES - warm0
        before = nl.LAUNCHES
        want, its = eager(z, xs)
        torch.cuda.synchronize()
        eager_launches = nl.LAUNCHES - before
        if captured() == captures:
            assert warm == 0 and launches == eager_launches > 0
        else:
            # the fused program warms up a step's graph and the final pass's
            per_run = 2 * tp.horizon if factory == "make_fused_sga_program" else eager_launches
            assert warm == graphs.WARMUP * per_run and launches - warm == eager_launches > 0
        assert _same(out, want), factory
        if its is not None:
            assert prog.iterations == its
        return out

    first = call(tp.rnstream, restarts)
    kept = [t.clone() for t in _tensors(first)]
    second = call(z2, restarts)
    assert not _same(first, second)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(first), kept))
    assert not {t.data_ptr() for t in _tensors(first)} & {t.data_ptr() for t in _tensors(second)}
    assert graph.captures == 1
    call(tp.rnstream, restarts[:3].contiguous())
    assert graph.captures == 2


@pytest.mark.parametrize("solver", ["scanned", "stepped"])
def test_solvers_with_programs_equal_the_eager_loop(dev, solver):
    """`stochastic_solve_scanned(program=)` and `stochastic_solve_stepped(
    sga_step=)` against the same solvers with no program: bit for bit."""
    from rollout_bo_tpu_torch.rollout import outer

    st, tp, xstarts, restarts = _program_problem(dev, torch.float64)
    kw = dict(lr=0.05, inner_iterations=6)
    if solver == "scanned":
        prog = outer.make_scanned_sga_program(st, tp, dr.EI(), xstarts, steps_per_call=2, **kw)
        got = outer.stochastic_solve_scanned(st, tp, dr.EI(), xstarts, restarts, max_iters=5,
                                             program=prog, **kw)
        want = outer.stochastic_solve_scanned(st, tp, dr.EI(), xstarts, restarts, max_iters=5,
                                              steps_per_call=2, **kw)
    else:
        step = outer.make_batched_sga_step(st, tp, dr.EI(), xstarts, **kw)
        got = outer.stochastic_solve_stepped(st, tp, dr.EI(), xstarts, restarts, max_iters=5,
                                             sync_every=2, sga_step=step, **kw)
        want = outer.stochastic_solve_stepped(st, tp, dr.EI(), xstarts, restarts, max_iters=5,
                                              sync_every=2, **kw)
    torch.cuda.synchronize()
    assert _same(got, want)


def test_graph_program_raises_on_a_host_sync_and_never_runs_eagerly(dev):
    """A function that reads a tensor on the host cannot be captured: the
    capture raises, and so does every later call (no eager fallback)."""
    from rollout_bo_tpu_torch.utils import graphs

    calls = []

    def fn(x):
        calls.append(1)
        return x * float(x.sum())

    prog = graphs.GraphProgram(fn, device=dev)
    x = torch.ones(4, device=dev)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            prog(x)
        torch.cuda.synchronize()
    assert prog.captures == 0 and len(calls) == 2 * (graphs.WARMUP + 1) == 8


def test_bo_loop_takes_one_cached_program_on_the_card(dev, monkeypatch):
    """A small non-myopic trial on the card through the program cache: one
    acquisition program for the trial, captured once, reused by a second
    trial (and one observe program, the MLE's graph captured once); the
    points equal the eager loop's bit for bit."""
    from rollout_bo_tpu_torch.models import testfns
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())
    f = testfns.get_function("hartmann3d")
    kw = dict(horizon=1, mc_iters=8, budget=2, num_starts=8, num_restarts=2, sgd_iters=3,
              lr=0.05, solver_iterations=8, device=dev,
              x_init=np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim)))
    res = bo.run_nonmyopic_bo(f, **kw)
    programs = {key[0]: p for key, p in graphs.PROGRAM_CACHE.items()}
    assert set(programs) == {"nm_acquire", "nm_observe", "nm_fallback"}
    program = programs["nm_acquire"]
    assert [g.captures for g in program.graphs] == [1, 1]
    again = bo.run_nonmyopic_bo(f, **kw)
    assert [g.captures for g in program.graphs] == [1, 1]
    assert programs["nm_observe"].captures == 1
    acquirer = bo._rollout_acquirer
    monkeypatch.setattr(bo, "_rollout_acquirer",      # the eager loop: no program key
                        lambda *a, **k: acquirer(*a, **dict(k, program_key=None)))
    eager = bo.run_nonmyopic_bo(f, **kw)
    np.testing.assert_array_equal(res.X, eager.X)
    np.testing.assert_array_equal(again.X, eager.X)


# --------------------------------------------------------------------------
# the BO loops' other programs: observe, myopic chunk, fallback, batch and
# Gauss-Hermite acquisitions; the test functions and the MLE in a capture
# --------------------------------------------------------------------------


def _bo_state(dev, dtype=torch.float64, n=12, cap=16, noise=1e-6, name="hartmann6d"):
    f = testfns.get_function(name)
    X = np.random.default_rng(2).uniform(f.lbs, f.ubs, (n, f.dim))
    st = sg.fit(K.matern52(device=dev, dtype=dtype), X, f.batch(torch.tensor(X)).numpy(),
                capacity=cap, noise=noise, device=dev, dtype=dtype)
    return f, st


def _nan_equal(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("name", sorted(testfns.FUNCTION_REGISTRY))
def test_every_test_function_evaluates_inside_a_capture(dev, name):
    """After one eager call, the function captures in a CUDA graph with
    host synchronization an error, and the replay equals the eager value."""
    f = testfns.get_function(name)
    x = torch.tensor(np.random.default_rng(1).uniform(f.lbs, f.ubs, (4, f.dim)),
                     dtype=torch.float64, device=dev)
    want = f.f(x)
    static = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = f.f(static)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("pd", [True, False])
def test_optimize_hypers_captures_and_keeps_the_nan_contract(dev, pd):
    """The MLE (60 Adam steps of autograd through `cholesky_ex`) as a
    program: it captures with host synchronization an error, and its
    replays equal the eager refit bit for bit. With a negative noise K is
    positive definite at no theta: every step's gradient is zeroed, theta
    stays where it was and the returned factors are NaN, in the graph as
    eagerly."""
    from rollout_bo_tpu_torch.utils import graphs

    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    _, st = _bo_state(dev)
    if not pd:
        st = st._replace(noise=t(-5.0))
    klbs, kubs = t((0.1,)), t((5.0,))
    prog = graphs.GraphProgram(lambda s: sg.optimize_hypers(s, klbs, kubs), device=dev)
    for theta in (0.7, 1.3):
        s = st._replace(kernel=st.kernel.replace_theta(t((theta,))))
        got = prog(s)
        want = sg.optimize_hypers(s, klbs, kubs)
        torch.cuda.synchronize()
        for name in ("L", "Li", "c"):
            assert _nan_equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(got.kernel.theta, want.kernel.theta)
        if pd:
            assert torch.isfinite(got.L).all() and float(got.kernel.theta[0]) != theta
        else:
            assert torch.isnan(got.L).all() and float(got.kernel.theta[0]) == theta
    assert prog.captures == 1


@pytest.mark.parametrize("do_mle", [True, False])
def test_observe_program_replays_equal_the_eager_route(dev, do_mle):
    """The observe program (true function, condition, MLE when due) on two
    new points: each replay equals the function run eagerly, bit for bit;
    one capture for the MLE constant."""
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    f, st = _bo_state(dev)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    fn = bo._observer(f, t((0.1,)), t((5.0,)))
    prog = graphs.GraphProgram(fn, device=dev)
    for seed in (0, 1):
        x = t(np.random.default_rng(seed).uniform(f.lbs, f.ubs))
        got, want = prog(st, x, do_mle), fn(st, x, do_mle)
        torch.cuda.synchronize()
        assert _same(_tensors((got[0][1:], got[0].kernel.theta, got[1])),
                     _tensors((want[0][1:], want[0].kernel.theta, want[1])))
    assert prog.captures == 1


@pytest.mark.parametrize("rule_name", ["EI", "Random"])
def test_myopic_chunk_replays_equal_the_eager_route(dev, monkeypatch, rule_name):
    """A myopic trial (hartmann3d, budget 4) in chunks of 1 and of the whole
    budget: the points and fitted lengthscale of the eager route (every
    program's function called eagerly), bit for bit; the lane kernel
    launched k times per chunk of k for EI (none for Random), besides the
    warm-up runs of the capture; one solve program and one observe program
    for both chunk lengths."""
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())
    f = testfns.get_function("hartmann3d")
    kw = dict(budget=4, num_starts=8, device=dev,
              x_init=np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim)))
    rule = dr.RULES[rule_name]()
    with monkeypatch.context() as m:
        m.setattr(graphs.GraphProgram, "__call__", lambda self, *a: self.fn(*a))
        eager = bo.run_myopic_bo(f, rule, **kw)
    for k in (1, 4):
        before, warm = nl.LAUNCHES, graphs.WARMUP_LAUNCHES
        res = bo.run_myopic_bo(f, rule, steps_per_call=k, **kw)
        torch.cuda.synchronize()
        launches = nl.LAUNCHES - before - (graphs.WARMUP_LAUNCHES - warm)
        assert launches == (0 if rule_name == "Random" else 4), k
        np.testing.assert_array_equal(res.X, eager.X)
        assert torch.equal(res.state.kernel.theta, eager.state.kernel.theta)
    (chunk,) = [p for key, p in graphs.PROGRAM_CACHE.items() if key[0] == "myopic_chunk"]
    (observe,) = [p for key, p in graphs.PROGRAM_CACHE.items() if key[0] == "nm_observe"]
    # one graph of the solve; one of the observe step per MLE constant: EI
    # refits every iteration, Random never
    assert chunk.captures == 1 and observe.captures == 1


def test_fallback_program_replays_equal_the_eager_route(dev):
    """The exploration fallback as a program (the lane kernel's LogEI solve
    and the max-sigma explorer, selected on the device): equal to the
    function run eagerly on two states, one capture."""
    from rollout_bo_tpu_torch.ops import qmc as q
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    f, st = _bo_state(dev)
    t = lambda a: torch.tensor(np.array(a), dtype=torch.float64, device=dev)  # noqa: E731
    fn = bo._make_exploration_fallback(dr.EI(), t([0.0]), t(f.lbs), t(f.ubs),
                                       t(q.generate_initial_guesses(16, f.lbs, f.ubs)), 12)
    prog = graphs.GraphProgram(fn, device=dev)
    for s in (st, sg.condition(st, t([0.5] * f.dim), t(-1.0))):
        got, want = prog(s), fn(s)
        torch.cuda.synchronize()
        assert _same(got, want)
    assert prog.captures == 1


def test_deterministic_program_replays_equal_the_eager_route(dev):
    """`make_deterministic_program(select_best=True)` against
    `deterministic_solve_batch` and its argmax (trid2d, h 1, 4 nodes): the
    same winner and value bit for bit, on two restart sets; one capture per
    graph."""
    from rollout_bo_tpu_torch.rollout import outer

    st, tp, xstarts, restarts = _program_problem(dev, torch.float64)
    kw = dict(horizon=1, num_nodes=4, max_iters=4, lr=0.05, inner_iterations=6)
    prog = outer.make_deterministic_program(st, tp.theta, tp.lbs, tp.ubs, xstarts, dr.EI(),
                                            select_best=True, **kw)
    for starts in (restarts, restarts.flip(0).contiguous()):
        x, v = prog(st, starts)
        xs, vals = outer.deterministic_solve_batch(st, tp.theta, tp.lbs, tp.ubs, xstarts,
                                                   starts, dr.EI(), **kw)
        torch.cuda.synchronize()
        j = int(torch.argmax(vals))
        assert torch.equal(x, xs[j]) and torch.equal(v, vals[j])
    assert [g.captures for g in prog.graphs] == [1, 1]


@pytest.mark.parametrize("solver", ["batch", "ghq"])
def test_nonmyopic_batch_and_ghq_trials_equal_the_eager_loop(dev, monkeypatch, solver):
    """A small non-myopic trial with the batch or the Gauss-Hermite solver
    through the program cache (acquisition, observe and fallback programs)
    against the same trial in the eager loop with every program run
    eagerly: the points bit for bit."""
    from rollout_bo_tpu_torch.rollout import bo
    from rollout_bo_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())
    f = testfns.get_function("hartmann3d")
    kw = dict(horizon=1, mc_iters=8, budget=2, num_starts=8, num_restarts=2, sgd_iters=3,
              lr=0.05, solver_iterations=8, device=dev, ghq_nodes=3,
              deterministic=solver == "ghq", outer_solver="batch",
              x_init=np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim)))
    res = bo.run_nonmyopic_bo(f, **kw)
    acquirer = bo._rollout_acquirer
    with monkeypatch.context() as m:
        m.setattr(graphs.GraphProgram, "__call__", lambda self, *a: self.fn(*a))
        m.setattr(bo, "_rollout_acquirer",
                  lambda *a, **k: acquirer(*a, **dict(k, program_key=None)))
        eager = bo.run_nonmyopic_bo(f, **kw)
    np.testing.assert_array_equal(res.X, eager.X)
    assert torch.equal(res.state.kernel.theta, eager.state.kernel.theta)
    (observe,) = [p for key, p in graphs.PROGRAM_CACHE.items() if key[0] == "nm_observe"]
    assert observe.captures == 1
