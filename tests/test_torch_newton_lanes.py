"""PyTorch port, the Newton lane solver: plain version vs the JAX kernel.

The JAX kernel (`rollout_bo_tpu/ops/pallas_newton.py::newton_solve_lanes`)
runs in Pallas interpret mode on the CPU, as tests/test_pallas_newton.py
runs it; the port's CPU route is the plain version
`newton_solve_lanes_ref`. Both see the same lanes (the JAX package's
states, carried across as numpy arrays): the JAX kernel takes W = Li^T Li,
the port each lane's Li, from which it forms W itself in float32 and reads
Li in float64 (the JAX XLA solver's form). The criteria and tolerances are
those of test_pallas_solve_matches_xla_solver:
(a) the solver's value matches a plain re-evaluation of the acquisition at
    its argmax (f32: rtol 2e-3; log rules atol 2e-3 in log space, where
    the k0 - kx.K^{-1}kx variance form amplifies f32 op-order noise);
(b) its solution is never worse than the JAX kernel's beyond 5e-4
    relative (a tiny fp difference may flip a backtracking accept into a
    better basin, never a much worse one) — or, on a lane where the JAX
    kernel beats the JAX XLA solver too, never worse than that solver. The
    JAX kernel's f32 erf polynomial has an error floor of ~1e-7 in Phi, so
    on an EI plateau where the exact Phi underflows it sees a gradient that
    the exact-erf solvers (the XLA solver and this port) do not, and may
    climb out of it; the port is held to the same exact-erf solver there.
The float64 loose-POI case holds the port to the JAX XLA solver at rtol
1e-6, as the JAX package holds its kernel.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import pallas_newton as pn
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import solvers as jsolvers
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.rollout import solvers

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)


def _jax_states(L, n, d, cap, kernel, seed, dtype, noise=1e-5):
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(L):
        X = rng.uniform(-1.0, 1.0, (n, d))
        y = np.sin(2.0 * X.sum(axis=1)) + 0.2 * rng.standard_normal(n)
        states.append(jsg.fit(kernel, X, y, capacity=cap, noise=noise, dtype=dtype))
    return states


def _lanes(states):
    """Stacked lane arrays of the JAX states: X, W = Li^T Li (what the JAX
    kernel takes), c, n, fmini."""
    X = jnp.stack([s.X for s in states])
    Li = jnp.stack([s.Li for s in states])
    W = jnp.einsum("lji,ljk->lik", Li, Li)
    c = jnp.stack([s.c for s in states])
    n = jnp.stack([s.n for s in states])
    fmini = jnp.stack([jsg.get_active_minimum(s) for s in states])
    return X, W, c, n, fmini


def _torch_lanes(states, dtype):
    """The port's lane arrays of the same states: X, Li, c, n, fmini (the
    port takes Li where the JAX kernel takes W)."""
    X, Li, c, n = (np.stack([np.asarray(getattr(s, f)) for s in states])
                   for f in ("X", "Li", "c", "n"))
    fmini = np.stack([np.asarray(jsg.get_active_minimum(s)) for s in states])
    t = lambda a: torch.tensor(a, dtype=dtype)
    return t(X), t(Li), t(c), torch.tensor(n, dtype=torch.int64), t(fmini)


def _stack(states, lanes):
    """One state with lane axes `lanes` from single-lane states."""
    fields = (torch.stack([getattr(s, f) for s in states]).reshape(
        lanes + getattr(states[0], f).shape) for f in sg.SurrogateState._fields[1:])
    return sg.SurrogateState(states[0].kernel, *fields)


def _port_state(js, dtype):
    return sg.from_numpy_state(js.kernel.kind, js.kernel.theta, js.X, js.y, js.L,
                               js.Li, js.c, js.n, js.noise, device="cpu", dtype=dtype)


def _solve_both(states, rule_name, xstarts, lbs, ubs, iters, dtype, period=1.0,
                f_tol=0.0, x_tol=0.0, th=0.0):
    L = len(states)
    lanes = _lanes(states)
    jdt = lanes[0].dtype
    kth = states[0].kernel.theta
    kind = states[0].kernel.kind
    jx, _ = pn.newton_solve_lanes(
        *lanes, jnp.full((L,), th, jdt), kth[0], lbs, ubs, xstarts, period,
        kind=kind, rule=rule_name, iterations=iters, f_tol=f_tol, x_tol=x_tol,
        interpret=True)
    X, Li, c, n, fmini = _torch_lanes(states, dtype)
    x, v = nl.newton_solve_lanes(
        X, Li, c, n, fmini, torch.full((L,), th, dtype=dtype), float(kth[0]),
        torch.tensor(lbs, dtype=dtype), torch.tensor(ubs, dtype=dtype),
        torch.tensor(xstarts, dtype=dtype), period,
        kind=kind, rule=rule_name, iterations=iters, f_tol=f_tol, x_tol=x_tol)
    return np.asarray(jx), x, v


def _xla_best(states, jrule, jth, lbs, ubs, xstarts, iters):
    """Best start value per lane of the JAX XLA solver, one jitted call."""
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *states)

    def best(st):
        _, vals = jsolvers.newton_solve_batch(st, jrule, jth, lbs, ubs, xstarts,
                                              iterations=iters)
        return jnp.max(vals)

    return np.asarray(jax.jit(jax.vmap(best))(stacked))


def _never_worse(states, jx, x, rule_name, th, xstarts, lbs, ubs, iters, dtype,
                 rtol=5e-4, atol=1e-6):
    """Criterion (b): the port's solution value (re-evaluated) is never worse
    than the lower of the JAX kernel's and the JAX XLA solver's."""
    rule, jrule = dr.RULES[rule_name](), jdr.RULES[rule_name]()
    jth = jnp.asarray([th], states[0].X.dtype)
    v_xla = _xla_best(states, jrule, jth, lbs, ubs, xstarts, iters)
    for i, js in enumerate(states):
        v_cross = float(sg.acquisition(_port_state(js, dtype), rule, x[i],
                                       torch.tensor([th], dtype=dtype)))
        v_kernel = float(jsg.acquisition(js, jrule, jnp.asarray(jx[i]), jth))
        v_ref = min(v_kernel, float(v_xla[i]))
        assert v_cross >= v_ref - rtol * max(1.0, abs(v_ref)) - atol, (i, v_cross, v_ref)


@pytest.mark.parametrize("kind,rule_name", [
    ("matern52", "EI"), ("matern52", "POI"), ("matern52", "LCB"),
    ("matern52", "LogEI"), ("matern52", "LogPOI"),
    ("matern32", "EI"), ("matern12", "EI"), ("squared_exponential", "EI"),
])
def test_plain_version_matches_jax_kernel(kind, rule_name):
    L, n, d, cap, S = 5, 7, 3, 12, 4
    f32 = torch.float32
    kern = jK.RBFKernel(theta=jnp.asarray([0.8], jnp.float32), kind=kind)
    states = _jax_states(L, n, d, cap, kern, 3, jnp.float32)
    lbs, ubs = np.full(d, -1.0), np.full(d, 1.0)
    xstarts = qmc.generate_initial_guesses(S - 2, lbs, ubs).astype(np.float32)
    th = 0.5 if rule_name == "LCB" else 0.0
    jx, x, v = _solve_both(states, rule_name, xstarts, lbs, ubs, 8, f32, th=th)
    assert x.shape == (L, d) and v.shape == (L,) and x.dtype == f32
    rule = dr.RULES[rule_name]()
    theta = torch.tensor([th], dtype=f32)
    for i, js in enumerate(states):
        v_cross = float(sg.acquisition(_port_state(js, f32), rule, x[i], theta))
        atol = 2e-3 if rule_name.startswith("Log") else 1e-6
        np.testing.assert_allclose(float(v[i]), v_cross, rtol=2e-3, atol=atol)
    _never_worse(states, jx, x, rule_name, th, xstarts, lbs, ubs, 8, f32)


def test_plain_version_at_trid10d_scale():
    """The bench function's scale: d = 10, box [-100, 100]^10, float32
    (tests/test_pallas_newton.py::test_pallas_solve_10d_trid_scale)."""
    from rollout_bo_tpu.models import testfns

    f32 = torch.float32
    f = testfns.get_function("trid10d")
    L, n, cap, S = 3, 12, 20, 6
    rng = np.random.default_rng(11)
    states = []
    for _ in range(L):
        X0 = qmc.randsample(n, f.dim, f.lbs, f.ubs, rng)
        states.append(jsg.fit(jK.matern52((1.0,)), X0, np.asarray(f.batch(X0)),
                              capacity=cap, noise=1e-5, dtype=jnp.float32))
    xstarts = qmc.generate_initial_guesses(S - 2, f.lbs, f.ubs).astype(np.float32)
    jx, x, v = _solve_both(states, "EI", xstarts, f.lbs, f.ubs, 10, f32)
    theta = torch.zeros(1, dtype=f32)
    v_xla = _xla_best(states, jdr.EI(), jnp.zeros(1, jnp.float32), f.lbs, f.ubs,
                      xstarts, 10)
    for i, js in enumerate(states):
        v_cross = float(sg.acquisition(_port_state(js, f32), dr.EI(), x[i], theta))
        scale = max(1.0, abs(float(v_xla[i])))
        np.testing.assert_allclose(float(v[i]), v_cross, rtol=1e-3, atol=1e-5 * scale)
    _never_worse(states, jx, x, "EI", 0.0, xstarts, f.lbs, f.ubs, 10, f32,
                 rtol=1e-3, atol=0.0)


def test_per_lane_n_and_periodic_kernel():
    """Lanes with different active counts, and the periodic profile
    (theta = (lengthscale, period); period 3 > the box diagonal, so K stays
    well-conditioned in f32)."""
    f32 = torch.float32
    d, cap, S = 2, 12, 4
    lbs, ubs = np.full(d, -1.0), np.full(d, 1.0)
    xstarts = qmc.generate_initial_guesses(S - 2, lbs, ubs).astype(np.float32)
    for kern, noise, period in (
            (jK.RBFKernel(jnp.asarray([0.8], jnp.float32), "matern52"), 1e-5, 1.0),
            (jK.periodic((0.9, 3.0)), 1e-4, 3.0)):
        states = _jax_states(4, 7, d, cap, kern, 17, jnp.float32, noise=noise)
        states[2] = jsg.condition(states[2], jnp.asarray([0.2, -0.3], jnp.float32),
                                  jnp.asarray(0.5, jnp.float32))
        states[3] = jsg.fit(kern, np.array([[0.1, 0.2], [-0.5, 0.4]]),
                            np.array([0.3, -0.2]), capacity=cap, noise=noise,
                            dtype=jnp.float32)
        assert len({int(s.n) for s in states}) == 3
        jx, x, v = _solve_both(states, "EI", xstarts, lbs, ubs, 8, f32,
                               period=period)
        theta = torch.zeros(1, dtype=f32)
        for i, js in enumerate(states):
            v_cross = float(sg.acquisition(_port_state(js, f32), dr.EI(), x[i], theta))
            np.testing.assert_allclose(float(v[i]), v_cross, rtol=2e-3, atol=1e-5)
        _never_worse(states, jx, x, "EI", 0.0, xstarts, lbs, ubs, 8, f32,
                     rtol=1e-3, atol=0.0)


def test_loose_poi_float64_matches_jax_xla_solver():
    """f64 lanes with the IPNewton-loose freeze (POI: f_tol = x_tol = 1e-3).
    In f64 both solve in the Li form; their op-ordering noise (~1e-12) is
    far below any freeze threshold, so the frozen solutions coincide with
    the JAX XLA solver's."""
    f64 = torch.float64
    L, n, d, cap, S = 4, 7, 3, 12, 4
    kern = jK.matern52((0.8,))
    states = _jax_states(L, n, d, cap, kern, 5, jnp.float64)
    lbs, ubs = np.full(d, -1.0), np.full(d, 1.0)
    xstarts = qmc.generate_initial_guesses(S - 2, lbs, ubs)
    rule, jrule = dr.POI(), jdr.POI()
    _, x, v = _solve_both(states, "POI", xstarts, lbs, ubs, 8, f64,
                          f_tol=rule.solve_f_tol, x_tol=rule.solve_x_tol)
    assert x.dtype == f64
    theta = torch.zeros(1, dtype=f64)
    v_xla = _xla_best(states, jrule, jnp.zeros(1), lbs, ubs, xstarts, 8)
    for i, js in enumerate(states):
        vbest = float(v_xla[i])
        v_cross = float(sg.acquisition(_port_state(js, f64), rule, x[i], theta))
        np.testing.assert_allclose(float(v[i]), v_cross, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(v_cross, vbest, rtol=1e-6, atol=1e-9)


def test_maximize_hot_flattens_lane_axes():
    """maximize_hot on a (2, 3)-lane state equals one flat solver call, and
    the CPU route launches no kernel."""
    f64 = torch.float64
    states = _jax_states(6, 6, 2, 9, jK.matern52((0.8,)), 8, jnp.float64)
    ports = [_port_state(s, f64) for s in states]
    st = _stack(ports, (2, 3))
    lbs, ubs = torch.full((2,), -1.0, dtype=f64), torch.full((2,), 1.0, dtype=f64)
    xstarts = torch.tensor(qmc.generate_initial_guesses(3, -np.ones(2), np.ones(2)),
                           dtype=f64)
    before = nl.LAUNCHES
    x, v = solvers.maximize_hot(st, dr.EI(), torch.zeros((2, 3, 1), dtype=f64),
                                lbs, ubs, xstarts, iterations=6)
    assert nl.LAUNCHES == before
    assert x.shape == (2, 3, 2) and v.shape == (2, 3)
    flat = _stack(ports, (6,))
    xf, vf = nl.newton_solve_lanes_ref(flat.X, flat.Li, flat.c, flat.n,
                                       sg.get_active_minimum(flat),
                                       torch.zeros(6, dtype=f64), 0.8, lbs, ubs,
                                       xstarts, iterations=6)
    np.testing.assert_allclose(x.reshape(6, 2).numpy(), xf.numpy(), rtol=1e-12)
    np.testing.assert_allclose(v.reshape(6).numpy(), vf.numpy(), rtol=1e-12)


def test_all_starts_nonfinite_gives_zero_and_neg_inf():
    """A lane whose every start evaluates to NaN (here: a NaN incumbent)
    returns x = 0, v = -inf (the JAX kernel's sequential start reduction)."""
    f64 = torch.float64
    X = torch.zeros((1, 4, 2), dtype=f64)
    Li = 0.1 * torch.eye(4, dtype=f64)[None]
    c = torch.ones((1, 4), dtype=f64)
    nan = torch.full((1,), float("nan"), dtype=f64)
    x, v = nl.newton_solve_lanes(X, Li, c, torch.tensor([2]), nan,
                                 torch.zeros(1, dtype=f64), 0.8,
                                 torch.full((2,), -1.0, dtype=f64),
                                 torch.full((2,), 1.0, dtype=f64),
                                 torch.zeros((3, 2), dtype=f64), iterations=2)
    assert torch.equal(x, torch.zeros((1, 2), dtype=f64))
    assert v.item() == float("-inf")


def test_arguments_are_checked_on_every_route():
    """The checks the CUDA route relies on (dtype, shape, contiguity,
    supported kind / rule) run for CPU tensors too."""
    f64 = torch.float64
    X = torch.zeros((2, 4, 2), dtype=f64)
    Li = torch.eye(4, dtype=f64).expand(2, 4, 4).contiguous()
    hist = torch.zeros((2, 3, 4), dtype=f64)
    n, z = torch.tensor([2, 3]), torch.zeros(2, dtype=f64)
    box = (torch.full((2,), -1.0, dtype=f64), torch.full((2,), 1.0, dtype=f64),
           torch.zeros((3, 2), dtype=f64))
    ok = nl.newton_solve_lanes(X, Li, hist[:, 0].contiguous(), n, z, z, 0.8, *box,
                               iterations=1)
    assert ok[0].shape == (2, 2)
    bad = [((X, Li, hist[:, 0], n, z, z), {}, "contiguous"),           # strided view
           ((X, Li, hist[:, 0].contiguous(), n.int(), z, z), {}, "int64"),
           ((X.float(), Li, hist[:, 0].contiguous(), n, z, z), {}, "float32"),
           ((X, Li[:, :3].contiguous(), hist[:, 0].contiguous(), n, z, z), {}, "Li must"),
           ((X, Li, hist[:, 0].contiguous(), n, z, z), {"rule": "Random"}, "unsupported")]
    for args, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            nl.newton_solve_lanes(*args, 0.8, *box, iterations=1, **kw)


# --------------------------------------------------------------------------
# What surrounds the CUDA kernel: the block shape, the work count, the
# defaults. (The kernel itself runs only on the card.)
# --------------------------------------------------------------------------

_BLOCK_THREADS = 1024          # CUDA's limit per block
_BLOCK_SHARED = 232_448        # Hopper: 227 KB of dynamic shared memory


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("S", [1, 10, 32, 40, 1024])
@pytest.mark.parametrize("cap", [4, 12, 24, 48, 64])
def test_block_shape_fits_the_card(cap, S, itemsize):
    """Every supported d: the block fits the card's thread and shared-memory
    limits, holds at least one lane and one group, covers every start, and
    its byte count is the layout's (lane state + box + groups' scratch);
    also for one lane, whose starts spread over start blocks."""
    for d in range(1, nl.MAX_D + 1):
        dp = d | 1
        if itemsize == 4:
            per_group = 5 * cap + 2 * cap * max(dp, 18) + 2 * d * dp + 25 * dp + dp + 2
            matrix = cap * (cap | 1)
        else:
            per_group = cap * max(5 + 2 * dp, 18) + 2 * d * dp + 25 * dp + dp + 2
            matrix = cap * (cap + 1) // 2
        shapes = [nl._block_shape(cap, d, S, itemsize), nl._block_shape(cap, d, S, itemsize, 1)]
        for lay in shapes:
            lanes, groups, stage_m, smem = lay[:4]
            assert lanes >= 1 and 1 <= groups <= S
            assert lay.threads <= nl._MAX_THREADS <= _BLOCK_THREADS
            assert 0 < smem <= _BLOCK_SHARED
            # the start blocks cover every start once, none of them empty
            chunk = -(-S // lay.start_blocks)
            assert 1 <= lay.start_blocks <= S and (lay.start_blocks - 1) * chunk < S
            assert groups <= chunk
            per_lane = cap * dp + cap + (matrix if stage_m else 0)
            assert smem == (lanes * (per_lane + groups * per_group) + 2 * dp) * itemsize
            assert stage_m      # these capacities keep W (or Li) in shared memory
        # one lane: its starts over as many blocks as SMs allow
        assert shapes[1].start_blocks == -(-S // -(-S // min(S, nl._SMS)))


def test_block_shape_bench_and_beyond():
    # the bench shape: one lane x 10 warps, 63,320 B in float32, at 1600
    # lanes and at the throughput call's 4096 as well
    assert nl._block_shape(24, 10, 10, 4) == (1, 10, True, 63320, 1, 0)
    assert nl._block_shape(24, 10, 10, 4, 1600) == (1, 10, True, 63320, 1, 0)
    assert nl._block_shape(24, 10, 10, 4, 4096) == (1, 10, True, 63320, 1, 0)
    # float64 (Li packed): 97,360 B, however many lanes fill the card
    assert nl._block_shape(24, 10, 10, 8) == (1, 10, True, 97360, 1, 0)
    assert nl._block_shape(24, 10, 10, 8, 1600) == (1, 10, True, 97360, 1, 0)
    # the paper's ladder in float32 (d 2 and d 1, capacity 20): a lane x 10 warps
    assert nl._block_shape(20, 2, 10, 4, 1600) == (1, 10, True, 38504, 1, 0)
    assert nl._block_shape(20, 1, 10, 4, 2000) == (1, 10, True, 35848, 1, 0)
    # the myopic loop in float32 (capacity 105): one warp per start, each in
    # a block of its own
    assert nl._block_shape(105, 6, 66, 4, 1) == (1, 1, True, 65808, 66, 0)
    # 64 float32 lanes of 10 starts leave SMs idle: two start blocks
    assert nl._block_shape(24, 10, 10, 4, 64) == (1, 5, True, 33480, 2, 0)
    assert nl._block_shape(8, 2, 66, 4, 1, sms=3).start_blocks == 3
    # few starts: several lanes per block; many: starts in chunks per group
    assert nl._block_shape(24, 10, 1, 4)[:2] == (8, 1)
    assert nl._block_shape(24, 10, 40, 4)[:2] == (1, 14)
    assert nl._block_shape(24, 10, 1024, 4)[:2] == (1, 16)
    # the BO loops' float64 shapes: the myopic loop's one lane puts each of
    # its 66 starts in a block of its own; the non-myopic loop's 2000 lanes
    # fill the card with a lane block each (8 warps, its 18 starts together)
    assert nl._block_shape(105, 6, 66, 8, 1) == (1, 1, True, 69456, 66, 0)
    assert nl._block_shape(23, 6, 18, 8, 2000) == (1, 8, True, 109768, 1, 18)
    # 64 lanes of 10 starts leave SMs idle: two start blocks of 5 starts
    assert nl._block_shape(24, 16, 10, 8, 64) == (1, 5, True, 83088, 2, 0)
    assert nl._block_shape(8, 2, 66, 8, 1, sms=3).start_blocks == 3
    # a capacity whose W = K^{-1} alone exceeds the block: W stays in device
    # memory (240 x 241 floats = 231,360 B); Li packed (240 x 241 / 2 doubles)
    # too
    for itemsize in (4, 8):
        lay = nl._block_shape(240, 10, 10, itemsize)
        assert lay.lanes == 1 and lay.groups >= 1 and not lay.stage_m
        assert lay.smem <= _BLOCK_SHARED
    for bad in (dict(cap=24, d=0, S=4), dict(cap=24, d=17, S=4),
                dict(cap=24, d=4, S=0), dict(cap=24, d=4, S=1025)):
        with pytest.raises(ValueError, match="outside"):
            nl._block_shape(bad["cap"], bad["d"], bad["S"], 4)
    with pytest.raises(ValueError, match="shared memory"):
        nl._block_shape(2000, 16, 4, 8)


def test_block_shape_picks_the_lane_block_where_float64_lanes_fill_the_card():
    """The design follows the launch's shape alone: the lane block (`slots`
    > 0, a block of 8 warps per lane, no start blocks) for float64 at d <= 8
    with at least `_LANE_CROSSOVER` lanes per SM and a lane that fits; a
    warp per (lane, start) for every other launch."""
    cell = nl._block_shape(23, 6, 18, 8, 2000)          # the non-myopic loop's solves
    assert cell.slots == 18 and cell.threads == 256 and cell.start_blocks == 1
    assert cell.stage_m and cell.smem <= _BLOCK_SHARED
    edge = 66                        # half of the 132 SMs
    assert edge == nl._LANE_CROSSOVER * nl._SMS
    assert nl._block_shape(23, 6, 18, 8, edge).slots == 18
    assert nl._block_shape(23, 6, 18, 8, edge - 1).slots == 0
    assert nl._block_shape(23, 6, 18, 8, 64, sms=32).slots == 18
    # kept: the myopic loop's one lane, d > 8, float32, no lane count, and a
    # lane whose packed Li alone exceeds the block
    for kept in [(105, 6, 66, 8, 1), (24, 16, 10, 8, 1600), (24, 9, 10, 8, 1600),
                 (23, 6, 18, 4, 2000), (24, 10, 10, 4, 4096), (23, 6, 18, 8, None),
                 (240, 4, 3, 8, 2000)]:
        assert nl._block_shape(*kept).slots == 0, kept
    # many starts: passes of 32; a larger lane: fewer starts a pass
    assert nl._block_shape(23, 6, 40, 8, 2000).slots == 32
    big = nl._block_shape(105, 6, 66, 8, 2000)
    assert 1 <= big.slots < 32 and big.smem <= nl._SMEM_LIMIT
    assert nl._lane_block_shape(105, 6, big.slots + 1).slots == big.slots
    # every d <= 8 and capacity up to 64 fits, at least one start a pass,
    # with as many threads as the per-start steps need (8 a start)
    for d in range(1, 9):
        for cap in (4, 23, 64):
            lay = nl._block_shape(cap, d, 18, 8, 2000)
            assert 1 <= lay.slots <= 18 and 8 * lay.slots <= lay.threads <= 512
            assert lay.smem <= nl._SMEM_LIMIT


def test_lane_solve_work_at_the_bench_shape_and_its_growth():
    n = [13] * 534 + [14] * 533 + [15] * 533
    flops, nbytes = nl.lane_solve_work(n, 24, 10, 10, 10, 4)
    assert 0.8 * 5.2e9 <= flops <= 1.2 * 5.2e9
    read = 1600 * (24 * 10 + 24 * 24 + 24 + 2) * 4 + 1600 * 8 + (2 * 10 + 10 * 10 + 2) * 4
    assert nbytes == read + 1600 * 11 * 4                    # 5.4 MB in, 70 KB out
    assert 5.38e6 <= read <= 5.42e6 and 1600 * 11 * 4 == 70_400
    work = lambda **kw: nl.lane_solve_work(**{**dict(n=[14] * 8, cap=24, d=10, S=10,
                                                     iterations=10, itemsize=4), **kw})[0]
    base = work()
    # linear in the starts and (up to the final value per start) the iterations
    assert work(S=20) == pytest.approx(2 * base, rel=1e-12)
    assert work(iterations=20) == pytest.approx(2 * base, rel=0.01)
    assert work(n=[14] * 16) == pytest.approx(2 * base, rel=1e-12)
    # quadratic in n where that term leads; more than linear in d (the
    # d (d + 1) / 2 entries of H over the data, the d^3 / 3 factorization)
    assert 2.5 < work(n=[28] * 8, cap=32) / base < 4.0
    assert 3.5 < nl.lane_solve_work([200] * 2, 256, 10, 10, 10, 4)[0] / \
        nl.lane_solve_work([100] * 2, 256, 10, 10, 10, 4)[0] < 4.0
    assert 1.5 < work(d=16) / work(d=8) < 4.0
    assert nl.lane_solve_work([3] * 2, 8, 16, 2, 4, 8)[0] / \
        nl.lane_solve_work([3] * 2, 8, 8, 2, 4, 8)[0] > 2.0
    # loops run to n, not to the capacity; bytes count the capacity
    assert work(cap=48) == base
    assert nl.lane_solve_work([14] * 8, 48, 10, 10, 10, 4)[1] > \
        nl.lane_solve_work([14] * 8, 24, 10, 10, 10, 4)[1]
    # `runs`: the iterations each (lane, start) ran, as the float32 kernel
    # reports them since it stops a start at its fixed point: all of them
    # count as `iterations` does, one each as iterations=1 does, and a lane's
    # count follows its own runs
    full = torch.full((8, 10), 10, dtype=torch.int32)
    assert work(runs=full) == base
    assert work(runs=torch.ones_like(full)) == work(iterations=1)
    one_lane = torch.ones_like(full)
    one_lane[3] = 10
    assert work(runs=one_lane) == pytest.approx(
        (7 * work(iterations=1) + base) / 8, rel=1e-12)
    assert nl.lane_solve_work([13] * 8, 24, 10, 10, 10, 4, runs=full)[1] == \
        nl.lane_solve_work([13] * 8, 24, 10, 10, 10, 4)[1]


def test_lane_solve_work_of_the_float64_li_form():
    """itemsize 8 counts the Li form: Li's lower triangle in bytes, triangular
    products (n (n + 1) for a matvec) where the W form has square ones
    (2 n^2), and the Hessian's data term as the Gram of Li G. At the BO
    loops' two float64 shapes (d 6) the Li form needs fewer operations than
    the W form would, and its count grows as n^2 at large n."""
    f32_form = lambda n, cap, S: nl.lane_solve_work(n, cap, 6, S, 12, 4)[0]  # noqa: E731
    for n, cap, S in (([104], 105, 66), ([15] * 2000, 23, 18)):
        flops, nbytes = nl.lane_solve_work(n, cap, 6, S, 12, 8)
        lanes = len(n)
        read = (lanes * (cap * 6 + cap * (cap + 1) // 2 + cap + 2) + 2 * 6 + S * 6 + 2) * 8
        assert nbytes == read + 8 * lanes + lanes * 7 * 8
        assert 0.5 * f32_form(n, cap, S) < flops < f32_form(n, cap, S)
    assert 3.5 < nl.lane_solve_work([400] * 2, 512, 10, 10, 10, 8)[0] / \
        nl.lane_solve_work([200] * 2, 512, 10, 10, 10, 8)[0] < 4.0
    # loops run to n, not to the capacity
    assert nl.lane_solve_work([14] * 8, 48, 10, 10, 10, 8)[0] == \
        nl.lane_solve_work([14] * 8, 24, 10, 10, 10, 8)[0]


def _float32_lanes(L=6, n=7, d=3, cap=12, seed=4):
    """A float32 state of L lanes (the port's fit), its rule's theta and
    the box and starts."""
    f32 = torch.float32
    rng = np.random.default_rng(seed)
    kern = K.matern52((0.8,), device="cpu", dtype=f32)
    parts = [sg.fit(kern, rng.uniform(-1.0, 1.0, (n, d)),
                    np.sin(rng.uniform(-3.0, 3.0, n)), capacity=cap, noise=1e-3,
                    device="cpu", dtype=f32) for _ in range(L)]
    st = _stack(parts, (L,))
    box = (torch.full((d,), -1.0, dtype=f32), torch.full((d,), 1.0, dtype=f32))
    xstarts = torch.tensor(qmc.generate_initial_guesses(4, -np.ones(d), np.ones(d)),
                           dtype=f32)
    return st, box, xstarts


def test_float32_route_is_the_w_form_bitwise():
    """float32 lanes given Li solve in the TPU kernel's W form, bit for bit:
    the entry point and `solvers.maximize_hot` (which passes the state's
    Li) return exactly what the W-form plain solve returns given W =
    Li^T Li, formed as one batched matmul."""
    st, (lbs, ubs), xstarts = _float32_lanes()
    L = st.X.shape[0]
    th0 = torch.zeros(L, dtype=torch.float32)
    args = (st.c, st.n, sg.get_active_minimum(st), th0, st.kernel.theta[0], lbs, ubs,
            xstarts)
    W = st.Li.transpose(-1, -2) @ st.Li
    xw, vw = nl._solve_plain(st.X, W, False, *args, iterations=6)
    x, v = nl.newton_solve_lanes(st.X, st.Li, *args, iterations=6)
    xh, vh = solvers.maximize_hot(st, dr.EI(), th0[:, None], lbs, ubs, xstarts,
                                  iterations=6)
    assert bool(torch.all(torch.isfinite(vw)))
    for xo, vo in ((x, v), (xh, vh)):
        assert torch.equal(xo, xw) and torch.equal(vo, vw)


@pytest.mark.parametrize("fn", [sg.fit, K.matern52, K.matern32, K.matern12,
                                K.squared_exponential, K.periodic])
def test_entry_points_default_to_the_card(fn):
    """Entry points that create tensors run on the card unless the caller
    asks for the CPU (as every CPU test does); no availability switch."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "is_available" not in inspect.getsource(fn)


def test_entry_points_take_the_cpu_when_asked():
    kern = K.matern52((0.8,), device="cpu")
    st = sg.fit(kern, np.zeros((2, 1)), np.zeros(2), capacity=4, device="cpu")
    assert kern.theta.device.type == "cpu" and st.X.device.type == "cpu"
