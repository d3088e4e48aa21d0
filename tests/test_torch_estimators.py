"""PyTorch port, the remaining estimators against the JAX package:
Gauss-Hermite (both resolve modes, two node scales), deterministic
(ground-truth observable), the "sample_path" draw mode and the
deterministic (SAA) outer solver.

The same GP state (the JAX package's, carried across as numpy arrays) and
starts go through both packages in float64 at d = 2, capacity 16.
Tolerance rtol 1e-6 on values and gradients: the JAX CPU route solves the
inner argmax with the Li-formulated XLA solver and the port with its lane
solver in the same Li form; in float64 they agree to ~1e-12, and the IFT
gradients inherit that agreement amplified by at most the conditioning of
the Newton system.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.ops import quadrature as jquad
from rollout_bo_tpu.rollout import mc as jmc
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu.rollout import trajectory as jtraj
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTP
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import quadrature as quad
from rollout_bo_tpu_torch.rollout import mc, outer, trajectory
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64
RTOL = 1e-6
D, CAP = 2, 16
LBS, UBS = np.array([-2.0, -1.0]), np.array([2.0, 3.0])
ETO_FIELDS = ("mu", "std_mu", "grad_x", "std_grad_x", "grad_theta", "std_grad_theta")


def _t(a):
    return torch.tensor(np.array(a), dtype=f64)


def _setup(seed=2):
    rng = np.random.default_rng(seed)
    X = qmc.randsample(7, D, LBS, UBS, rng)
    y = np.sin(1.5 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * X[:, 0] ** 2
    js = jsg.fit(jK.matern52((1.0,)), X, y, capacity=CAP, noise=1e-5, dtype=jnp.float64)
    st = sg.from_numpy_state(js.kernel.kind, js.kernel.theta, js.X, js.y, js.L,
                             js.Li, js.c, js.n, js.noise, device="cpu", dtype=f64)
    xstarts = qmc.generate_initial_guesses(4, LBS, UBS)
    x0 = X[:3] + np.array([0.31, -0.27])
    return js, st, xstarts, x0


def _assert_eto(eto, r, je, fields=ETO_FIELDS):
    for f in fields:
        np.testing.assert_allclose(getattr(eto, f)[r].numpy(), np.asarray(getattr(je, f)),
                                   rtol=RTOL, atol=1e-10, err_msg=f"{f} at start {r}")


def test_quadrature_is_the_same_copy():
    for n in (3, 8):
        for a, b in zip(quad.gauss_hermite(n), jquad.gauss_hermite(n)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(quad.tensor_product_indices(3, 2),
                                  jquad.tensor_product_indices(3, 2))


# the JAX programs, compiled once and shared by the cases that differ only in
# a traced value (the node scale, the gradient tolerance)
DET_KW = dict(horizon=1, num_nodes=3, max_iters=4, lr=0.05, inner_iterations=12)


@functools.lru_cache(maxsize=None)
def _jax_ghq(resolve_mode):
    js, _, xstarts, _ = _setup()
    return jax.jit(lambda x, node_scale: jmc.simulate_trajectory_ghq(
        js, x, jnp.zeros(1), jnp.asarray(LBS), jnp.asarray(UBS), jnp.asarray(xstarts),
        jdr.EI(), horizon=1, num_nodes=4, iterations=6, resolve_mode=resolve_mode,
        node_scale=node_scale))


@functools.lru_cache(maxsize=None)
def _jax_deterministic_solve_batch():
    js, _, xstarts, _ = _setup()
    return jax.jit(lambda s, grad_tol: jouter.deterministic_solve_batch(
        js, jnp.zeros(1), jnp.asarray(LBS), jnp.asarray(UBS), jnp.asarray(xstarts), s,
        jdr.EI(), grad_tol=grad_tol, **DET_KW))


@pytest.mark.parametrize("node_scale", [1.0, float(np.sqrt(np.log10(np.e)))])
@pytest.mark.parametrize("resolve_mode", ["quadrature", "reference"])
def test_simulate_trajectory_ghq_matches_jax(resolve_mode, node_scale):
    js, st, xstarts, x0 = _setup()
    rule = dr.EI()
    kw = dict(horizon=1, num_nodes=4, iterations=6, resolve_mode=resolve_mode,
              node_scale=node_scale)
    # every start in one batch-first call; the 4^2 index tuples are the lanes
    eto = mc.simulate_trajectory_ghq(st, x0, (0.0,), LBS, UBS, xstarts, rule, **kw)
    sim = _jax_ghq(resolve_mode)           # node_scale traced: one compile per mode
    for r in range(x0.shape[0]):
        _assert_eto(eto, r, sim(jnp.asarray(x0[r]), node_scale))
    assert float(eto.mu.abs().sum()) > 0.0 and float(eto.grad_x.abs().sum()) > 0.0
    ev = mc.simulate_trajectory_ghq(st, x0, (0.0,), LBS, UBS, xstarts, rule,
                                    with_gradients=False, **kw)
    assert ev.grad_x is None
    np.testing.assert_allclose(ev.mu.numpy(), eto.mu.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="resolve mode"):
        mc.simulate_trajectory_ghq(st, x0, (0.0,), LBS, UBS, xstarts, rule, horizon=1,
                                   resolve_mode="nope")


def test_simulate_trajectory_ghq_horizon_two_lcb_matches_jax():
    js, st, xstarts, x0 = _setup()
    kw = dict(horizon=2, num_nodes=3, iterations=6)
    eto = mc.simulate_trajectory_ghq(st, x0[:2], (0.4,), LBS, UBS, xstarts, dr.LCB(), **kw)
    sim = jax.jit(lambda x: jmc.simulate_trajectory_ghq(
        js, x, jnp.asarray([0.4]), jnp.asarray(LBS), jnp.asarray(UBS),
        jnp.asarray(xstarts), jdr.LCB(), **kw))
    for r in range(2):
        _assert_eto(eto, r, sim(jnp.asarray(x0[r])))
    assert float(eto.grad_theta.abs().sum()) > 0.0


def test_simulate_trajectory_deterministic_matches_jax():
    js, st, xstarts, x0 = _setup()
    # the data's own generating function, lowered so that rollouts improve
    # on the incumbent
    f = lambda x: (torch.sin(1.5 * x[..., 0]) * torch.cos(x[..., 1])
                   + 0.1 * x[..., 0] ** 2 - 0.4)
    jf = lambda x: jnp.sin(1.5 * x[0]) * jnp.cos(x[1]) + 0.1 * x[0] ** 2 - 0.4
    kw = dict(horizon=2, iterations=12)    # inner solves run to convergence
    eto = mc.simulate_trajectory_deterministic(st, x0, (0.0,), LBS, UBS, xstarts,
                                               dr.EI(), f, **kw)
    sim = jax.jit(lambda x: jmc.simulate_trajectory_deterministic(
        js, x, jnp.zeros(1), jnp.asarray(LBS), jnp.asarray(UBS), jnp.asarray(xstarts),
        jdr.EI(), jf, **kw))
    for r in range(x0.shape[0]):
        _assert_eto(eto, r, sim(jnp.asarray(x0[r])))
    assert float(eto.mu.abs().sum()) > 0.0 and float(eto.grad_x.abs().sum()) > 0.0
    assert float(eto.std_mu.abs().sum()) == 0.0
    ev = mc.simulate_trajectory_deterministic(st, x0, (0.0,), LBS, UBS, xstarts, dr.EI(),
                                              f, with_gradients=False, **kw)
    np.testing.assert_allclose(ev.mu.numpy(), eto.mu.numpy(), rtol=1e-12)


def test_sample_path_draw_matches_jax():
    js, st, _, x0 = _setup()
    z = np.random.default_rng(3).standard_normal((3, D + 1))
    x = _t(x0).requires_grad_(True)
    y, gy = trajectory.sample_path_draw(st, x, _t(z))
    (dy,) = torch.autograd.grad(y.sum(), x)
    for r in range(3):
        jx, jz = jnp.asarray(x0[r]), jnp.asarray(z[r])
        jy, jgy = jtraj.sample_path_draw(js, jx, jz)
        jdy = jax.grad(lambda xx: jtraj.sample_path_draw(js, xx, jz)[0])(jx)
        np.testing.assert_allclose(float(y[r].detach()), float(jy), rtol=1e-9)
        np.testing.assert_allclose(gy[r].numpy(), np.asarray(jgy), rtol=1e-9, atol=1e-12)
        # dy/dx is the drawn gradient itself
        np.testing.assert_allclose(dy[r].numpy(), np.asarray(jdy), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(dy[r].numpy(), gy[r].numpy(), rtol=1e-12)


def test_simulate_trajectory_mc_sample_path_mode_matches_jax():
    js, st, xstarts, x0 = _setup()
    H, M = 2, 8
    z = qmc.gen_low_discrepancy_sequence(M, D, H + 1)
    tp = TrajectoryParams(x0=_t(x0), theta=_t([0.0]), lbs=_t(LBS), ubs=_t(UBS),
                          rnstream=_t(z))
    jtp = JTP(x0=jnp.asarray(x0[0]), theta=jnp.zeros(1), lbs=jnp.asarray(LBS),
              ubs=jnp.asarray(UBS), rnstream=jnp.asarray(z))
    eto = mc.simulate_trajectory_mc(st, tp, dr.EI(), _t(xstarts), iterations=12,
                                    draw_mode="sample_path")
    reparam = mc.simulate_trajectory_mc(st, tp, dr.EI(), _t(xstarts), iterations=12)
    sim = jax.jit(lambda x: jmc.simulate_trajectory_mc(
        js, jtp._replace(x0=x), jdr.EI(), jnp.asarray(xstarts), iterations=12,
        draw_mode="sample_path"))
    for r in range(x0.shape[0]):
        _assert_eto(eto, r, sim(jnp.asarray(x0[r])), ETO_FIELDS[:5])
    # same draws, another derivative: the modes share mu and differ in grad_x
    np.testing.assert_allclose(eto.mu.numpy(), reparam.mu.numpy(), rtol=1e-12)
    assert not np.allclose(eto.grad_x.numpy(), reparam.grad_x.numpy(), rtol=1e-3)
    with pytest.raises(ValueError, match="draw mode"):
        mc.simulate_trajectory_mc(st, tp, dr.EI(), _t(xstarts), draw_mode="nope")


def test_deterministic_solve_batch_matches_jax():
    js, st, xstarts, x0 = _setup()
    kw = DET_KW
    xs, vals = outer.deterministic_solve_batch(st, (0.0,), LBS, UBS, xstarts, x0,
                                               dr.EI(), **kw)
    jxs, jvals = _jax_deterministic_solve_batch()(jnp.asarray(x0), 1e-4)   # the default
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=RTOL, atol=1e-9)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=RTOL, atol=1e-10)
    assert not np.allclose(xs.numpy(), x0)                 # the ascent moved
    # one start through deterministic_solve: the same point, with the estimate there
    x, eto = outer.deterministic_solve(st, x0[1], (0.0,), LBS, UBS, xstarts, dr.EI(), **kw)
    np.testing.assert_allclose(x.numpy(), xs[1].numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(eto.mu), float(vals[1]), rtol=1e-12)
    assert eto.grad_x.shape == (D,)


def test_deterministic_solve_stops_each_restart_on_its_own_gradient():
    """A restart whose gradient norm is under grad_tol keeps its point while
    the others go on (the JAX package's per-restart while_loop under vmap)."""
    js, st, xstarts, x0 = _setup()
    kw = DET_KW
    g = mc.simulate_trajectory_ghq(st, x0, (0.0,), LBS, UBS, xstarts, dr.EI(),
                                   horizon=1, num_nodes=3, iterations=12).grad_x
    norms = torch.linalg.vector_norm(g, dim=-1)
    tol = float(0.5 * (norms.sort().values[0] + norms.sort().values[1]))
    xs, _ = outer.deterministic_solve_batch(st, (0.0,), LBS, UBS, xstarts, x0, dr.EI(),
                                            grad_tol=tol, **kw)
    jxs, _ = _jax_deterministic_solve_batch()(jnp.asarray(x0), tol)
    stopped = int(torch.argmin(norms))
    np.testing.assert_array_equal(xs[stopped].numpy(), x0[stopped])
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=RTOL, atol=1e-9)
    assert not np.allclose(np.delete(xs.numpy(), stopped, 0), np.delete(x0, stopped, 0))
