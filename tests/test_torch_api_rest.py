"""PyTorch port, the last public functions against the JAX package: the
padded triangular solves and the triangular-solve row append
(`ops/chol.py`), the directional kernel derivatives (`ops/kernels.py`),
`fantasy_reset` (`models/fantasy.py`), `rollout_trajectory` /
`trajectory_reward` (`rollout/trajectory.py`) and `sga_update`
(`rollout/outer.py`; `stochastic_solve` and `stochastic_solve_batch` are
held to the JAX package in tests/test_torch_parallel.py, beside the
sharded solves).

The same numpy inputs (made from a seed) go to both packages in float64
on the CPU; the cases are those of tests/test_kernels.py:80-115,
tests/test_rollout.py and tests/test_adjoint.py. Tolerances:
- linear algebra and kernel derivatives: rtol 1e-12 (the same
  arithmetic, up to the order of additions);
- fantasy states: rtol 1e-12 on L, Li and the posterior mean;
- rolled-out trajectories: rtol 1e-8 on the points and draws, as the
  adjoint tests hold them (the inner solvers, both in the L^{-1} form in
  float64, differ in the order of their operations); rtol 1e-6 on the drawn gradients of the 1-d
  problem, whose K is ill-conditioned (lengthscale 0.3, noise 1e-6), and
  on the reward's gradient (an IFT gradient amplifies the solvers'
  difference by the inner Newton system's conditioning).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import fantasy as jfant
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import chol as jchol
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu.rollout import trajectory as jtraj
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import chol
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.rollout import outer, trajectory

# The tensors here are tiny: one intra-op thread.
torch.set_num_threads(1)

f64 = torch.float64
T = lambda a: torch.tensor(np.array(a), dtype=f64)
KINDS = {"matern52": (0.9,), "matern32": (0.7,), "matern12": (1.1,),
         "squared_exponential": (0.8,), "periodic": (0.9, 2.5)}


def _port(js):
    """The port's copy of a JAX SurrogateState."""
    return sg.from_numpy_state(js.kernel.kind, js.kernel.theta, js.X, js.y, js.L, js.Li,
                               js.c, js.n, js.noise, device="cpu", dtype=f64)


def _state_1d(cap=12):
    """tests/test_rollout.py's 1-d GP: 6 points of sin(6x) + 0.3x."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, size=(6, 1)), axis=0)
    return jsg.fit(jK.matern52((0.3,)), X, np.sin(6 * X[:, 0]) + 0.3 * X[:, 0],
                   capacity=cap, noise=1e-6)


def _state_2d():
    """tests/test_adjoint.py's 2-d GP: 7 points of |x|^2 + 0.1 sin(3 x_0)."""
    rng = np.random.default_rng(3)
    X = rng.uniform(-1.0, 1.0, size=(7, 2))
    y = np.sum(X**2, axis=1) + 0.1 * np.sin(3 * X[:, 0])
    return jsg.fit(jK.matern52((0.6,)), X, y, capacity=14, noise=1e-6)


# --------------------------------------------------------------------------
# ops/chol.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 4, 7, 10])
def test_padded_solves_and_row_append_match_jax(n):
    rng = np.random.default_rng(n)
    cap, d = 10, 2
    X = rng.uniform(-1.0, 1.0, size=(cap, d))
    Kfull = np.asarray(jK.eval_KXX(jK.matern52((0.7,)), jnp.asarray(X), noise=1e-4))
    jL = jchol.masked_cholesky(jnp.asarray(Kfull), n)
    L = T(jL)
    torch.testing.assert_close(chol.masked_cholesky(T(Kfull), n), L, rtol=1e-12, atol=1e-14)
    b = np.where(np.arange(cap) < n, rng.standard_normal(cap), 0.0)
    for fn, jfn in ((chol.solve_lower, jchol.solve_lower), (chol.solve_upper, jchol.solve_upper),
                    (chol.cho_solve_padded, jchol.cho_solve_padded)):
        np.testing.assert_allclose(fn(L, T(b)).numpy(), np.asarray(jfn(jL, jnp.asarray(b))),
                                   rtol=1e-12, atol=1e-14, err_msg=fn.__name__)
    if n == cap:
        return
    kvec = rng.standard_normal(cap) * 0.1
    kdiag = 1.0 + 1e-4
    mine = chol.chol_append_row(L, T(kvec), kdiag, n)
    theirs = np.asarray(jchol.chol_append_row(jL, jnp.asarray(kvec), kdiag, n))
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-12, atol=1e-14)
    # the same row as the explicit-inverse append, and the padding kept
    Li = chol.tri_inv_padded(L)
    L2, _ = chol.chol_append_row_with_inv(L, Li, T(kvec), kdiag, n)
    torch.testing.assert_close(mine, L2, rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(mine.numpy()[n + 1:], np.eye(cap)[n + 1:])


def test_padded_solves_take_lanes():
    """Two lanes with different active counts in one call."""
    rng = np.random.default_rng(5)
    cap = 8
    X = rng.uniform(-1.0, 1.0, size=(cap, 3))
    Kfull = np.asarray(jK.eval_KXX(jK.matern52((0.7,)), jnp.asarray(X), noise=1e-4))
    jLs = [jchol.masked_cholesky(jnp.asarray(Kfull), n) for n in (3, 8)]
    bs = [np.where(np.arange(cap) < n, rng.standard_normal(cap), 0.0) for n in (3, 8)]
    got = chol.cho_solve_padded(T(np.stack(jLs)), T(np.stack(bs)))
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(
            jchol.cho_solve_padded(jLs[i], jnp.asarray(bs[i]))), rtol=1e-12, atol=1e-14)


# --------------------------------------------------------------------------
# ops/kernels.py (tests/test_kernels.py:80-115)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_directional_kernel_derivatives_match_jax(kind):
    theta = KINDS[kind]
    k, jk = K.RBFKernel(T(theta), kind), jK.RBFKernel(jnp.asarray(theta), kind)
    rng = np.random.default_rng(2)
    X, dX, x = rng.normal(size=(5, 3)), rng.normal(size=(5, 3)), rng.normal(size=3)
    cases = (("eval_dKXX", (X, dX)), ("eval_dKxX", (x, X, dX)),
             ("eval_dgrad_KxX", (x, X, dX)))
    for name, args in cases:
        mine = getattr(K, name)(k, *map(T, args)).numpy()
        theirs = np.asarray(getattr(jK, name)(jk, *map(jnp.asarray, args)))
        np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=1e-14, err_msg=name)
    X4 = np.random.default_rng(3).normal(size=(4, 2))
    dth = np.linspace(1.0, -0.5, len(theta))
    np.testing.assert_allclose(K.eval_Dtheta_KXX(k, T(X4), T(dth)).numpy(),
                               np.asarray(jK.eval_Dtheta_KXX(jk, jnp.asarray(X4),
                                                             jnp.asarray(dth))),
                               rtol=1e-12, atol=1e-14)


def test_directional_kernel_derivatives_take_lanes():
    k = K.matern52((0.8,), device="cpu")
    rng = np.random.default_rng(4)
    X, dX, x = rng.normal(size=(3, 5, 2)), rng.normal(size=(3, 5, 2)), rng.normal(size=(3, 2))
    dK, dk = K.eval_dKXX(k, T(X), T(dX)), K.eval_dgrad_KxX(k, T(x), T(X), T(dX))
    assert dK.shape == (3, 5, 5) and dk.shape == (3, 5, 2)
    for i in range(3):
        torch.testing.assert_close(dK[i], K.eval_dKXX(k, T(X[i]), T(dX[i])), rtol=0, atol=0)
        torch.testing.assert_close(dk[i], K.eval_dgrad_KxX(k, T(x[i]), T(X[i]), T(dX[i])),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------------
# models/fantasy.py (tests/test_rollout.py:68-80)
# --------------------------------------------------------------------------


def test_fantasy_reset_matches_jax():
    js = _state_1d()
    pts = (([0.5], 0.2), ([0.7], -0.1))

    @jax.jit
    def jax_side():
        jfs = jfant.make_fantasy(js, 1)
        for x, y in pts:
            jfs = jfant.fantasy_condition(jfs, jnp.asarray(x), jnp.asarray(y))
        reset = jfant.fantasy_reset(jfs)
        again = jfant.fantasy_condition(reset, jnp.asarray([0.3]), jnp.asarray(0.4))
        return reset, jsg.posterior(jfant.view(again, 0), jnp.asarray([0.6])).mu

    jreset, want = jax_side()
    fs = fant.make_fantasy(_port(js), 1)
    for x, y in pts:
        fs = fant.fantasy_condition(fs, T(x), T(y))
    fs = fant.fantasy_reset(fs)
    assert fs.m == int(jreset.m) == 0
    for f in ("L", "Li"):
        np.testing.assert_allclose(getattr(fs, f).numpy(), np.asarray(getattr(jreset, f)),
                                   rtol=1e-12, atol=1e-14, err_msg=f)
    # reusable: a new fantasy after the reset is the surrogate conditioned on it
    fs = fant.fantasy_condition(fs, T([0.3]), T(0.4))
    mu = float(sg.posterior(fant.view(fs, 0), T([0.6])).mu)
    assert mu == pytest.approx(float(want), rel=1e-12)
    stc = sg.condition(_port(js), T([0.3]), T(0.4))
    assert float(sg.posterior(stc, T([0.6])).mu) == pytest.approx(mu, rel=1e-10)


# --------------------------------------------------------------------------
# rollout/trajectory.py (tests/test_rollout.py:101-113, tests/test_adjoint.py)
# --------------------------------------------------------------------------


def test_rollout_trajectory_matches_jax():
    js = _state_1d()
    z = np.random.default_rng(3).normal(size=(2, 3))
    xstarts = qmc.generate_initial_guesses(6, [0.0], [1.0])
    jfs, jrec = jax.jit(lambda z_: jtraj.rollout_trajectory(
        jfant.make_fantasy(js, 2), jnp.asarray([0.55]), jnp.zeros(1), jnp.zeros(1),
        jnp.ones(1), jnp.asarray(xstarts), z_, jdr.EI()))(jnp.asarray(z))
    fs, rec = trajectory.rollout_trajectory(
        fant.make_fantasy(_port(js), 2), T([0.55]), T([0.0]), T([0.0]), T([1.0]),
        T(xstarts), T(z), dr.EI())
    assert rec.ys.shape == (3,) and rec.xs.shape == (3, 1) and fs.m == int(jfs.m) == 3
    for f, rtol in (("xs", 1e-8), ("ys", 1e-8), ("grads", 1e-6)):
        np.testing.assert_allclose(getattr(rec, f).numpy(), np.asarray(getattr(jrec, f)),
                                   rtol=rtol, atol=1e-10, err_msg=f)


def test_rollout_trajectory_takes_lanes():
    """Each row of a batch of starts and streams rolls its own trajectory.
    Batching changes only rounding, but an inner argmax sits on the flat top
    of the acquisition, where rounding moves it by up to ~1e-8: rtol 1e-7."""
    st = _port(_state_2d())
    xstarts = T(qmc.generate_initial_guesses(6, [-1.0] * 2, [1.0] * 2))
    lo, hi = T(-np.ones(2)), T(np.ones(2))
    rng = np.random.default_rng(9)
    x0s, zs = rng.uniform(-0.8, 0.8, size=(3, 2)), rng.normal(size=(3, 3, 3))
    roll = lambda x0, z: trajectory.rollout_trajectory(
        fant.make_fantasy(st, 2), T(x0), T([0.0]), lo, hi, xstarts, T(z), dr.EI())[1]
    lanes = roll(x0s, zs)
    assert lanes.xs.shape == (3, 3, 2) and lanes.ys.shape == (3, 3)
    for i in range(3):
        one = roll(x0s[i], zs[i])
        torch.testing.assert_close(lanes.xs[i], one.xs, rtol=1e-7, atol=1e-9)
        torch.testing.assert_close(lanes.ys[i], one.ys, rtol=1e-7, atol=1e-9)


@pytest.fixture(scope="module")
def reward_problem():
    """tests/test_adjoint.py's problem and the JAX reward's value and
    gradient, compiled once per draw mode."""
    js = _state_2d()
    xstarts = qmc.generate_initial_guesses(6, [-1.0] * 2, [1.0] * 2)
    lo, hi = -np.ones(2), np.ones(2)

    def jax_reward(mode):
        def reward(x0, th, z):
            return jtraj.trajectory_reward(jfant.make_fantasy(js, 2), x0, th, jnp.asarray(lo),
                                           jnp.asarray(hi), jnp.asarray(xstarts), z,
                                           jdr.EI(), iterations=20, draw_mode=mode)
        return jax.jit(jax.value_and_grad(reward, argnums=(0, 1)))

    return dict(js=js, xstarts=xstarts, lo=lo, hi=hi,
                jax={m: jax_reward(m) for m in ("reparam", "sample_path")})


@pytest.mark.parametrize("draw_mode", ["reparam", "sample_path"])
@pytest.mark.parametrize("seed_z", [0, 3, 8])
def test_trajectory_reward_and_its_gradient_match_jax(reward_problem, draw_mode, seed_z):
    """Seed 0: the best step is the first draw (t = 0); seeds 3 and 8: t = 1,
    after an interior inner solve, so the gradient runs through the IFT."""
    p = reward_problem
    rng = np.random.default_rng(100 + seed_z)
    z = rng.normal(size=(3, 3))
    x0 = rng.uniform(-0.8, 0.8, size=(2,))
    jr, (jgx, jgth) = p["jax"][draw_mode](jnp.asarray(x0), jnp.zeros(1), jnp.asarray(z))
    x0t, th = T(x0).requires_grad_(True), torch.zeros(1, dtype=f64, requires_grad=True)
    r = trajectory.trajectory_reward(fant.make_fantasy(_port(p["js"]), 2), x0t, th,
                                     T(p["lo"]), T(p["hi"]), T(p["xstarts"]), T(z), dr.EI(),
                                     iterations=20, draw_mode=draw_mode)
    gx, gth = torch.autograd.grad(r, (x0t, th))
    assert float(jr) > 0.0                          # an improving trajectory
    assert float(r.detach()) == pytest.approx(float(jr), rel=1e-8)
    assert float(torch.linalg.vector_norm(gx)) > 0.0
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(gth.numpy(), np.asarray(jgth), rtol=1e-6, atol=1e-10)


# --------------------------------------------------------------------------
# rollout/outer.py: sga_update
# --------------------------------------------------------------------------


def test_sga_update_matches_jax():
    rng = np.random.default_rng(1)
    x, g = rng.standard_normal((3, 2)), rng.standard_normal((3, 2))
    np.testing.assert_allclose(outer.sga_update(T(x), T(g), lr=0.3).numpy(),
                               np.asarray(jouter.sga_update(jnp.asarray(x), jnp.asarray(g),
                                                            lr=0.3)), rtol=1e-15)
