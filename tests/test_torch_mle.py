"""PyTorch port: hyperparameter MLE, the refits, the joint draws and the
one-surrogate multistart solver, against the JAX package.

One numpy GP (seeded) is fit by the JAX package and carried into the port
as arrays. float64 on the CPU. Tolerances: likelihood and its derivatives
rtol 1e-9 (autograd through `linalg.cholesky_ex` against `jax.grad`
through the JAX Cholesky); the 60-step Adam MLE rtol 1e-7 on theta and on
the refit factors (rounding differences of ~1e-13 in each gradient pass
through the normalised Adam step); draws rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import solvers as jsolvers
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.rollout import solvers

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64
D, CAP = 3, 14
LBS, UBS = np.array([-1.0, 0.0, -2.0]), np.array([2.0, 1.5, 1.0])
THETAS = {"matern52": (0.7,), "squared_exponential": (0.9,), "matern32": (1.3,),
          "matern12": (0.5,), "periodic": (0.8, 2.5)}


def _t(a):
    return torch.tensor(np.array(a), dtype=f64)


def _close(got, want, rtol, atol=1e-13):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()),
                               np.asarray(want), rtol=rtol, atol=atol)


def _data(n=9, seed=4):
    rng = np.random.default_rng(seed)
    X = qmc.randsample(n, D, LBS, UBS, rng)
    y = np.sin(2.0 * X[:, 0]) * np.cos(X[:, 1]) + 0.3 * X[:, 2] ** 2
    return X, y


def _to_port(js, dtype=f64):
    return sg.from_numpy_state(js.kernel.kind, js.kernel.theta, js.X, js.y, js.L,
                               js.Li, js.c, js.n, js.noise, device="cpu", dtype=dtype)


def _states(kind, noise=1e-5):
    X, y = _data()
    js = jsg.fit(jK.RBFKernel(jnp.asarray(THETAS[kind]), kind), X, y, capacity=CAP,
                 noise=noise, dtype=jnp.float64)
    return js, _to_port(js)


def test_likelihood_is_nan_where_k_is_not_pd_as_in_jax():
    # a periodic profile of the Euclidean distance is not a PD kernel in 3-D
    js, st = _states("periodic")
    assert np.isnan(float(jsg.log_likelihood(js)))
    assert bool(torch.isnan(sg.log_likelihood(st)))
    assert np.isnan(np.asarray(jsg.grad_log_likelihood(js))).all()
    assert bool(torch.isnan(sg.grad_log_likelihood(st)).all())


@pytest.mark.parametrize("kind", sorted(set(THETAS) - {"periodic"}))
def test_log_likelihood_and_derivatives_match_jax(kind):
    js, st = _states(kind)
    _close(sg.log_likelihood(st), jsg.log_likelihood(js), 1e-9)
    _close(sg.grad_log_likelihood(st), jsg.grad_log_likelihood(js), 1e-9)
    dth = np.full(len(THETAS[kind]), 0.3)
    _close(sg.dlog_likelihood(st, dth), jsg.dlog_likelihood(js, dth), 1e-9)


@pytest.mark.parametrize("kind", ["matern52", "squared_exponential"])
def test_optimize_hypers_matches_jax(kind):
    js, st = _states(kind)
    jo = jsg.optimize_hypers(js, (0.1,), (5.0,))
    so = sg.optimize_hypers(st, (0.1,), (5.0,))
    assert float(jo.kernel.theta[0]) != pytest.approx(THETAS[kind][0], rel=1e-2)  # it moved
    _close(so.kernel.theta, jo.kernel.theta, 1e-7)
    _close(so.L, jo.L, 1e-7, atol=1e-12)
    _close(so.c, jo.c, 1e-7, atol=1e-9)
    _close(so.Li, jo.Li, 1e-7, atol=1e-9)
    # likelihood no worse than at the start, and the data untouched
    assert float(sg.log_likelihood(so)) >= float(sg.log_likelihood(st))
    assert torch.equal(so.X, st.X) and torch.equal(so.y, st.y) and int(so.n) == 9


def test_optimize_hypers_clips_to_the_box():
    js, st = _states("matern52")
    jo = jsg.optimize_hypers(js, (1.0,), (1.2,))
    so = sg.optimize_hypers(st, (1.0,), (1.2,))
    assert 1.0 <= float(so.kernel.theta[0]) <= 1.2
    _close(so.kernel.theta, jo.kernel.theta, 1e-7)


def test_optimize_hypers_start_not_pd_in_float32_returns_finite_theta():
    """Two observations 1e-6 apart with noise 1e-8 make K singular in
    float32 at every lengthscale (1 + 1e-8 rounds to 1):
    `torch.linalg.cholesky` raises there. The MLE's factorization returns
    NaN instead, the non-finite gradient is zeroed as in the JAX package
    (surrogate.py:451), and theta comes back finite, inside the box and
    equal to the JAX package's."""
    f32 = torch.float32
    X, y = _data(n=12)
    X[7] = X[2] + 1e-6
    kernel = K.matern52((0.7,), device="cpu", dtype=f32)
    Kxx = K.eval_KXX(kernel, torch.tensor(X, dtype=f32), noise=1e-8)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(Kxx)
    assert bool(torch.isnan(chol_ops.masked_cholesky(
        Kxx, torch.tensor(12), nan_if_not_pd=True)).all())
    with pytest.raises(torch.linalg.LinAlgError):
        sg.fit(kernel, X, y, capacity=CAP, noise=1e-8, device="cpu", dtype=f32)
    # a state fit with enough noise, whose noise then drops
    st = sg.fit(kernel, X, y, capacity=CAP, noise=1e-3, device="cpu", dtype=f32)
    st = st._replace(noise=torch.tensor(1e-8, dtype=f32))
    assert bool(torch.isnan(sg.log_likelihood(sg.refit(st, nan_if_not_pd=True))))
    so = sg.optimize_hypers(st, (0.1,), (5.0,))
    theta = float(so.kernel.theta[0])
    assert np.isfinite(theta) and 0.1 <= theta <= 5.0
    js = jsg.fit(jK.matern52((0.7,)), X, y, capacity=CAP, noise=1e-3, dtype=jnp.float32)
    jo = jsg.optimize_hypers(js._replace(noise=jnp.asarray(1e-8, jnp.float32)),
                             (0.1,), (5.0,))
    assert theta == pytest.approx(float(jo.kernel.theta[0]), rel=1e-6)


def test_refit_set_kernel_reset_match_jax():
    js, st = _states("matern52")
    k2, jk2 = K.matern32((1.1,), device="cpu"), jK.matern32((1.1,))
    for got, want in ((sg.refit(st), jsg.refit(js)),
                      (sg.set_kernel(st, k2), jsg.set_kernel(js, jk2))):
        for fld in ("L", "Li", "c"):
            _close(getattr(got, fld), getattr(want, fld), 1e-10)
    X2, y2 = _data(n=6, seed=8)
    got, want = sg.reset(st, X2, y2), jsg.reset(js, X2, y2)
    assert got.capacity == CAP and int(got.n) == int(want.n) == 6
    for fld in ("X", "y", "L", "Li", "c"):
        _close(getattr(got, fld), getattr(want, fld), 1e-10)
    dflt = sg.from_numpy(X2, y2, capacity=CAP, device="cpu")
    assert dflt.kernel.kind == "matern52" and int(dflt.n) == 6


@pytest.mark.parametrize("kind", ["matern52", "squared_exponential"])
def test_joint_posterior_chol_and_draws_match_jax(kind):
    js, st = _states(kind)
    rng = np.random.default_rng(5)
    xs = qmc.randsample(4, D, LBS, UBS, rng)
    zs = rng.standard_normal((4, D + 1))
    dmu, Ld = sg.joint_posterior_chol(st, _t(xs))         # batched over the points
    draws = sg.gp_draw_joint(st, _t(xs), _t(zs))
    scalar = sg.gp_draw(st, _t(xs), _t(zs[:, 0]))
    for i in range(4):
        jdmu, jLd = jsg.joint_posterior_chol(js, jnp.asarray(xs[i]))
        _close(dmu[i], jdmu, 1e-9)
        _close(Ld[i], jLd, 1e-9, atol=1e-12)
        _close(draws[i], jsg.gp_draw_joint(js, jnp.asarray(xs[i]), jnp.asarray(zs[i])),
               1e-9, atol=1e-12)
        _close(scalar[i], jsg.gp_draw(js, jnp.asarray(xs[i]), zs[i, 0]), 1e-9)


@pytest.mark.parametrize("rule_name,theta", [("EI", 0.0), ("LCB", 2.0), ("LogEI", 0.0),
                                             ("POI", 0.0)])
def test_multistart_maximize_matches_jax(rule_name, theta):
    """The kernel's two criteria (tests/test_pallas_newton.py) against the
    JAX package's Li-form XLA solver: (a) the returned value is the
    acquisition at the returned point, rtol 1e-9; (b) the port's solution is
    never worse than the JAX solver's beyond 1e-6 relative (POI: beyond its
    loose acceptance tolerance)."""
    js, st = _states("matern52")
    rule, jrule = dr.RULES[rule_name](), jdr.RULES[rule_name]()
    xstarts = qmc.generate_initial_guesses(14, LBS, UBS)
    res = solvers.multistart_maximize(st, rule, (theta,), LBS, UBS, xstarts, iterations=12)
    jres = jsolvers.multistart_maximize(js, jrule, jnp.asarray([theta]), LBS, UBS,
                                        jnp.asarray(xstarts), iterations=12)
    assert res.x.shape == (D,) and res.value.shape == ()
    assert bool(torch.all((res.x >= _t(LBS)) & (res.x <= _t(UBS))))
    acq = lambda x: float(jsg.acquisition(js, jrule, jnp.asarray(x), jnp.asarray([theta])))
    assert float(res.value) == pytest.approx(acq(res.x.numpy()), rel=1e-9, abs=1e-12)
    slack = (rule.solve_f_tol * (abs(float(jres.value)) + 1.0) if rule.solve_f_tol
             else 1e-6 * max(1.0, abs(float(jres.value))))
    assert acq(res.x.numpy()) >= float(jres.value) - slack
    if not rule.solve_f_tol:
        np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                                   atol=1e-6 * float((UBS - LBS).max()))


@pytest.mark.parametrize("rule_name,theta", [("EI", 0.0), ("LCB", 2.0)])
def test_solve_result_per_start_matches_jax(rule_name, theta):
    """`SolveResult.xs` / `values` against the JAX package's per-start
    arrays, start by start: x within 1e-6 of the box width, values rtol
    1e-9 (in float64 the lane solver and the Li-form XLA solver agree to
    rounding where a start's ascent meets no near-tie); the best start is
    the solve's own answer."""
    js, st = _states("matern52")
    xstarts = qmc.generate_initial_guesses(14, LBS, UBS)
    res = solvers.multistart_maximize(st, dr.RULES[rule_name](), (theta,), LBS, UBS,
                                      xstarts, iterations=12)
    jres = jsolvers.multistart_maximize(js, jdr.RULES[rule_name](), jnp.asarray([theta]),
                                        LBS, UBS, jnp.asarray(xstarts), iterations=12)
    S = xstarts.shape[0]
    assert res.xs.shape == (S, D) and res.values.shape == (S,)
    _close(res.xs, jres.xs, 0.0, atol=1e-6 * float((UBS - LBS).max()))
    _close(res.values, jres.values, 1e-9, atol=1e-12)
    j = int(torch.argmax(res.values))
    assert torch.equal(res.xs[j], res.x) and torch.equal(res.values[j], res.value)


def test_solve_result_random_and_cost_aware():
    """Random: its one sample as one start (S = 1) with value 0, as the JAX
    package's tiled arrays hold it. A cost-aware rule: `newton_solve_batch`'s
    per-start arrays and their argmax."""
    from rollout_bo_tpu_torch.models import cost_functions as cf

    _, st = _states("matern52")
    xstarts = qmc.generate_initial_guesses(4, LBS, UBS)
    res = solvers.multistart_maximize(st, dr.RandomAcquisition(), (0.0,), LBS, UBS, xstarts,
                                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(res.xs, res.x[None]) and torch.equal(res.values, torch.zeros(1, dtype=f64))
    rule = cf.cost_aware(dr.EI(), cf.NonUniformCost(lambda x: 1.0 + torch.sum(x * x, dim=-1)))
    res = solvers.multistart_maximize(st, rule, (0.0,), LBS, UBS, xstarts, iterations=6)
    xs, vs = solvers.newton_solve_batch(st, rule, (0.0,), LBS, UBS, xstarts, iterations=6)
    assert torch.equal(res.xs, xs) and torch.equal(res.values, vs)
    assert torch.equal(res.x, xs[torch.argmax(vs)]) and torch.equal(res.value, vs.max())


def test_random_rule_uniform():
    """The Random rule: inside the box, deterministic under a seed, uniform
    moments (as tests/test_solvers_and_bo.py::test_random_rule_uniform);
    its stream is torch's, not jax.random's."""
    _, st = _states("matern52")
    rule = dr.RandomAcquisition()
    assert rule.name == "Random" and dr.RULES["Random"]() == rule
    xstarts = qmc.generate_initial_guesses(4, LBS, UBS)

    def draws(seed, n):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([solvers.multistart_maximize(
            st, rule, (0.0,), LBS, UBS, xstarts, generator=g).x for _ in range(n)])

    a, b = draws(7, 400), draws(7, 400)
    assert torch.equal(a, b) and not torch.equal(a, draws(8, 400))
    assert bool(torch.all((a >= _t(LBS)) & (a <= _t(UBS))))
    u = ((a - _t(LBS)) / _t(UBS - LBS)).numpy()
    np.testing.assert_allclose(u.mean(axis=0), 0.5, atol=0.06)
    np.testing.assert_allclose(u.var(axis=0), 1.0 / 12.0, atol=0.02)
    with pytest.raises(ValueError, match="Generator"):
        solvers.multistart_maximize(st, rule, (0.0,), LBS, UBS, xstarts)
    z = torch.zeros(3, dtype=f64)
    assert float(rule(z, z + 1.0, _t([0.0]), z).abs().sum()) == 0.0
    assert all(float(p.abs().sum()) == 0.0 for p in rule.partials(z, z + 1.0, _t([0.0]), z))


def test_multistart_maximize_rejects_a_batched_state():
    _, st = _states("matern52")
    batched = sg.SurrogateState(st.kernel, *(t[None] if t.dim() else t for t in st[1:]))
    batched = batched._replace(n=st.n[None])
    with pytest.raises(ValueError, match="one surrogate"):
        solvers.multistart_maximize(batched, dr.EI(), (0.0,), LBS, UBS,
                                    qmc.generate_initial_guesses(4, LBS, UBS))
