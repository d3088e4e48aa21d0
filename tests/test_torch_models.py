"""PyTorch port, models layer: decision rules, surrogate, fantasy.

Inputs are made from a seed with numpy and fed to both packages; the JAX
side runs on the CPU in float64 (tests/conftest.py). Tolerances:
- surrogate and fantasy, float64 at rtol 1e-10: same math, only the
  summation order differs;
- decision rules, float64 at rtol 1e-9 against `jax.grad` of the JAX
  rules, away from the z clamp: closed forms against autodiff of the same
  functions. The LogEI / LogPOI tails are Mills-ratio polynomials accurate
  to ~1e-6, held as tests/test_pallas_newton.py's
  test_log_rule_tails_match_float64_autodiff holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import fantasy as jfant
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64
RTOL = 1e-10
RULES = ["EI", "POI", "LCB", "LogEI", "LogPOI"]


def _t(a):
    return torch.tensor(np.array(a), dtype=f64)


def _close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()),
                               np.asarray(want), rtol=rtol, atol=atol)


def _jax_partials(rule, mu, sigma, th, fmini):
    fns = [rule, rule.dg_dmu, rule.dg_dsigma, rule.d2g_dmu, rule.d2g_dsigma,
           rule.d2g_dmudsigma]
    thv = jnp.asarray([th], jnp.float64)
    return [jax.vmap(lambda m, s, f, fn=fn: fn(m, s, thv, f))(
        jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(fmini)) for fn in fns]


@pytest.mark.parametrize("name", RULES)
def test_rule_value_and_partials_match_jax_grad(name):
    # z = (fmini - mu - th)/s in [-0.9, 4]: inside the clamp, and on the
    # direct branch of the log rules
    mu = np.array([0.3, -1.2, 0.8, 0.05])
    sigma = np.array([0.5, 0.7, 1.4, 0.3])
    fmini = np.array([0.1, 0.1, 2.0, 0.2])
    th = 0.5 if name == "LCB" else 0.0
    rule, jrule = dr.RULES[name](), jdr.RULES[name]()
    thv = _t([th])
    got = [rule(_t(mu), _t(sigma), thv, _t(fmini)),
           *rule.partials(_t(mu), _t(sigma), thv, _t(fmini))]
    for g, w in zip(got, _jax_partials(jrule, mu, sigma, th, fmini)):
        _close(g, w, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["EI", "POI", "LCB"])
def test_autograd_of_first_partials_gives_second_partials(name):
    """The IFT gradient differentiates gmu, gsig by autograd: that must be
    the second partials (and the theta cross terms) of the JAX rule."""
    mu = np.array([0.3, -1.2, 0.8])
    sigma = np.array([0.5, 0.7, 1.4])
    fmini = np.array([0.1, 0.1, 2.0])
    th = 0.5 if name == "LCB" else 0.2
    rule, jrule = dr.RULES[name](), jdr.RULES[name]()
    m, s, t = (_t(v).requires_grad_(True) for v in (mu, sigma, [th, th, th]))
    gmu, gsig = rule.partials(m, s, t[:, None], _t(fmini))[:2]

    def grad(out, wrt):
        if not out.requires_grad:  # a constant partial (LCB's d/dmu = -1)
            return [torch.zeros_like(w) for w in wrt]
        return torch.autograd.grad(out.sum(), wrt, allow_unused=True,
                                   materialize_grads=True, retain_graph=True)

    dmu, dsig = grad(gmu, (m, s, t)), grad(gsig, (s, t))
    thv = jnp.asarray([th], jnp.float64)
    J = lambda fn: jax.vmap(lambda a, b, f: fn(a, b, thv, f))(
        jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(fmini))
    _close(dmu[0], J(jrule.d2g_dmu), rtol=1e-9, atol=1e-12)
    _close(dmu[1], J(jrule.d2g_dmudsigma), rtol=1e-9, atol=1e-12)
    _close(dmu[2], J(jrule.d2g_dmudtheta)[:, 0], rtol=1e-9, atol=1e-12)
    _close(dsig[0], J(jrule.d2g_dsigma), rtol=1e-9, atol=1e-12)
    _close(dsig[1], J(jrule.d2g_dsigmadtheta)[:, 0], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["LogEI", "LogPOI"])
def test_log_rule_tails(name):
    """Tails (z in [-5, -120]) against float64 autodiff of the JAX rules,
    and the extreme tail (z = -900, -6e4) against the exact asymptotics."""
    s = 0.5
    mu = np.array([2.6, 10.0, 60.0])
    sigma = np.full(3, s)
    fmini = np.full(3, 0.1)
    rule, jrule = dr.RULES[name](), jdr.RULES[name]()
    thv = torch.zeros(1, dtype=f64)
    want = _jax_partials(jrule, mu, sigma, 0.0, fmini)
    _close(rule(_t(mu), _t(sigma), thv, _t(fmini)), want[0], rtol=2e-5, atol=1e-4)
    for g, w in zip(rule.partials(_t(mu), _t(sigma), thv, _t(fmini)), want[1:]):
        _close(g, w, rtol=5e-3, atol=1e-6)

    mu_x = np.array([450.0, 3e4])
    z = (0.1 - mu_x) / s
    args = (_t(mu_x), _t(np.full(2, s)), thv, _t(np.full(2, 0.1)))
    v = rule(*args)
    gmu, gsig, gmumu, gsigsig, gmusig = rule.partials(*args)
    assert torch.all(torch.isfinite(v))
    _close(v, -0.5 * z**2, rtol=1e-2)
    _close(gmu, -np.abs(z) / s, rtol=1e-2)
    _close(gmumu, np.full(2, -1.0 / s**2), rtol=2e-2)
    _close(gmusig, 2.0 * np.abs(z) / s**2, rtol=2e-2)
    _close(gsigsig, -3.0 * z**2 / s**2, rtol=2e-2)


def test_sigma_guards():
    mu, fmini = _t([0.0, 0.0]), _t([1.0, 1.0])
    sigma = _t([1e-9, 0.5])                       # below / above sigma_tol
    thv = torch.zeros(1, dtype=f64)
    assert dr.EI()(mu, sigma, thv, fmini)[0] == 0.0
    assert dr.POI()(mu, sigma, thv, fmini)[0] == 0.0
    assert dr.LogPOI()(mu, sigma, thv, fmini)[0] == -0.25 * torch.finfo(f64).max
    for p in dr.EI().partials(mu, sigma, thv, fmini):
        assert p[0] == 0.0
    assert dr.POI().solve_f_tol == 1e-3 and dr.POI().solve_x_tol == 1e-3


# --------------------------------------------------------------------------
# surrogate and fantasy
# --------------------------------------------------------------------------


def _data(n=7, d=3, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (n, d))
    y = np.sin(2.0 * X.sum(axis=1)) + 0.2 * rng.standard_normal(n)
    return X, y


def _port_state(js):
    return sg.from_numpy_state(js.kernel.kind, js.kernel.theta, js.X, js.y, js.L,
                               js.Li, js.c, js.n, js.noise, device="cpu", dtype=f64)


@pytest.mark.parametrize("kind", ["matern52", "periodic"])
def test_fit_and_from_numpy_state(kind):
    X, y = _data()
    theta = (0.9, 3.0) if kind == "periodic" else (0.8,)
    js = jsg.fit(jK.RBFKernel(jnp.asarray(theta), kind), X, y, capacity=12,
                 noise=1e-5, dtype=jnp.float64)
    st = sg.fit(K.RBFKernel(_t(theta), kind), X, y, capacity=12, noise=1e-5,
                device="cpu", dtype=f64)
    assert int(st.n) == int(js.n) == 7
    for got, want in ((st.X, js.X), (st.y, js.y), (st.L, js.L), (st.Li, js.Li),
                      (st.c, js.c)):
        _close(got, want)
    # carried across unchanged: bit for bit
    ps = _port_state(js)
    for got, want in ((ps.L, js.L), (ps.Li, js.Li), (ps.c, js.c)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_posterior_acquisition_and_condition_match_jax():
    X, y = _data()
    js = jsg.fit(jK.matern52((0.8,)), X, y, capacity=12, noise=1e-5,
                 dtype=jnp.float64)
    st = _port_state(js)
    xs = np.random.default_rng(2).uniform(-1.0, 1.0, (4, 3))
    p = sg.posterior(st, _t(xs))
    jp = jax.vmap(lambda x: jsg.posterior(js, x))(jnp.asarray(xs))
    for f in ("mu", "grad_mu", "hess_mu", "sigma", "grad_sigma", "hess_sigma",
              "kx", "grad_kx", "w"):
        _close(getattr(p, f), getattr(jp, f))
    dmu, S = sg.joint_posterior_cov(st, _t(xs))
    jdmu, jS = jax.vmap(lambda x: jsg.joint_posterior_cov(js, x))(jnp.asarray(xs))
    _close(dmu, jdmu)
    _close(S, jS)
    _close(sg.get_active_minimum(st), jsg.get_active_minimum(js))

    # rules whose closed forms are exact here (the LogEI tail at z < -1 is
    # a ~1e-6 polynomial, held in test_log_rule_tails)
    theta = np.array([0.1])
    for rule, jrule in ((dr.EI(), jdr.EI()), (dr.POI(), jdr.POI()),
                        (dr.LCB(), jdr.LCB())):
        a, g, H = sg.acquisition_value_grad_hess(st, rule, _t(xs), _t(theta))
        ja, jg, jH = jax.vmap(lambda x: jsg.acquisition_value_grad_hess(
            js, jrule, x, jnp.asarray(theta)))(jnp.asarray(xs))
        _close(a, ja, rtol=1e-9)
        _close(g, jg, rtol=1e-9)
        _close(H, jH, rtol=1e-9, atol=1e-12)
        a2, g2 = sg.acquisition_grad(st, rule, _t(xs), _t(theta))
        _close(a2, ja, rtol=1e-9)
        _close(g2, jg, rtol=1e-9)
        _close(sg.acquisition(st, rule, _t(xs), _t(theta)), ja, rtol=1e-9)

    xnew, ynew = np.array([0.2, -0.3, 0.5]), 0.7
    st2 = sg.condition(st, _t(xnew), torch.tensor(ynew, dtype=f64))
    js2 = jsg.condition(js, jnp.asarray(xnew), ynew)
    assert int(st2.n) == int(js2.n) == 8
    for f in ("X", "y", "L", "Li", "c"):
        _close(getattr(st2, f), getattr(js2, f))


def test_fantasy_views_at_every_index_match_jax():
    X, y = _data(n=6, d=2)
    js = jsg.fit(jK.matern52((0.8,)), X, y, capacity=9, noise=1e-5,
                 dtype=jnp.float64)
    horizon = 2
    jfs = jfant.make_fantasy(js, horizon)
    fs = fant.make_fantasy(_port_state(js), horizon)
    for f in ("X", "y", "L", "Li", "cs"):
        _close(getattr(fs, f), getattr(jfs, f))
    rng = np.random.default_rng(8)
    for _ in range(horizon + 1):
        xnew, ynew = rng.uniform(-1.0, 1.0, 2), float(rng.standard_normal())
        jfs = jfant.fantasy_condition(jfs, jnp.asarray(xnew), ynew)
        fs = fant.fantasy_condition(fs, _t(xnew), torch.tensor(ynew, dtype=f64))
    assert fs.m == int(jfs.m) == horizon + 1
    for f in ("X", "y", "L", "Li", "cs"):
        _close(getattr(fs, f), getattr(jfs, f))
    # views at the base and at every past fantasy index, not only the newest
    x = np.array([0.1, 0.4])
    for fi in range(-1, horizon + 1):
        v, jv = fant.view(fs, fi), jfant.view(jfs, fi)
        assert int(v.n) == int(jv.n)
        for f in ("L", "Li", "c"):
            _close(getattr(v, f), getattr(jv, f))
        p, jp = sg.posterior(v, _t(x)), jsg.posterior(jv, jnp.asarray(x))
        _close(p.mu, jp.mu)
        _close(p.sigma, jp.sigma)
        _close(p.hess_sigma, jp.hess_sigma)
