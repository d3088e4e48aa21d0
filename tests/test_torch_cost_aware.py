"""PyTorch port, the cost-aware path against the JAX package.

The same numpy inputs (seeded) go to both packages in float64 on the CPU.
Tolerances:
- the cost channel (`acquisition`, `acquisition_grad`,
  `acquisition_value_grad_hess` under `NonUniformCost` and
  `GaussianProcessCost`, EI / POI divided by c, LogEI minus log c): value
  rtol 1e-10, gradient rtol 1e-8, Hessian rtol 1e-7, with atols 1e-15 /
  1e-12 / 1e-10: a point in EI's tail has a value of order 1e-10 whose
  absolute rounding (~1e-17, from mu and sigma) is a larger relative one;
- `newton_solve_batch`: per-start solutions within 1e-6 of the box width,
  values rtol 1e-8 and atol 1e-12: on an EI plateau both solvers return
  values of order 1e-197 whose digits are rounding;
- the cost-aware rollout estimate (`simulate_trajectory_mc`): mu and
  grad_x rtol 1e-6.
The JAX side runs under `jax.jit`: its compile is most of this file's time.
The CLI is held in tests/test_torch_cost_aware_cli.py. The routing test shows that a `CostAwareRule` named "EI" never reaches
the lane kernel's entry point, which has no cost channel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import cost_functions as jcf
from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import mc as jmc
from rollout_bo_tpu.rollout import solvers as jsolvers
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTrajectoryParams
from rollout_bo_tpu_torch.models import cost_functions as cf
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import newton_lanes
from rollout_bo_tpu_torch.rollout import mc, solvers
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers.
torch.set_num_threads(1)

f64 = torch.float64
T = lambda a: torch.tensor(np.array(a), dtype=f64)


def _nonuniform(xp):
    """The same cost c(x) = 2 + ||x - 0.5||^2 + 0.3 sin(x_0) for both packages."""
    return lambda x: 2.0 + xp.sum((x - 0.5) ** 2) + 0.3 * xp.sin(x[0])


@pytest.fixture(scope="module")
def problem():
    """A sixhump surrogate (4 points, capacity 12) in both packages, and two
    cost models: a closed-form one and a GP fit to 8 cost observations."""
    f = jtf.get_function("sixhump")
    rng = np.random.default_rng(0)
    X = qmc.randsample(4, f.dim, f.lbs, f.ubs, rng)
    y = np.asarray(f.batch(X))
    Xc = qmc.randsample(8, f.dim, f.lbs, f.ubs, rng)
    yc = 1.0 + 0.2 * np.sum(Xc**2, axis=1)
    js = jsg.fit(jK.matern52((0.7,)), X, y, capacity=12, noise=1e-6)
    st = sg.fit(K.matern52((0.7,), device="cpu"), X, y, capacity=12, noise=1e-6,
                device="cpu")
    jcost_state = jsg.fit(jK.matern52((1.0,)), Xc, yc, capacity=8, noise=1e-6)
    cost_state = sg.fit(K.matern52((1.0,), device="cpu"), Xc, yc, capacity=8, noise=1e-6,
                        device="cpu")
    costs = {"nonuniform": (jcf.NonUniformCost(_nonuniform(jnp)),
                            cf.NonUniformCost(_nonuniform(torch))),
             "gp": (jcf.GaussianProcessCost(jcost_state), cf.GaussianProcessCost(cost_state))}
    # points near the incumbent, where z = (fmini - mu) / sigma is in
    # [0.04, 0.23]: the LogEI tail (z < -1) is a Mills-ratio polynomial in
    # the port, accurate to ~1e-6 only (tests/test_torch_models.py)
    near = X[np.argmin(y)] + np.random.default_rng(1).uniform(-0.4, 0.4, (2, 3, f.dim))
    return dict(f=f, js=js, st=st, costs=costs,
                xs=qmc.generate_initial_guesses(6, f.lbs, f.ubs), points=near,
                spread=rng.uniform(f.lbs, f.ubs, (16, f.dim)))


def _rules(problem, rule_name, cost_name):
    jcost, cost = problem["costs"][cost_name]
    return (jcf.cost_aware(jdr.RULES[rule_name](), jcost),
            cf.cost_aware(dr.RULES[rule_name](), cost))


_CHANNEL = [(r, c) for r in ("EI", "POI", "LogEI") for c in ("nonuniform", "gp")]


@pytest.fixture(scope="module")
def jax_channel(problem):
    """The JAX package's (value, grad, hess) at the points for every
    (rule, cost) pair, from one jitted program (its compile is what costs)."""
    js, th = problem["js"], jnp.zeros(1)
    rules = [_rules(problem, r, c)[0] for r, c in _CHANNEL]

    @jax.jit
    @jax.vmap
    def jax_side(x):
        return [jsg.acquisition_value_grad_hess(js, rule, x, th) for rule in rules]

    out = jax_side(jnp.asarray(problem["points"].reshape(-1, 2)))
    shapes = ((2, 3), (2, 3, 2), (2, 3, 2, 2))
    return {key: [np.asarray(v).reshape(s) for v, s in zip(vals, shapes)]
            for key, vals in zip(_CHANNEL, out)}


@pytest.mark.parametrize("rule_name,cost_name", _CHANNEL)
def test_cost_channel_matches_jax(problem, jax_channel, rule_name, cost_name):
    """Value, gradient and Hessian at a (2, 3) lane batch of points: the
    port's lane axes against the JAX package's vmap over the points."""
    _, rule = _rules(problem, rule_name, cost_name)
    pts = problem["points"]
    th = torch.zeros(1, dtype=f64)
    a = sg.acquisition(problem["st"], rule, T(pts), th)
    ag, g = sg.acquisition_grad(problem["st"], rule, T(pts), th)
    av, gv, H = sg.acquisition_value_grad_hess(problem["st"], rule, T(pts), th)
    assert a.shape == (2, 3) and g.shape == (2, 3, 2) and H.shape == (2, 3, 2, 2)
    ja, jg, jH = jax_channel[rule_name, cost_name]
    for mine in (a, ag, av):
        np.testing.assert_allclose(mine.numpy(), ja, rtol=1e-10, atol=1e-15)
    for mine in (g, gv):
        np.testing.assert_allclose(mine.numpy(), jg, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(H.numpy(), jH, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("cost_name", ["nonuniform", "gp"])
@pytest.mark.parametrize("rule_name", ["EI", "LogEI"])
def test_cost_channel_hessian_matches_torch_func(problem, rule_name, cost_name):
    """The quotient-rule (divide) and log-subtracted derivatives against
    torch.func.grad / hessian of the port's own acquisition."""
    _, rule = _rules(problem, rule_name, cost_name)
    th = torch.zeros(1, dtype=f64)
    acq = lambda x: sg.acquisition(problem["st"], rule, x, th)
    for x in T(problem["points"].reshape(-1, 2)):
        _, g, H = sg.acquisition_value_grad_hess(problem["st"], rule, x, th)
        torch.testing.assert_close(g, torch.func.grad(acq)(x), rtol=1e-8, atol=1e-12)
        torch.testing.assert_close(H, torch.func.hessian(acq)(x), rtol=1e-7, atol=1e-10)


def test_cost_models_and_refusals(problem):
    x = T([0.3, -0.2])
    u = cf.UnitCost()
    assert float(u(x)) == 1.0 and u(T(np.zeros((4, 2)))).shape == (4,)
    assert torch.equal(u.grad(x), torch.zeros(2, dtype=f64))
    assert torch.equal(u.hess(T(np.zeros((3, 2)))), torch.zeros((3, 2, 2), dtype=f64))
    assert cf.UniformCost(2.5).uniform and float(cf.UniformCost(2.5)(x)) == 2.5
    jnu, nu = problem["costs"]["nonuniform"]
    for fn, jfn in ((nu, jnu), (nu.grad, jnu.grad), (nu.hess, jnu.hess)):
        np.testing.assert_allclose(fn(x).numpy(), np.asarray(jfn(jnp.asarray(x.numpy()))),
                                   rtol=1e-12)
    # the GP cost's floor: where mu <= 1e-6 the cost is 1e-6 and its
    # derivatives vanish, as jax.grad of jnp.maximum gives there
    jgp, gp = problem["costs"]["gp"]
    pts = T(problem["spread"])
    signed = sg.fit(K.matern52((1.0,), device="cpu"), pts[:4], T([-1.0, 2.0, -0.5, 1.0]),
                    capacity=4, device="cpu")
    neg = cf.GaussianProcessCost(signed)                 # its mean dips below 0
    mu = sg.posterior(signed, pts).mu
    c, gc, Hc = neg.derivatives(pts, 2)
    low = mu <= 1e-6
    assert bool(low.any()) and bool((~low).any())
    assert torch.all(c[low] == 1e-6) and torch.all(gc[low] == 0) and torch.all(Hc[low] == 0)
    np.testing.assert_allclose(gp(x).numpy(), float(jgp(jnp.asarray(x.numpy()))), rtol=1e-12)
    # a rule keeps its name and sigma_tol; LCB and double composition are refused
    rule = cf.cost_aware(dr.EI(), nu)
    assert rule.name == "EI" and rule.cost is nu and isinstance(rule, dr.DecisionRule)
    with pytest.raises(ValueError, match="undefined"):
        cf.cost_aware(dr.LCB(), nu)
    with pytest.raises(ValueError, match="already cost-aware"):
        cf.cost_aware(rule, nu)
    wa = cf.cost_weighted_rule(dr.EI(), nu)
    th = torch.zeros(1, dtype=f64)
    torch.testing.assert_close(wa(problem["st"], x, th),
                               sg.acquisition(problem["st"], dr.EI(), x, th) / nu(x),
                               rtol=1e-14, atol=0.0)


# POI without a cost: the loose freeze (cost_aware keeps only the name and
# sigma_tol of the rule it wraps, in both packages)
_SOLVER_CASES = {"EI_no_cost": ("EI", None), "EI_nonuniform": ("EI", "nonuniform"),
                 "POI_loose_freeze": ("POI", None), "LogEI_nonuniform": ("LogEI", "nonuniform")}


@pytest.mark.parametrize("case", sorted(_SOLVER_CASES))
def test_newton_solve_batch_matches_jax(problem, case):
    rule_name, cost_name = _SOLVER_CASES[case]
    if cost_name is None:
        jrule, rule = jdr.RULES[rule_name](), dr.RULES[rule_name]()
    else:
        jrule, rule = _rules(problem, rule_name, cost_name)
    f = problem["f"]
    assert (rule.solve_f_tol > 0) == ("loose" in case)
    jx, jv = jax.jit(lambda js: jsolvers.newton_solve_batch(
        js, jrule, jnp.zeros(1), f.lbs, f.ubs, problem["xs"], iterations=8))(problem["js"])
    x, v = solvers.newton_solve_batch(problem["st"], rule, torch.zeros(1, dtype=f64),
                                      f.lbs, f.ubs, problem["xs"], iterations=8)
    assert x.shape == (8, 2) and v.shape == (8,)
    width = float(np.max(f.ubs - f.lbs))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0.0, atol=1e-6 * width)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-12)


def test_newton_solve_batch_lanes_match_jax_vmap(problem):
    """Three lanes (three surrogates of one capacity, per-lane active
    counts) against jax.vmap of the JAX solver (the cost's lane axes are
    held by test_cost_channel_matches_jax)."""
    f = problem["f"]
    rng = np.random.default_rng(4)
    fits = []
    for n in (3, 5, 7):
        X = rng.uniform(f.lbs, f.ubs, (n, 2))
        fits.append((X, np.asarray(f.batch(X))))
    js = [jsg.fit(jK.matern52((0.7,)), X, y, capacity=9, noise=1e-6) for X, y in fits]
    ps = [sg.fit(K.matern52((0.7,), device="cpu"), X, y, capacity=9, noise=1e-6,
                 device="cpu") for X, y in fits]
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *js)
    st = sg.SurrogateState(ps[0].kernel, noise=ps[0].noise,
                           **{k: torch.stack([getattr(p, k) for p in ps])
                              for k in ("X", "y", "L", "c", "n", "Li")})
    solve = lambda s: jsolvers.newton_solve_batch(s, jdr.EI(), jnp.zeros(1), f.lbs, f.ubs,
                                                  problem["xs"], iterations=6)
    jx, jv = jax.jit(jax.vmap(solve))(jstack)
    x, v = solvers.newton_solve_batch(st, dr.EI(), torch.zeros((3, 1), dtype=f64), f.lbs,
                                      f.ubs, problem["xs"], iterations=6)
    assert x.shape == (3, 8, 2)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0.0,
                               atol=1e-6 * float(np.max(f.ubs - f.lbs)))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-12)


def test_cost_aware_rule_never_reaches_the_lane_kernel(problem, monkeypatch):
    """A CostAwareRule keeps the name "EI", which the lane kernel supports:
    the routing must look at the cost first. The kernel's entry point is
    made to raise; the cost-aware solves still run, the plain rule does not."""
    def no_cost_channel(*args, **kw):
        raise AssertionError("a cost-aware rule reached the lane kernel")

    monkeypatch.setattr(newton_lanes, "newton_solve_lanes", no_cost_channel)
    f = problem["f"]
    _, rule = _rules(problem, "EI", "nonuniform")
    assert rule.name == "EI" and newton_lanes.supported("matern52", "EI")
    assert not solvers.supported("matern52", rule) and solvers.supported("matern52", dr.EI())
    th = torch.zeros(1, dtype=f64)
    res = solvers.multistart_maximize(problem["st"], rule, th, f.lbs, f.ubs, problem["xs"],
                                      iterations=6)
    xs, vs = solvers.newton_solve_batch(problem["st"], rule, th, f.lbs, f.ubs,
                                        problem["xs"], iterations=6)
    j = int(torch.argmax(vs))
    assert torch.equal(res.x, xs[j]) and torch.equal(res.value, vs[j])
    lanes = problem["st"]._replace(**{k: getattr(problem["st"], k).expand(
        (2,) + getattr(problem["st"], k).shape) for k in ("X", "y", "L", "c", "n", "Li")})
    x, v = solvers.maximize_hot(lanes, rule, th.expand(2, 1), T(f.lbs), T(f.ubs),
                                T(problem["xs"]), iterations=6)
    assert x.shape == (2, 2) and torch.equal(x[0], res.x) and torch.equal(v[1], res.value)
    with pytest.raises(AssertionError, match="reached the lane kernel"):
        solvers.multistart_maximize(problem["st"], dr.EI(), th, f.lbs, f.ubs, problem["xs"])


def test_cost_aware_rollout_matches_jax(problem):
    """simulate_trajectory_mc under a cost-aware base policy (sixhump, 6
    QMC samples, h 1, 6 inner iterations): mu and grad_x rtol 1e-6."""
    f = problem["f"]
    jrule, rule = _rules(problem, "EI", "nonuniform")
    z = qmc.gen_low_discrepancy_sequence(6, f.dim, 2)
    x0 = np.array([0.1, 0.2])
    jtp = JTrajectoryParams(x0=jnp.asarray(x0), theta=jnp.zeros(1), lbs=jnp.asarray(f.lbs),
                            ubs=jnp.asarray(f.ubs), rnstream=jnp.asarray(z))
    jeto = jax.jit(lambda js, tp: jmc.simulate_trajectory_mc(
        js, tp, jrule, jnp.asarray(problem["xs"]), with_gradients=True,
        iterations=6))(problem["js"], jtp)
    tp = TrajectoryParams(x0=T(x0), theta=torch.zeros(1, dtype=f64), lbs=T(f.lbs),
                          ubs=T(f.ubs), rnstream=T(z))
    eto = mc.simulate_trajectory_mc(problem["st"], tp, rule, T(problem["xs"]),
                                    with_gradients=True, iterations=6)
    assert float(eto.mu) > 0.0
    np.testing.assert_allclose(float(eto.mu), float(jeto.mu), rtol=1e-6)
    np.testing.assert_allclose(eto.grad_x.numpy(), np.asarray(jeto.grad_x), rtol=1e-6,
                               atol=1e-12)
