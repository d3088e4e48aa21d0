"""PyTorch port, the side modules against the JAX package: the explicit
adjoint, the perturbation surrogates, the trust-region solvers, the lazy
posterior record, the experiment setup and the profiling helpers.

The same numpy inputs go to both packages in float64 on the CPU.
Tolerances:
- `gradient_adjoint`: rtol 1e-8 against the JAX package's on the same
  rolled-out trajectory, and rtol 1e-7 against the port's own autograd
  (IFT) route in draw_mode="sample_path" where the inner solves are
  interior (the IFT holds pinned coordinates fixed, the adjoint does not:
  tests/test_adjoint.py makes the same distinction). Where the best step
  is t >= 1 the JAX package's adjoint is NaN: its vjp takes sqrt at K's
  zero diagonal distances (0 * inf); the port's `kernels.eval_KXX` uses a
  NaN-free norm, so the port is held to its autograd route there;
- `spatial_perturbation` / `data_perturbation`: rtol 1e-9;
- `solve_tr` (interior, boundary, indefinite, hard case), `tr_newton`,
  `tr_sr1`: rtol 1e-10;
- `lazy_posterior`, `ExperimentSetup`: equal to `posterior` and to the
  JAX package's arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import fantasy as jfant
from rollout_bo_tpu.models import perturbation as jpert
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import adjoint as jadj
from rollout_bo_tpu.rollout import trajectory as jtraj
from rollout_bo_tpu.rollout import trust_region as jtr
from rollout_bo_tpu.utils import experiment as jexperiment
from rollout_bo_tpu.utils import lazy as jlazy
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import perturbation as pert
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.rollout import adjoint as adj
from rollout_bo_tpu_torch.rollout import observables as obs
from rollout_bo_tpu_torch.rollout import trajectory as traj
from rollout_bo_tpu_torch.rollout import trust_region as tr
from rollout_bo_tpu_torch.utils import experiment, lazy, profiling

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers.
torch.set_num_threads(1)

f64 = torch.float64
T = lambda a: torch.tensor(np.array(a), dtype=f64)

# --------------------------------------------------------------------------
# the explicit adjoint (tests/test_adjoint.py's problem)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def adjoint_problem():
    d, h = 2, 2
    rng = np.random.default_rng(3)
    X = rng.uniform(-1.0, 1.0, size=(7, d))
    y = np.sum(X**2, axis=1) + 0.1 * np.sin(3 * X[:, 0])
    js = jsg.fit(jK.matern52((0.6,)), X, y, capacity=14, noise=1e-6)
    st = sg.fit(K.matern52((0.6,), device="cpu"), X, y, capacity=14, noise=1e-6,
                device="cpu")
    xstarts = qmc.generate_initial_guesses(6, [-1.0] * d, [1.0] * d)
    lo, hi = jnp.full((d,), -1.0), jnp.full((d,), 1.0)

    @jax.jit
    def jax_adjoint(x0, z):
        fs, rec = jtraj.rollout_trajectory(jfant.make_fantasy(js, h), x0, jnp.zeros(1), lo,
                                           hi, jnp.asarray(xstarts), z, jdr.EI(),
                                           iterations=20, draw_mode="sample_path")
        return rec, jadj.gradient_adjoint(fs, rec, jdr.EI(), jnp.zeros(1))

    return dict(st=st, h=h, d=d, xstarts=T(xstarts), jax_adjoint=jax_adjoint)


def _inputs(seed_z, d, h):
    rng = np.random.default_rng(100 + seed_z)
    z = rng.normal(size=(d + 1, h + 1))
    return rng.uniform(-0.8, 0.8, size=(d,)), z


def _port_rollout(p, x0, z, *, grad=False):
    """The port's trajectory in sample_path mode; with `grad`, also the
    autograd gradient of its reward with respect to x0 and theta."""
    lbs, ubs = torch.full((p["d"],), -1.0, dtype=f64), torch.full((p["d"],), 1.0, dtype=f64)
    fs0 = fant.make_fantasy(p["st"], p["h"])
    x0 = T(x0).requires_grad_(grad)
    th = torch.zeros(1, dtype=f64).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        fs, rec = traj.rollout_core(fs0, x0, th, lbs, ubs, p["xstarts"], dr.EI(),
                                    obs.stochastic_observable(T(z), mode="sample_path"),
                                    p["h"], iterations=20)
        r = torch.clamp(traj.base_fmini(fs0) - torch.amin(rec.ys), min=0.0)
        g = torch.autograd.grad(r, (x0, th)) if grad else None
    detached = fant.FantasyState(fs.kernel, *(a.detach() if torch.is_tensor(a) else a
                                               for a in fs[1:]))
    return detached, traj.TrajectoryRecord(*(a.detach() for a in rec)), g


@pytest.mark.parametrize("seed_z", [0, 1, 2, 5])
def test_gradient_adjoint_matches_jax(adjoint_problem, seed_z):
    p = adjoint_problem
    x0, z = _inputs(seed_z, p["d"], p["h"])
    jrec, (jgx, jgth) = p["jax_adjoint"](jnp.asarray(x0), jnp.asarray(z))
    fs, rec, _ = _port_rollout(p, x0, z)
    np.testing.assert_allclose(rec.xs.numpy(), np.asarray(jrec.xs), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rec.ys.numpy(), np.asarray(jrec.ys), rtol=1e-8, atol=1e-10)
    gx, gth = adj.gradient_adjoint(fs, rec, dr.EI(), torch.zeros(1, dtype=f64))
    assert torch.all(torch.isfinite(gx)) and torch.all(torch.isfinite(gth))
    if int(torch.argmin(rec.ys)) >= 1 and float(traj.base_fmini(fs)) > float(rec.ys.min()):
        # case 3 (seed 1): the JAX package's vjp through sqrt(0) is NaN
        assert np.all(np.isnan(np.asarray(jgx))) and np.all(np.isnan(np.asarray(jgth)))
    else:
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(gth.numpy(), np.asarray(jgth), rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("seed_z", [25, 27])
def test_gradient_adjoint_matches_autograd_sample_path(adjoint_problem, seed_z):
    """Case 3 (best step t >= 1): the back-substitution against autograd
    through the IFT rule, on trajectories whose solves leave no coordinate
    pinned where it matters (seed 25: t = 2, all interior; seed 27: t = 1)."""
    p = adjoint_problem
    fs, rec, (gx_ad, gth_ad) = _port_rollout(p, *_inputs(seed_z, p["d"], p["h"]), grad=True)
    assert int(torch.argmin(rec.ys)) >= 1
    gx, gth = adj.gradient_adjoint(fs, rec, dr.EI(), torch.zeros(1, dtype=f64))
    assert float(torch.linalg.vector_norm(gx)) > 0.1
    torch.testing.assert_close(gx, gx_ad, rtol=1e-7, atol=1e-12)
    torch.testing.assert_close(gth, gth_ad, rtol=1e-7, atol=1e-12)


def test_gradient_adjoint_no_improvement_is_zero(adjoint_problem):
    p = adjoint_problem
    fs, rec, _ = _port_rollout(p, *_inputs(25, p["d"], p["h"]))
    gx, gth = adj.gradient_adjoint(fs, rec._replace(ys=rec.ys + 1e3), dr.EI(),
                                   torch.zeros(1, dtype=f64))
    assert torch.equal(gx, torch.zeros(2, dtype=f64)) and torch.equal(gth, torch.zeros(1, dtype=f64))


# --------------------------------------------------------------------------
# perturbation surrogates (tests/test_perturbation_tr_ckpt.py's problem)
# --------------------------------------------------------------------------


def _fantasies(pkg):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(6, 2))
    y = np.sum(np.sin(2 * X), axis=1)
    pts, vals = [np.array([0.2, -0.3]), np.array([-0.4, 0.1])], [0.3, -0.2]
    if pkg == "jax":
        fs = jfant.make_fantasy(jsg.fit(jK.matern52((0.6,)), X, y, capacity=12, noise=1e-6), 1)
        for p, v in zip(pts, vals):
            fs = jfant.fantasy_condition(fs, jnp.asarray(p), jnp.asarray(v))
        return fs
    st = sg.fit(K.matern52((0.6,), device="cpu"), X, y, capacity=12, noise=1e-6, device="cpu")
    fs = fant.make_fantasy(st, 1)
    for p, v in zip(pts, vals):
        fs = fant.fantasy_condition(fs, T(p), T(v))
    return fs


@pytest.mark.parametrize("kind", ["spatial", "data"])
@pytest.mark.parametrize("rule_name", ["EI", "POI"])
def test_perturbations_match_jax(kind, rule_name):
    x_eval, dx, grad_y = np.array([0.35, 0.45]), np.array([0.7, -0.2]), np.array([0.5, -1.0])
    jfs, fs = _fantasies("jax"), _fantasies("port")
    if kind == "spatial":
        jres = jpert.spatial_perturbation(jfs, 1, jdr.RULES[rule_name](), jnp.asarray(x_eval),
                                          jnp.zeros(1), dx, sample_index=1)
        res = pert.spatial_perturbation(fs, 1, dr.RULES[rule_name](), x_eval, [0.0], dx,
                                        sample_index=1)
    else:
        jres = jpert.data_perturbation(jfs, 1, jdr.RULES[rule_name](), jnp.asarray(x_eval),
                                       jnp.zeros(1), dx, grad_y, sample_index=1)
        res = pert.data_perturbation(fs, 1, dr.RULES[rule_name](), x_eval, [0.0], dx, grad_y,
                                     sample_index=1)
    assert isinstance(res, pert.PerturbationResult)
    for mine, theirs, name in zip(res, jres, pert.PerturbationResult._fields):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-9, atol=1e-13,
                                   err_msg=name)
    assert float(torch.abs(res.d_mu)) > 1e-3


def test_refantasize_reproduces_the_conditioned_state():
    fs = _fantasies("port")
    re = pert.refantasize(fs)
    for name in ("L", "Li", "cs"):
        torch.testing.assert_close(getattr(re, name), getattr(fs, name), rtol=1e-9, atol=1e-12)
    from rollout_bo_tpu_torch.models import cost_functions as cf
    rule = cf.cost_aware(dr.EI(), cf.UnitCost())
    with pytest.raises(NotImplementedError, match="cost-aware"):
        pert.spatial_perturbation(fs, 1, rule, [0.3, 0.4], [0.0], [1.0, 0.0], sample_index=1)


# --------------------------------------------------------------------------
# trust region
# --------------------------------------------------------------------------

_TR_CASES = {
    "interior": (np.diag([2.0, 5.0]), [1.0, 1.0], 10.0),
    "boundary": (np.diag([2.0, 5.0]), [1.0, 1.0], 0.1),
    "indefinite": (np.diag([-1.0, 3.0]), [1.0, 1.0], 0.5),
    "hard_case": (np.diag([-2.0, 1.0]), [0.0, 1.0], 1.0),
    "full_3d": (np.array([[4.0, 1.0, 0.5], [1.0, -2.0, 0.3], [0.5, 0.3, 1.0]]),
                [0.2, -1.0, 0.4], 0.7),
}


@pytest.mark.parametrize("case", sorted(_TR_CASES))
def test_solve_tr_matches_jax(case):
    H, g, delta = _TR_CASES[case]
    p, hit = tr.solve_tr(T(g), T(H), delta)
    jp, jhit = jtr.solve_tr(jnp.asarray(g, jnp.float64), jnp.asarray(H), delta)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-10, atol=1e-14)
    assert bool(hit) == bool(jhit) == (case != "interior")
    if case != "interior":
        np.testing.assert_allclose(float(torch.linalg.vector_norm(p)), delta, rtol=1e-4)
    if case == "hard_case":
        val = float(T(g) @ p + 0.5 * p @ T(H) @ p)
        np.testing.assert_allclose(val, -7.0 / 6.0, rtol=1e-6)


def _rosenbrock(xp):
    def vgh(x):
        a, b = x[0], x[1]
        f = (1 - a) ** 2 + 100 * (b - a**2) ** 2
        g = xp.stack([-2 * (1 - a) - 400 * a * (b - a**2), 200 * (b - a**2)])
        H = xp.stack([xp.stack([2 - 400 * (b - a**2) + 800 * a**2, -400 * a]),
                      xp.stack([-400 * a, xp.ones_like(a) * 200.0])])
        return f, g, H
    return vgh


def test_tr_newton_and_sr1_match_jax():
    x, fx = tr.tr_newton(_rosenbrock(torch), T([-1.2, 1.0]), iterations=60)
    jx, jfx = jtr.tr_newton(_rosenbrock(jnp), jnp.asarray([-1.2, 1.0]), iterations=60)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(float(fx), float(jfx), rtol=1e-10, atol=1e-20)
    # the box clip: the minimizer outside [-2, 0.5]^2 is met on its face
    xb, _ = tr.tr_newton(_rosenbrock(torch), T([-1.2, 1.0]), iterations=30, lbs=[-2.0, -2.0],
                         ubs=[0.5, 0.5])
    jxb, _ = jtr.tr_newton(_rosenbrock(jnp), jnp.asarray([-1.2, 1.0]), iterations=30,
                           lbs=[-2.0, -2.0], ubs=[0.5, 0.5])
    np.testing.assert_allclose(xb.numpy(), np.asarray(jxb), rtol=1e-10, atol=1e-12)
    A = np.diag([1.0, 10.0])
    for lbs, ubs in ((None, None), ([0.5, -3.0], [4.0, 3.0])):
        x, fx = tr.tr_sr1(lambda v: (0.5 * v @ T(A) @ v, T(A) @ v), T([3.0, -2.0]),
                          iterations=40, lbs=lbs, ubs=ubs)
        jx, jfx = jtr.tr_sr1(lambda v: (0.5 * v @ jnp.asarray(A) @ v, jnp.asarray(A) @ v),
                             jnp.asarray([3.0, -2.0]), iterations=40, lbs=lbs, ubs=ubs)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(fx), float(jfx), rtol=1e-10, atol=1e-20)
    np.testing.assert_allclose(x.numpy(), [0.5, 0.0], atol=1e-5)


# --------------------------------------------------------------------------
# lazy record, experiment setup, profiling
# --------------------------------------------------------------------------


def test_lazy_posterior_forces_each_group_once(monkeypatch):
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (5, 2))
    st = sg.fit(K.matern52((0.5,), device="cpu"), X, np.sin(X.sum(1)), capacity=8,
                device="cpu")
    x = T([0.1, -0.2])
    want = sg.posterior(st, x)
    calls = {"posterior": 0, "avgh": 0}
    post, avgh = sg.posterior, sg.acquisition_value_grad_hess

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(sg, "posterior", counted("posterior", post))
    monkeypatch.setattr(sg, "acquisition_value_grad_hess", counted("avgh", avgh))
    s = sg.lazy_posterior(st, x, rule=dr.EI())
    assert calls == {"posterior": 0, "avgh": 0} and s.forced() == {}
    for name in ("mu", "grad_mu", "hess_mu", "sigma", "grad_sigma", "hess_sigma"):
        assert torch.equal(getattr(s, name), getattr(want, name))
    assert calls["posterior"] == 1
    a, g, H = avgh(st, dr.EI(), x, torch.zeros(1, dtype=f64))
    assert torch.equal(s.alpha, a) and torch.equal(s.grad_alpha, g)
    assert torch.equal(s.hess_alpha, H) and calls["avgh"] == 1
    dmu, Ld = sg.joint_posterior_chol(st, x)
    assert torch.equal(s.dsigma, Ld) and torch.equal(s.dmu_dsigma[0], dmu)
    assert "alpha" in s and "alpha" not in sg.lazy_posterior(st, x)


def test_lazy_struct_behaves_as_the_jax_package_s():
    for mod in (lazy, jlazy):
        n = [0]

        def thunk():
            n[0] += 1
            return n[0]

        s = mod.LazyStruct(a=thunk)
        assert (s.a, s.a, n[0]) == (1, 1, 1)
        s.set("a", lambda: 7)
        assert s.a == 7 and "a" in s and list(s.keys()) == ["a"] and s.forced() == {"a": 7}
        with pytest.raises(TypeError, match="zero-arg thunks"):
            s.b = 3
        with pytest.raises(AttributeError, match="no property"):
            s.c


@pytest.mark.parametrize("variance_reduction", [True, False])
def test_experiment_setup_matches_jax(variance_reduction):
    lbs, ubs = [-1.0, 0.0, -2.0], [1.0, 2.0, 0.5]
    kw = dict(horizon=2, mc_iters=6, num_starts=5, num_restarts=3, theta=(0.25,),
              variance_reduction=variance_reduction)
    es = experiment.ExperimentSetup.build(lbs, ubs, rng=np.random.default_rng(4),
                                          device="cpu", **kw)
    jes = jexperiment.ExperimentSetup.build(lbs, ubs, rng=np.random.default_rng(4),
                                            dtype=jnp.float64, **kw)
    for mine, theirs in ((es.xstarts, jes.xstarts), (es.restarts, jes.restarts),
                         *zip(es.tp, jes.tp)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert es.tp.rnstream.shape == (6, 4, 3) and es.xstarts.shape == (7, 3)
    re = es.resample(np.random.default_rng(5), variance_reduction=variance_reduction,
                     start_index=6)
    jre = jes.resample(np.random.default_rng(5), variance_reduction=variance_reduction,
                       start_index=6)
    np.testing.assert_array_equal(re.tp.rnstream.numpy(), np.asarray(jre.tp.rnstream))
    assert not torch.equal(re.tp.rnstream, es.tp.rnstream)
    assert re.tp.rnstream.dtype == f64 and torch.equal(re.restarts, es.restarts)


def test_profiling_on_the_cpu(tmp_path):
    kept = len(profiling.RECORDS)
    with profiling.span("outer.step") as s:         # no record open: nothing kept
        pass
    assert s is None and len(profiling.RECORDS) == kept
    with profiling.record("bo.iteration", serial=profiling.next_serial(), b=0, loop="myopic",
                          device="cpu") as rec:
        with profiling.span("bo.acquire") as acquisition:
            with profiling.span("outer.step"):
                torch.ones(3).sum()
            profiling.note(value=0.5, fallback=False)
        profiling.note_refit(True)
        assert profiling.replay_start(torch.device("cpu")) is None   # no timing off CUDA
    assert list(profiling.RECORDS)[kept:] == [rec]
    assert [(s.name, s.parent) for s in rec.spans] == [("bo.iteration", -1), ("bo.acquire", 0),
                                                       ("outer.step", 1)]
    assert rec.within(2, "bo.acquire") and not rec.within(1, "outer.step")
    assert (rec.value, rec.fallback, rec.refit, rec.sga_steps) == (0.5, False, True, 1)
    assert rec.refits == [True]
    assert rec.replays == [] and acquisition.seconds == rec.spans[1].seconds
    assert all(s.seconds >= 0 for s in rec.spans)
    assert not any(hasattr(profiling, n) for n in ("PhaseTimer", "annotate",
                                                   "device_memory_stats"))
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("matmul block"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(e.key == "matmul block" for e in prof.key_averages())