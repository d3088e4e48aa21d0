"""PyTorch port, the BO loops against the JAX package.

Both packages run the same trial from the same initial design (numpy, a
seed) in float64 on the CPU, hyperparameter MLE on at every iteration. The
JAX loops solve with the Li-formulated XLA solver, the port with its lane
solver, which takes the same Li form in float64; they agree to rounding
except where two starts tie, so the functions here (braninhoo, hartmann3d)
have no symmetry that makes starts tie. Tolerances:
- myopic: sampled X within 1e-6 of the box width, the fitted lengthscale
  rtol 1e-6, gaps / regrets / minimum observations rtol 1e-7 and 1e-7
  absolute: an observation inherits its point's difference times the
  function's slope, and braninhoo's slope is of order 1e2 where its box
  is 15 wide (1e-8 fails there by 1.7e-8 on a regret of 0.4);
- non-myopic (h = 1, 8 QMC samples, 4 + 2 restarts, 3 SGA iterations):
  sampled X within 1e-5 of the box width: each point is the end of an Adam
  ascent on IFT gradients, which amplify the solvers' 1e-12 differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu.utils import checkpoint as jckpt
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import checkpoint as ckpt

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64


def _x_init(f, seed=3, n=5):
    return np.random.default_rng(seed).uniform(f.lbs, f.ubs, (n, f.dim))


def _width(f):
    return float((f.ubs - f.lbs).max())


def _state_fields(st):
    """A port state as numpy fields, named as the JAX package's."""
    out = {f: getattr(st, f).detach().cpu().numpy() for f in
           ("X", "y", "L", "c", "n", "noise", "Li")}
    out["theta"], out["kind"] = st.kernel.theta.detach().cpu().numpy(), st.kernel.kind
    return out


def _assert_same_trial(res, jres, f, *, x_tol, theta_rtol=1e-6, metric_rtol=1e-7):
    np.testing.assert_allclose(res.X, jres.X, rtol=0.0, atol=x_tol * _width(f))
    fields = _state_fields(res.state)
    np.testing.assert_allclose(fields["theta"], np.asarray(jres.state.kernel.theta),
                               rtol=theta_rtol)
    assert int(fields["n"]) == int(jres.state.n) == res.X.shape[0]
    for name in ("gaps", "simple_regrets", "minimum_observations"):
        np.testing.assert_allclose(getattr(res, name), getattr(jres, name),
                                   rtol=metric_rtol, atol=metric_rtol, err_msg=name)
    np.testing.assert_allclose(res.y, jres.y, rtol=1e-6, atol=1e-8)
    assert res.times.shape == jres.times.shape and np.all(res.times > 0.0)


@pytest.mark.parametrize("rule_name,theta", [("EI", 0.0), ("LCB", 2.0)])
@pytest.mark.parametrize("name", ["braninhoo", "hartmann3d"])
def test_run_myopic_bo_matches_jax(name, rule_name, theta):
    f, jf = tf.get_function(name), jtf.get_function(name)
    x_init = _x_init(f)
    kw = dict(theta=(theta,), num_starts=16, x_init=x_init)
    # budget 3 is a prefix of budget 6: for one case the lengthscale is held
    # to the JAX package's after the third MLE as well as after the sixth
    for budget in (3, 6) if (name, rule_name) == ("hartmann3d", "EI") else (6,):
        jres = jbo.run_myopic_bo(jf, jdr.RULES[rule_name](), budget=budget,
                                 dtype=jnp.float64, steps_per_call=1, **kw)
        res = bo.run_myopic_bo(f, dr.RULES[rule_name](), budget=budget, device="cpu", **kw)
        _assert_same_trial(res, jres, f, x_tol=1e-6)
    assert float(res.state.kernel.theta[0]) != 1.0          # the MLE moved it
    assert np.all(np.diff(res.gaps) >= 0.0) and res.gaps[0] == 0.0
    np.testing.assert_array_equal(res.X[:5], x_init)


@pytest.mark.parametrize("rule_name", ["POI", "Random"])
def test_run_myopic_bo_poi_and_random_run_in_box_and_repeat(rule_name):
    f = tf.get_function("hartmann3d")
    run = lambda seed: bo.run_myopic_bo(f, dr.RULES[rule_name](), budget=5, num_starts=8,
                                        seed=seed, device="cpu")
    a, b = run(5), run(5)
    assert a.X.shape == (10, 3) and np.all(np.isfinite(a.y))
    assert np.all((a.X >= f.lbs) & (a.X <= f.ubs))
    np.testing.assert_array_equal(a.X, b.X)                  # deterministic under the seed
    np.testing.assert_array_equal(a.y, b.y)
    assert not np.array_equal(a.X, run(6).X)
    if rule_name == "Random":
        # no MLE for the random baseline (the JAX loop masks it out too)
        assert float(a.state.kernel.theta[0]) == 1.0


def test_run_myopic_bo_float32_and_mle_every():
    f = tf.get_function("hartmann3d")
    res = bo.run_myopic_bo(f, dr.EI(), budget=4, num_starts=8, x_init=_x_init(f),
                           mle_every=10**9, dtype=torch.float32, device="cpu")
    assert res.state.X.dtype == torch.float32
    assert float(res.state.kernel.theta[0]) == 1.0 and np.all(np.isfinite(res.y))


def test_run_nonmyopic_bo_matches_jax():
    f, jf = tf.get_function("braninhoo"), jtf.get_function("braninhoo")
    kw = dict(horizon=1, mc_iters=8, budget=3, num_starts=8, num_restarts=4,
              sgd_iters=3, lr=0.05, solver_iterations=8, x_init=_x_init(f))
    jres = jbo.run_nonmyopic_bo(jf, dtype=jnp.float64, **kw)
    res = bo.run_nonmyopic_bo(f, device="cpu", **kw)
    _assert_same_trial(res, jres, f, x_tol=1e-5, theta_rtol=1e-5, metric_rtol=1e-6)
    assert all(1 <= it <= 3 for it in res.sga_iterations)
    assert res.fallbacks.dtype == bool and res.fallbacks.shape == (3,)


def test_run_nonmyopic_bo_deterministic_matches_jax():
    f, jf = tf.get_function("hartmann3d"), jtf.get_function("hartmann3d")
    kw = dict(horizon=1, budget=2, num_starts=8, num_restarts=2, sgd_iters=2, lr=0.05,
              solver_iterations=8, x_init=_x_init(f), deterministic=True, ghq_nodes=3)
    jres = jbo.run_nonmyopic_bo(jf, dtype=jnp.float64, **kw)
    res = bo.run_nonmyopic_bo(f, device="cpu", **kw)
    _assert_same_trial(res, jres, f, x_tol=1e-5, theta_rtol=1e-5, metric_rtol=1e-6)
    assert bo._ghq_node_scale(True) == pytest.approx(jbo._ghq_node_scale(True), rel=1e-15)
    assert bo._ghq_node_scale(False) == 1.0


def _overconfident(dtype=f64):
    """A surrogate whose MC rollout acquisition is exactly zero everywhere:
    a tight 1-d gramacylee fit where no +-3 sigma draw crosses the incumbent
    (tests/test_solvers_and_bo.py::_overconfident_state)."""
    X = np.array([1.28383, 1.03912, 1.16751, 1.67047, 2.00633, 1.5, 2.5,
                  0.5, 0.70338, 0.8217])[:, None]
    y = tf.gramacylee().batch(torch.tensor(X, dtype=f64)).numpy()
    st = sg.fit(K.matern52((0.266,), device="cpu", dtype=dtype), X, y, capacity=16,
                noise=1e-6, device="cpu", dtype=dtype)
    js = jsg.fit(jK.matern52((0.266,)), X, y, capacity=16, noise=1e-6, dtype=jnp.float64)
    return st, js, X


def test_exploration_fallback_finds_nonzero_ei_point():
    """When the rollout estimate is flat zero, the fallback's analytic LogEI
    solve must return a NEW in-bounds point (the reference re-samples a
    duplicate and the trial dies); here also the JAX package's point."""
    st, js, X = _overconfident()
    t = lambda a: torch.tensor(np.array(a), dtype=f64)
    xstarts = qmc.generate_initial_guesses(8, [0.5], [2.5])
    fb = bo._make_exploration_fallback(dr.EI(), t([0.0]), t([0.5]), t([2.5]),
                                       t(xstarts), 12)
    x, v = fb(st)
    jfb = jbo._make_exploration_fallback(jdr.EI(), jnp.zeros(1), jnp.asarray([0.5]),
                                         jnp.asarray([2.5]), jnp.asarray(xstarts), 12)
    jx, jv = jfb(js)
    assert np.isfinite(float(v)) and 0.5 <= float(x[0]) <= 2.5
    assert float(np.min(np.abs(X[:, 0] - float(x[0])))) > 1e-3
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6 * 2.0)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)


def test_exploration_fallback_gates_pick_the_max_sigma_start():
    """A LogEI optimum under log(1e-4 max(1, |fmini|)), or one on top of an
    observed point, gives way to the start of largest posterior sigma."""
    t = lambda a: torch.tensor(np.array(a), dtype=f64)
    # data far below the zero prior mean: LogEI's argmax glues to the incumbent
    X = np.array([[0.1], [0.5], [0.9]])
    y = np.array([-50.0, -80.0, -60.0])
    st = sg.fit(K.matern52((0.05,), device="cpu"), X, y, capacity=8, noise=1e-6,
                device="cpu")
    js = jsg.fit(jK.matern52((0.05,)), X, y, capacity=8, noise=1e-6, dtype=jnp.float64)
    xstarts = qmc.generate_initial_guesses(6, [0.0], [1.0])
    x, v = bo._make_exploration_fallback(dr.EI(), t([0.0]), t([0.0]), t([1.0]),
                                         t(xstarts), 12)(st)
    jx, _ = jbo._make_exploration_fallback(jdr.EI(), jnp.zeros(1), jnp.zeros(1),
                                           jnp.ones(1), jnp.asarray(xstarts), 12)(js)
    sig = sg.posterior(st, t(xstarts)).sigma
    assert float(x[0]) == float(xstarts[int(torch.argmax(sig)), 0])
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-9)
    # an LCB rollout falls back on LCB itself, with no LogEI floor
    x2, _ = bo._make_exploration_fallback(dr.LCB(), t([2.0]), t([0.0]), t([1.0]),
                                          t(xstarts), 12)(st)
    assert 0.0 <= float(x2[0]) <= 1.0


def test_nonmyopic_bo_does_not_resample_duplicates():
    """float32 end to end: zero-EI plateaus must not trap the loop on one
    point (tests/test_solvers_and_bo.py, same name); the fallback is taken."""
    f = tf.gramacylee()
    res = bo.run_nonmyopic_bo(f, horizon=0, mc_iters=16, budget=6, num_starts=8,
                              num_restarts=4, sgd_iters=10, seed=11, solver_iterations=10,
                              dtype=torch.float32, device="cpu")
    sampled = res.X[5:, 0]
    for i in range(1, len(sampled)):
        assert float(np.min(np.abs(sampled[i] - sampled[:i]))) > 1e-5, \
            f"duplicate sample at BO iteration {i}: {sampled}"
    assert np.all((sampled >= 0.5) & (sampled <= 2.5))


def test_nonmyopic_fallback_is_taken_on_a_flat_acquisition(monkeypatch):
    """With the rollout value forced to zero, every iteration takes the
    fallback and still samples new in-box points."""
    from rollout_bo_tpu_torch.rollout import outer

    f = tf.get_function("hartmann3d")
    flat = lambda state, tp, rule, xstarts, restarts, **kw: outer.FusedSolve(
        restarts[0], torch.zeros((), dtype=f64), 0)
    monkeypatch.setattr(outer, "stochastic_solve_fused", flat)
    res = bo.run_nonmyopic_bo(f, horizon=1, mc_iters=4, budget=3, num_starts=8,
                              num_restarts=2, x_init=_x_init(f), device="cpu")
    assert res.fallbacks.all() and res.sga_iterations.tolist() == [0, 0, 0]
    new = res.X[5:]
    assert np.all((new >= f.lbs) & (new <= f.ubs))
    assert len({tuple(np.round(x, 6)) for x in res.X}) == 8      # no duplicates


# --------------------------------------------------------------------------
# checkpoints: the second bridge between the packages
# --------------------------------------------------------------------------


def test_checkpoint_crosses_between_the_packages(tmp_path):
    f, jf = tf.get_function("hartmann3d"), jtf.get_function("hartmann3d")
    x_init = _x_init(f)
    y_init = f.batch(torch.tensor(x_init)).numpy()
    st = sg.fit(K.matern52((0.4,), device="cpu"), x_init, y_init, capacity=9,
                noise=1e-6, device="cpu")
    js = jsg.fit(jK.matern52((0.4,)), x_init, y_init, capacity=9, noise=1e-6,
                 dtype=jnp.float64)
    metrics = dict(gaps=np.arange(3.0), X_all=x_init, y_all=y_init)

    # port -> JAX
    ckpt.save_bo_checkpoint(str(tmp_path / "from_port"), st, iteration=2, metrics=metrics)
    jst, it, saved = jckpt.load_bo_checkpoint(str(tmp_path / "from_port"))
    assert it == 2 and jst.kernel.kind == "matern52"
    np.testing.assert_array_equal(saved["X_all"], x_init)
    mine = _state_fields(st)
    for fld in ("X", "y", "L", "c", "Li", "noise"):
        np.testing.assert_allclose(np.asarray(getattr(jst, fld)), mine[fld], rtol=1e-12,
                                   atol=1e-14)
    assert int(jst.n) == 5

    # JAX -> port, the same schema letter for letter
    jckpt.save_bo_checkpoint(str(tmp_path / "from_jax"), js, iteration=3, metrics=metrics)
    a = np.load(str(tmp_path / "from_jax.npz"))
    b = np.load(str(tmp_path / "from_port.npz"))
    assert sorted(a.files) == sorted(b.files)
    pst, it, saved = ckpt.load_bo_checkpoint(str(tmp_path / "from_jax"), device="cpu")
    assert it == 3 and pst.X.dtype == f64 and pst.n.dtype == torch.int64
    theirs = _state_fields(pst)
    for fld in ("X", "y", "L", "c", "Li", "noise", "theta"):
        np.testing.assert_allclose(theirs[fld], mine[fld], rtol=1e-10, atol=1e-13)
    np.testing.assert_array_equal(saved["gaps"], np.arange(3.0))

    # the capacity= re-fit branch: a snapshot resumes under a larger budget
    big, _, _ = ckpt.load_bo_checkpoint(str(tmp_path / "from_jax"), capacity=12,
                                        device="cpu")
    assert big.capacity == 12 and int(big.n) == 5
    x = torch.tensor(x_init[0] * 0.9)
    np.testing.assert_allclose(float(sg.posterior(big, x).mu),
                               float(sg.posterior(st, x).mu), rtol=1e-9)

    # save_state / load_state carry the surrogate alone
    ckpt.save_state(str(tmp_path / "state"), st)
    np.testing.assert_array_equal(ckpt.load_state(str(tmp_path / "state"),
                                                  device="cpu").L.numpy(), mine["L"])
    jloaded = jckpt.load_state(str(tmp_path / "state"))
    np.testing.assert_allclose(np.asarray(jloaded.c), mine["c"], rtol=1e-12)


class _Killed(Exception):
    pass


def test_myopic_trial_killed_after_its_checkpoint_resumes_to_the_same_result(
        tmp_path, monkeypatch):
    f = tf.get_function("hartmann3d")
    kw = dict(budget=6, num_starts=8, seed=11, x_init=_x_init(f), solver_iterations=6,
              device="cpu")
    save = ckpt.save_bo_checkpoint

    def save_then_die(path, state, *, iteration, metrics=None):
        save(path, state, iteration=iteration, metrics=metrics)
        if iteration == 4:
            raise _Killed

    for rule in (dr.EI(), dr.RandomAcquisition()):
        full = bo.run_myopic_bo(f, rule, **kw)
        ck = str(tmp_path / f"ck_{rule.name}")
        with monkeypatch.context() as m:
            m.setattr(ckpt, "save_bo_checkpoint", save_then_die)
            with pytest.raises(_Killed):
                bo.run_myopic_bo(f, rule, checkpoint_path=ck, checkpoint_every=2, **kw)
        # iterations 0..3 come from the snapshot, 4..5 run live; the Random
        # rule's stream continues where the snapshot left it
        res = bo.run_myopic_bo(f, rule, checkpoint_path=ck, checkpoint_every=2, **kw)
        np.testing.assert_allclose(res.X, full.X, rtol=1e-10)
        np.testing.assert_allclose(res.y, full.y, rtol=1e-10)
        np.testing.assert_allclose(res.gaps, full.gaps, rtol=1e-10)
        np.testing.assert_allclose(res.minimum_observations, full.minimum_observations,
                                   rtol=1e-10)


@pytest.mark.parametrize("qmc_stream", [True, False])
def test_nonmyopic_trial_resumes_from_its_checkpoint(tmp_path, qmc_stream):
    """QMC streams are stateless; the pseudo-random stream is replayed up to
    the snapshot (bo.py:547-552 of the JAX package)."""
    f = tf.get_function("hartmann3d")
    kw = dict(horizon=1, mc_iters=4, num_starts=4, num_restarts=2, sgd_iters=2, seed=13,
              x_init=_x_init(f, n=3), n_init=3, solver_iterations=4,
              use_low_discrepancy=qmc_stream, device="cpu")
    full = bo.run_nonmyopic_bo(f, budget=4, **kw)
    ck = str(tmp_path / "nm_ck")
    bo.run_nonmyopic_bo(f, budget=2, checkpoint_path=ck, checkpoint_every=2, **kw)
    res = bo.run_nonmyopic_bo(f, budget=4, checkpoint_path=ck, checkpoint_every=2, **kw)
    np.testing.assert_allclose(res.y, full.y, rtol=1e-10)
    np.testing.assert_allclose(res.gaps, full.gaps, rtol=1e-10)


def test_default_device_is_the_card():
    """The loops default to device="cuda" and raise without one; they never
    run on the CPU unasked."""
    f = tf.get_function("hartmann3d")
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        bo.run_myopic_bo(f, dr.EI(), budget=1, num_starts=4)
    with pytest.raises((RuntimeError, AssertionError)):
        bo.run_nonmyopic_bo(f, budget=1, num_starts=4, mc_iters=2)
