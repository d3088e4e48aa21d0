"""PyTorch port: the outer solvers of the non-myopic loop (`outer_solver=
"batch" | "scanned"`), against the JAX package.

Both packages run the same one-iteration trial from the same initial
design in float64 on the CPU, with the tolerances of
tests/test_torch_bo.py's non-myopic case (sampled X within 1e-5 of the box
width). `sgd_iters` 3 is not a multiple of the window k = 2, so the
scanned solver runs 4 iterations where the fused one stops at 3.

The stepped and scanned entry points themselves (`outer.
stochastic_solve_stepped` / `_scanned`) are held to the JAX package's on
tests/test_adaptive.py's problem (sixhump, 4 observations, 3 restarts, 6
trajectories), with its tolerances (rtol 1e-6, atol 1e-8). Nearly all of
this file's time is the JAX package's compiles.
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
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTP
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.rollout import bo, outer
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# The tensors here are tiny: one intra-op thread (see tests/test_torch_bo.py).
torch.set_num_threads(1)


@pytest.mark.parametrize("outer_solver", ["batch", "scanned"])
def test_run_nonmyopic_bo_outer_solver_matches_jax(outer_solver):
    f, jf = tf.get_function("braninhoo"), jtf.get_function("braninhoo")
    x_init = np.random.default_rng(5).uniform(f.lbs, f.ubs, (5, f.dim))
    kw = dict(horizon=1, mc_iters=8, budget=1, num_starts=8, num_restarts=4, sgd_iters=3,
              lr=0.05, solver_iterations=8, x_init=x_init, steps_per_call=2)
    jres = jbo.run_nonmyopic_bo(jf, dtype=jnp.float64, outer_solver=outer_solver, **kw)
    res = bo.run_nonmyopic_bo(f, device="cpu", outer_solver=outer_solver, **kw)
    width = float((f.ubs - f.lbs).max())
    np.testing.assert_allclose(res.X, jres.X, rtol=0.0, atol=1e-5 * width)
    np.testing.assert_allclose(float(res.state.kernel.theta[0]),
                               float(jres.state.kernel.theta[0]), rtol=1e-5)
    np.testing.assert_allclose(res.gaps, jres.gaps, rtol=1e-6, atol=1e-6)
    fused = bo.run_nonmyopic_bo(f, device="cpu", **kw)
    if outer_solver == "batch":
        np.testing.assert_array_equal(res.sga_iterations, [-1])
        np.testing.assert_array_equal(res.X, fused.X)        # fused's points
    else:
        # whole windows of 2: 4 iterations where fused stopped at its 3
        assert (res.sga_iterations.tolist(), fused.sga_iterations.tolist()) == ([4], [3])
        assert not np.array_equal(res.X, fused.X)


def test_outer_solver_is_checked():
    f = tf.get_function("gramacylee")
    with pytest.raises(ValueError, match="outer solver"):
        bo.run_nonmyopic_bo(f, budget=1, device="cpu", outer_solver="stepped")


def _sixhump_problem():
    """tests/test_adaptive.py's problem in both packages: (JAX state, its
    TrajectoryParams, xstarts, starts), (the port's four)."""
    f = jtf.get_function("sixhump")
    X = qmc.randsample(4, f.dim, f.lbs, f.ubs, np.random.default_rng(0))
    y = np.array(f.batch(X))
    xstarts = qmc.generate_initial_guesses(4, f.lbs, f.ubs)
    starts = qmc.generate_batch(3, f.lbs, f.ubs)[:3]
    z = qmc.gen_low_discrepancy_sequence(6, f.dim, 2)
    jst = jsg.fit(jK.matern52((0.7,)), X, y, capacity=12, noise=1e-6)
    jtp = JTP(x0=jnp.zeros(f.dim), theta=jnp.asarray([0.0]), lbs=jnp.asarray(f.lbs),
              ubs=jnp.asarray(f.ubs), rnstream=jnp.asarray(z))
    t = lambda a: torch.tensor(np.asarray(a, float), dtype=torch.float64)  # noqa: E731
    st = sg.fit(K.matern52((0.7,), device="cpu"), X, y, capacity=12, noise=1e-6,
                device="cpu")
    tp = TrajectoryParams(x0=t(np.zeros(f.dim)), theta=t([0.0]), lbs=t(f.lbs),
                          ubs=t(f.ubs), rnstream=t(z))
    return ((jst, jtp, jnp.asarray(xstarts), jnp.asarray(starts)),
            (st, tp, t(xstarts), t(starts)))


@pytest.mark.parametrize("solver,window", [("stepped", "sync_every"),
                                           ("scanned", "steps_per_call")])
def test_stepped_and_scanned_entry_points_match_jax(solver, window):
    """max_iters 5 with a window of 2: the stepped solver runs at most 5
    iterations, the scanned one whole windows (6); both agree with the JAX
    functions, and with the port's fused solver run as they are defined."""
    (jst, jtp, jxstarts, jstarts), (st, tp, xstarts, starts) = _sixhump_problem()
    kw = {"max_iters": 5, "lr": 0.05, "inner_iterations": 4, window: 2}
    jxs, jvals = getattr(jouter, f"stochastic_solve_{solver}")(
        jst, jtp, jdr.EI(), jxstarts, jstarts, **kw)
    xs, vals = getattr(outer, f"stochastic_solve_{solver}")(
        st, tp, dr.EI(), xstarts, starts, **kw)
    assert xs.shape == (3, 2) and vals.shape == (3,)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6, atol=1e-8)
    fused = outer.stochastic_solve_fused(
        st, tp, dr.EI(), xstarts, starts, max_iters=5, lr=0.05, inner_iterations=4,
        steps_per_call=2 if solver == "scanned" else 1)
    assert torch.equal(xs, fused.x) and torch.equal(vals, fused.value)
