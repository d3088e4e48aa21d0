"""PyTorch port: the outer solvers of the non-myopic loop (`outer_solver=
"batch" | "scanned"`), against the JAX package.

Both packages run the same one-iteration trial from the same initial
design in float64 on the CPU, with the tolerances of
tests/test_torch_bo.py's non-myopic case (sampled X within 1e-5 of the box
width). `sgd_iters` 3 is not a multiple of the window k = 2, so the
scanned solver runs 4 iterations where the fused one stops at 3. Nearly
all of this file's time is the JAX package's compiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.rollout import bo

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
