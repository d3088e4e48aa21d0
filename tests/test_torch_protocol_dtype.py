"""PyTorch port: the levy10d EI cell of the regret-parity sweep, held to the
JAX package in each dtype.

The port's sweep runs the myopic CLI at its default float64, as
`scripts/run_parity_sweep.sh` does; the JAX record in
`results/myopic/levy10d` was run at `--dtype float32`
(`scripts/parity_queue_r3b.sh`, `parity_queue_r4b.sh`). There the port's
EI and LCB cells end at mean final gaps of 0.1 against the record's 0.98.
The cause is the dtype, not the port: the initial design's values are
33-138, the GP's prior mean is 0, so EI is flat far from the data and the
argmax is a tie between starts. In float32 the tie goes to the first
start, the domain's centre (0, ..., 0), near levy10d's minimum at (1, ...,
1); in float64 it goes to a corner of the box. Both packages take the same
points in each dtype: to 1e-6 of the box width in float64, and to 1e-4 in
float32, where the MLE refit rounds apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.experiments import myopic as jmyopic
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu_torch.experiments import myopic
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.rollout import bo

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("float64", 1e-6)])
def test_levy10d_ei_takes_the_jax_packages_points_in_each_dtype(dtype, atol):
    f, jf = testfns.get_function("levy10d"), jtf.get_function("levy10d")
    rng = np.random.default_rng(1906)           # the CLI's first trial, seed 1906
    x_init = np.asarray(f.lbs) + (np.asarray(f.ubs) - np.asarray(f.lbs)) \
        * rng.uniform(size=(5, f.dim))
    (rule, theta), (jrule, jtheta) = myopic.ACQS["ei"], jmyopic.ACQS["ei"]
    kw = dict(budget=2, num_starts=64, seed=1906, x_init=x_init)
    res = bo.run_myopic_bo(f, rule(), theta=theta, dtype=getattr(torch, dtype), device="cpu",
                           **kw)
    jres = jbo.run_myopic_bo(jf, jrule(), theta=jtheta, dtype=getattr(jnp, dtype), **kw)
    X, jX = np.asarray(res.X, np.float64), np.asarray(jres.X, np.float64)
    np.testing.assert_allclose(X, jX, rtol=0.0, atol=atol * 20.0)     # the box is [-10, 10]^10
    if dtype == "float32":
        assert np.all(X[5] == 0.0) and res.gaps[-1] > 0.95             # the centre
    else:
        assert np.abs(X[6]).min() == 10.0 and res.gaps[-1] == 0.0      # a corner
    np.testing.assert_allclose(res.gaps, np.asarray(jres.gaps), rtol=0.0, atol=1e-6)
