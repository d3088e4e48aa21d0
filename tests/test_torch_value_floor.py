"""PyTorch port: the rollout's value floor in float64, held to the JAX package's.

The lane solver accepts a step only when the acquisition rises in floating
point, so every inner argmax stops within a band set by the rounding of the
posterior variance, and the fantasy draws carry that band into the
rollout's value. The JAX package runs its float64 lanes through its XLA
solver, whose variance is k0 - |Li k|^2 (`models/surrogate.py::posterior`),
and the port's lane solver takes the same Li form for float64 lanes. The
W = K^{-1} form (k0 - k^T W k, the TPU kernel's, which the port keeps for
float32 lanes) rounds with cond(K) instead of its square root.

The problem is tests/test_rollout.py::test_adjoint_gradient_matches_fd_of_mc_1d
(the MC estimate of the 1-D rollout at x0 = 0.52, 6 trajectories, EI, 25
Newton iterations), built in both packages from the same numpy data. The
jitter is the standard deviation of the value about a straight line
through 11 points 1e-7 apart (as tests/test_torch_fd.py::jitter): the
noise a centered difference of half step eps carries as ~jitter / eps of
slope. Held at h 1 to twice the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import mc as jmc
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTrajectoryParams
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.rollout import mc
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# The tensors here are tiny: one intra-op thread (see tests/test_torch_bo.py).
torch.set_num_threads(1)

f64 = torch.float64
X0, M, SPACING, POINTS = 0.52, 6, 1e-7, 11


def _data():
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, size=(6, 1)), axis=0)
    return X, np.sin(6 * X[:, 0]) + 0.3 * X[:, 0]


def _stream(h):
    return np.random.default_rng(3).normal(size=(M, 2, h + 1))


def jitter(value):
    """Std of value(x) about its least-squares line through POINTS points
    SPACING apart around X0."""
    ks = (np.arange(POINTS) - POINTS // 2) * SPACING
    vals = np.array([value(X0 + k) for k in ks])
    return float(np.std(vals - np.polyval(np.polyfit(ks, vals, 1), ks)))


def jax_value(h):
    X, y = _data()
    st = jsg.fit(jK.matern52((0.3,)), X, y, capacity=12, noise=1e-6)
    xstarts = jnp.asarray(qmc.generate_initial_guesses(6, [0.0], [1.0]))
    z = jnp.asarray(_stream(h))
    box = jnp.zeros(1), jnp.ones(1)

    @jax.jit
    def mu(x0):
        tp = JTrajectoryParams(x0=x0, theta=jnp.zeros(1), lbs=box[0], ubs=box[1], rnstream=z)
        return jmc.simulate_trajectory_mc(st, tp, jdr.EI(), xstarts, with_gradients=False,
                                          iterations=25).mu

    return lambda x: float(mu(jnp.asarray([x])))


def port_value(h):
    X, y = _data()
    st = sg.fit(K.matern52((0.3,), device="cpu"), X, y, capacity=12, noise=1e-6,
                device="cpu")
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=f64)  # noqa: E731
    xstarts = t(qmc.generate_initial_guesses(6, [0.0], [1.0]))
    z = t(_stream(h))

    def mu(x):
        tp = TrajectoryParams(x0=t([x]), theta=t([0.0]), lbs=t([0.0]), ubs=t([1.0]),
                              rnstream=z)
        return float(mc.simulate_trajectory_mc(st, tp, dr.EI(), xstarts,
                                               with_gradients=False, iterations=25).mu)

    return mu


def test_rollout_value_floor_within_twice_the_jax_packages():
    jv, pv = jax_value(1), port_value(1)
    # the two packages compute the same rollout value
    np.testing.assert_allclose(pv(X0), jv(X0), rtol=1e-6)
    ours, theirs = jitter(pv), jitter(jv)
    assert np.isfinite(ours) and theirs > 0.0
    assert ours <= 2.0 * theirs, (ours, theirs)
