"""PyTorch port: rollout gradients against centered finite differences.

The port's other tests pin it to the JAX package's values; these hold its
gradients to the function they are the gradient of, on the CPU route and,
with the `cuda` marker, on the card through the Newton lane kernel (float64
both). The problems, seeds, eps and tolerances are those of
tests/test_rollout.py:141-254 (the explanatory.ipynb validation: the
gradient of the MC estimate against centered FD of it under common random
numbers; the Gauss-Hermite and ground-truth-observable estimators) and of
tests/test_adjoint.py:98-139 (the explicit adjoint on the ground-truth
observable, exact there, against FD of the reward). Each GP state comes
from `surrogate.fit(..., device=...)` on the same numpy data.

This file imports no jax: on a GPU machine without it,

    python -m pytest --noconftest -m cuda tests/test_torch_fd.py

A centered difference carries the rollout value's rounding floor as noise
of ~jitter / eps of slope. The lane solver runs float64 lanes in the Li
form, whose floor is the JAX package's (tests/test_torch_value_floor.py);
with the W = K^{-1} form that noise at MC 1-D h 2 was as large as the
tolerance. `chip_smoke.py` phase 11 runs the same problems (`PROBLEMS`) on
the card, with `averaged_fd` and `jitter` beside the single difference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import fantasy as fant
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout import adjoint as adj
from rollout_bo_tpu_torch.rollout import mc
from rollout_bo_tpu_torch.rollout import observables as obs
from rollout_bo_tpu_torch.rollout import trajectory as traj
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# The tensors here are tiny: one intra-op thread (see tests/test_torch_bo.py).
torch.set_num_threads(1)

f64 = torch.float64


class FDCheck(NamedTuple):
    grad: np.ndarray       # the port's gradient (adjoint / autograd), per coordinate
    fd: np.ndarray         # centered FD of the function it differentiates
    rtol: float
    atol: float
    value: Callable        # the function, u (coordinates) -> float
    u0: np.ndarray         # the point the gradient is taken at
    eps: float             # the FD's half step
    branch: bool = True    # the adjoint problem: its FD branch was taken


def averaged_fd(res: FDCheck, spacing=1e-7, n=11):
    """The mean of n centered differences (half step res.eps, as the
    check's own) taken at n points `spacing` apart around u0, per
    coordinate. Each carries the function's rounding floor as noise of
    ~sqrt(2) jitter / (2 eps); where the floor changes between the points,
    the mean averages it down, which a single difference at u0 cannot."""
    fd = []
    for k in range(res.u0.size):
        e = np.zeros_like(res.u0)
        e[k] = 1.0
        fd.append(np.mean([(res.value(res.u0 + (j * spacing + res.eps) * e)
                            - res.value(res.u0 + (j * spacing - res.eps) * e)) / (2 * res.eps)
                           for j in range(-(n // 2), n - n // 2)]))
    return np.asarray(fd)


def jitter(res: FDCheck, spacing=1e-7, n=11):
    """Standard deviation of the function's values about a straight line
    through n points `spacing` apart around u0 along its first coordinate:
    the function's rounding floor, which a centered FD of half step eps
    carries as ~jitter / eps of slope."""
    ks = (np.arange(n) - n // 2) * spacing
    e = np.zeros_like(res.u0)
    e[0] = 1.0
    vals = np.array([res.value(res.u0 + k * e) for k in ks])
    return float(np.std(vals - np.polyval(np.polyfit(ks, vals, 1), ks)))


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, float), dtype=f64, device=dev)


def _num(a):
    return np.atleast_1d(a.detach().cpu().numpy()).astype(float)


def base_state_1d(dev, n=6, seed=0, cap=12):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0.0, 1.0, size=(n, 1)), axis=0)
    y = np.sin(6 * X[:, 0]) + 0.3 * X[:, 0]
    return sg.fit(K.matern52((0.3,), device=dev), X, y, capacity=cap, noise=1e-6, device=dev)


def base_state_2d(dev, n=8, seed=1, cap=16):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n, 2))
    y = np.sum(X**2, axis=1) + 0.2 * np.sin(3 * X[:, 0])
    return sg.fit(K.matern52((0.6,), device=dev), X, y, capacity=cap, noise=1e-6, device=dev)


def _tp(st, x0, h, M, seed=3, theta=(0.0,)):
    dev, d = st.X.device, st.dim
    z = np.random.default_rng(seed).normal(size=(M, d + 1, h + 1))
    lbs = np.zeros(d) if d == 1 else -np.ones(d)
    return TrajectoryParams(x0=_t(x0, dev), theta=_t(theta, dev), lbs=_t(lbs, dev),
                            ubs=_t(np.ones(d), dev), rnstream=_t(z, dev))


def _starts(n, d, dev):
    lo = [0.0] if d == 1 else [-1.0] * d
    return _t(qmc.generate_initial_guesses(n, lo, [1.0] * d), dev)


def _centered(value, u, eps):
    """Centered FD of value(u) along each coordinate of u, eps apart."""
    u = np.atleast_1d(np.asarray(u, float))
    fd = []
    for k in range(u.size):
        e = np.zeros_like(u)
        e[k] = eps
        fd.append((value(u + e) - value(u - e)) / (2 * eps))
    return np.asarray(fd)


def fd_mc_1d(dev, h):
    """tests/test_rollout.py::test_adjoint_gradient_matches_fd_of_mc_1d."""
    st = base_state_1d(dev)
    xstarts = _starts(6, 1, dev)

    def estimate(x0v, with_grad):
        return mc.simulate_trajectory_mc(st, _tp(st, x0v, h=h, M=6), dr.EI(), xstarts,
                                         with_gradients=with_grad, iterations=25)

    x0 = np.array([0.52])
    value = lambda u: float(estimate(u, False).mu)  # noqa: E731
    g = _num(estimate(x0, True).grad_x)
    return FDCheck(g, _centered(value, x0, 3e-5), 5e-3, 5e-6, value, x0, 3e-5)


def fd_mc_2d(dev):
    """tests/test_rollout.py::test_adjoint_gradient_matches_fd_of_mc_2d."""
    st = base_state_2d(dev)
    xstarts = _starts(8, 2, dev)

    def estimate(x0v, with_grad):
        return mc.simulate_trajectory_mc(st, _tp(st, x0v, h=1, M=4, seed=11), dr.EI(),
                                         xstarts, with_gradients=with_grad, iterations=25)

    x0 = np.array([0.15, -0.2])
    value = lambda u: float(estimate(u, False).mu)  # noqa: E731
    g = _num(estimate(x0, True).grad_x)
    return FDCheck(g, _centered(value, x0, 3e-5), 1e-2, 1e-5, value, x0, 3e-5)


def fd_theta(dev):
    """tests/test_rollout.py::test_adjoint_theta_gradient_matches_fd."""
    st = base_state_1d(dev)
    xstarts = _starts(6, 1, dev)

    def estimate(thv, with_grad):
        tp = _tp(st, np.array([0.52]), h=2, M=6, theta=(float(np.squeeze(thv)),))
        return mc.simulate_trajectory_mc(st, tp, dr.EI(), xstarts, with_gradients=with_grad,
                                         iterations=25)

    value = lambda u: float(estimate(u, False).mu)  # noqa: E731
    g = _num(estimate(0.0, True).grad_theta)
    return FDCheck(g, _centered(value, 0.0, 3e-5), 1e-2, 1e-6, value, np.zeros(1), 3e-5)


def fd_ghq(dev):
    """tests/test_rollout.py::test_ghq_gradient_matches_fd."""
    st = base_state_1d(dev)
    xstarts = _starts(6, 1, dev)
    lb, ub, th = _t([0.0], dev), _t([1.0], dev), _t([0.0], dev)

    def est(x0v, wg):
        return mc.simulate_trajectory_ghq(st, _t(x0v, dev), th, lb, ub, xstarts, dr.EI(),
                                          horizon=1, num_nodes=4, with_gradients=wg,
                                          iterations=25)

    value = lambda u: float(est(u, False).mu)  # noqa: E731
    g = _num(est([0.52], True).grad_x)
    return FDCheck(g, _centered(value, 0.52, 3e-5), 1e-2, 1e-5, value, np.array([0.52]),
                   3e-5)


def fd_deterministic(dev):
    """tests/test_rollout.py::test_deterministic_rollout_gradient_matches_fd:
    the ground-truth observable."""
    st = base_state_1d(dev)
    xstarts = _starts(6, 1, dev)
    lb, ub, th = _t([0.0], dev), _t([1.0], dev), _t([0.0], dev)
    f = lambda x: torch.sin(6 * x[..., 0]) + 0.3 * x[..., 0]  # noqa: E731

    def est(x0v, wg):
        return mc.simulate_trajectory_deterministic(st, _t(x0v, dev), th, lb, ub, xstarts,
                                                    dr.EI(), f, horizon=1, with_gradients=wg,
                                                    iterations=25)

    value = lambda u: float(est(u, False).mu)  # noqa: E731
    g = _num(est([0.52], True).grad_x)
    return FDCheck(g, _centered(value, 0.52, 3e-5), 1e-2, 1e-5, value, np.array([0.52]),
                   3e-5)


def fd_explicit_adjoint(dev, x0=(-0.3, 0.5), seed=5):
    """tests/test_adjoint.py::test_adjoint_matches_fd_deterministic_observable:
    the explicit dual back-substitution (`adjoint.gradient_adjoint`) on the
    ground-truth observable, where sample-path semantics are exact, against
    centered FD (eps 1e-6) of the rollout reward. `branch`: the trajectory
    takes the back-substitution branch, an improvement at a best step
    t >= 1 whose inner argmaxes (steps 1..t) are interior. Later steps do
    not enter the gradient (the dual masks them, the reward does not see
    them), so unlike the JAX test's condition they may end at the box; with
    the JAX test's x0 (0.41, -0.23) the trajectory does not improve."""
    d, h = 2, 2
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(7, d))
    y = np.sum(X**2, axis=1) + 0.1 * np.sin(3 * X[:, 0])
    state = sg.fit(K.matern52((0.6,), device=dev), X, y, capacity=14, noise=1e-6, device=dev)
    lbs, ubs = _t(-np.ones(d), dev), _t(np.ones(d), dev)
    xstarts = _t(qmc.generate_initial_guesses(6, [-1.0] * d, [1.0] * d), dev)
    theta = _t([0.0], dev)
    fs0 = fant.make_fantasy(state, h)
    draw = obs.deterministic_observable(lambda x: torch.sum(x**2, dim=-1)
                                        + 0.3 * torch.sin(4.0 * x[..., 0]))

    def rollout(x0v):
        return traj.rollout_core(fs0, _t(x0v, dev), theta, lbs, ubs, xstarts, dr.EI(), draw,
                                 h, iterations=20)

    def reward(rec):
        return float(torch.clamp(traj.base_fmini(fs0) - torch.amin(rec.ys), min=0.0))

    fs_final, rec = rollout(x0)
    gx, _ = adj.gradient_adjoint(fs_final, rec, dr.EI(), theta)
    best = int(torch.argmin(rec.ys))
    inner = _num(rec.xs[1:best + 1])
    branch = (reward(rec) > 1e-10 and best >= 1
              and bool(np.all((inner > -1.0 + 1e-6) & (inner < 1.0 - 1e-6))))
    value = lambda u: reward(rollout(u)[1])  # noqa: E731
    return FDCheck(_num(gx), _centered(value, x0, 1e-6), 5e-4, 1e-7, value,
                   np.asarray(x0, float), 1e-6, branch)


PROBLEMS = {
    "MC 1-D, h 1": lambda dev: fd_mc_1d(dev, 1),
    "MC 1-D, h 2": lambda dev: fd_mc_1d(dev, 2),
    "MC 2-D, h 1": fd_mc_2d,
    "theta gradient, MC 1-D, h 2": fd_theta,
    "Gauss-Hermite, 4 nodes, h 1": fd_ghq,
    "ground-truth observable, h 1": fd_deterministic,
    "explicit adjoint, ground-truth observable, h 2": fd_explicit_adjoint,
}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def dev(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the inner solves run the CUDA kernel there")
    return torch.device(request.param)


def _check(res: FDCheck):
    assert np.all(np.isfinite(res.grad)) and np.all(np.isfinite(res.fd))
    np.testing.assert_allclose(res.grad, res.fd, rtol=res.rtol, atol=res.atol)


@pytest.mark.parametrize("h", [1, 2])
def test_adjoint_gradient_matches_fd_of_mc_1d(dev, h):
    _check(fd_mc_1d(dev, h))


def test_adjoint_gradient_matches_fd_of_mc_2d(dev):
    _check(fd_mc_2d(dev))


def test_adjoint_theta_gradient_matches_fd(dev):
    _check(fd_theta(dev))


def test_ghq_gradient_matches_fd(dev):
    _check(fd_ghq(dev))


def test_deterministic_rollout_gradient_matches_fd(dev):
    _check(fd_deterministic(dev))


@pytest.mark.parametrize("x0,branch", [((0.41, -0.23), False), ((-0.3, 0.5), True)],
                         ids=["x0-of-the-jax-test", "improves-at-t1"])
def test_adjoint_matches_fd_deterministic_observable(dev, x0, branch):
    res = fd_explicit_adjoint(dev, x0)
    assert res.branch == branch, "the trajectory's adjoint branch changed"
    _check(res)
