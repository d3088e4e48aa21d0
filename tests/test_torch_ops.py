"""PyTorch port, ops layer: kernels, Cholesky helpers, QMC, test functions.

Every input is made from a seed with numpy and fed to both packages; the
JAX package runs on the CPU in float64 (tests/conftest.py). Tolerance:
float64 at rtol 1e-10 — the math is the same and only the summation order
differs, which costs a few ulps times the condition of the small products.
The QMC host code is a copy and must agree exactly.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import testfns as jtestfns
from rollout_bo_tpu.ops import chol as jchol
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc as jqmc
from rollout_bo_tpu.ops import small_chol as jsmall
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.ops import chol, qmc, small_chol
from rollout_bo_tpu_torch.ops import kernels as K

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64
RTOL = 1e-10
KINDS = ["matern52", "matern32", "matern12", "squared_exponential", "periodic"]
THETA = {"periodic": (0.9, 3.0)}


def _t(a):
    return torch.tensor(np.array(a), dtype=f64)


def _kernels(kind):
    theta = THETA.get(kind, (0.7,))
    return (jK.RBFKernel(theta=jnp.asarray(theta, jnp.float64), kind=kind),
            K.RBFKernel(_t(theta), kind))


def _close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parent.parent / "rollout_bo_tpu_torch"
    bad = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib") or top == "rollout_bo_tpu":
                    bad.append(f"{path.name}: {name}")
    assert not bad, bad


def test_qmc_streams_equal_the_jax_package():
    lbs, ubs = np.array([-2.0, 0.0, 1.0]), np.array([2.0, 5.0, 3.0])
    np.testing.assert_array_equal(qmc.gen_low_discrepancy_sequence(16, 3, 4),
                                  jqmc.gen_low_discrepancy_sequence(16, 3, 4))
    np.testing.assert_array_equal(
        qmc.gen_low_discrepancy_sequence(8, 4, 2, log10_parity=True, start=3),
        jqmc.gen_low_discrepancy_sequence(8, 4, 2, log10_parity=True, start=3))
    np.testing.assert_array_equal(qmc.generate_initial_guesses(8, lbs, ubs),
                                  jqmc.generate_initial_guesses(8, lbs, ubs))
    np.testing.assert_array_equal(qmc.generate_batch(8, lbs, ubs),
                                  jqmc.generate_batch(8, lbs, ubs))
    np.testing.assert_array_equal(
        qmc.randsample(5, 3, lbs, ubs, np.random.default_rng(4)),
        jqmc.randsample(5, 3, lbs, ubs, np.random.default_rng(4)))


@pytest.mark.parametrize("name", ["trid2d", "trid10d"])
def test_trid_value_and_autograd(name):
    f, jf = testfns.get_function(name), jtestfns.get_function(name)
    np.testing.assert_array_equal(f.bounds, jf.bounds)
    X = np.random.default_rng(1).uniform(f.lbs, f.ubs, (4, f.dim))
    _close(f.batch(_t(X)), jf.batch(jnp.asarray(X)), rtol=1e-13)
    _close(f.grad(_t(X)), jf.batch_grad(jnp.asarray(X)), rtol=1e-13)
    assert f.fmin == pytest.approx(jf.fmin, rel=1e-13)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_assembly_matches_jax(kind):
    jk, k = _kernels(kind)
    rng = np.random.default_rng(7)
    X = rng.uniform(-1.0, 1.0, (9, 3))
    xs = rng.uniform(-1.0, 1.0, (4, 3))
    _close(K.eval_KXX(k, _t(X), noise=1e-5), jK.eval_KXX(jk, jnp.asarray(X), noise=1e-5))
    # batched over a leading lane axis: one x per row of xs
    _close(K.eval_KxX(k, _t(xs), _t(X)),
           jax.vmap(lambda x: jK.eval_KxX(jk, x, jnp.asarray(X)))(jnp.asarray(xs)))
    _close(K.eval_grad_KxX(k, _t(xs), _t(X)),
           jax.vmap(lambda x: jK.eval_grad_KxX(jk, x, jnp.asarray(X)))(jnp.asarray(xs)))
    coeff = rng.standard_normal(9)
    _close(K.hess_contraction(k, _t(xs), _t(X), _t(coeff)),
           jax.vmap(lambda x: jK.hess_contraction(jk, x, jnp.asarray(X),
                                                  jnp.asarray(coeff)))(jnp.asarray(xs)))
    # at a data point (rho = 0) the Hessian takes psi''(0)
    _close(K.hess_contraction(k, _t(X[2]), _t(X), _t(coeff)),
           jK.hess_contraction(jk, jnp.asarray(X[2]), jnp.asarray(X), jnp.asarray(coeff)))
    for r in (xs[0] - X[0], np.zeros(3)):
        _close(K.kernel_joint_block(k, _t(r)), jK.kernel_joint_block(jk, jnp.asarray(r)))


def test_safe_norm_gradient_is_finite_at_zero():
    _, k = _kernels("matern52")
    X = torch.zeros((3, 2), dtype=f64)
    x = torch.zeros(2, dtype=f64, requires_grad=True)
    (g,) = torch.autograd.grad(K.eval_KxX(k, x, X).sum(), x)
    assert torch.all(torch.isfinite(g)) and torch.all(g == 0.0)


def _padded_K(n=5, cap=8, seed=3):
    rng = np.random.default_rng(seed)
    jk, k = _kernels("matern52")
    X = np.zeros((cap, 2))
    X[:n] = rng.uniform(-1.0, 1.0, (n, 2))
    return jk, k, X, np.asarray(jK.eval_KXX(jk, jnp.asarray(X), noise=1e-5))


def test_masked_cholesky_inverse_and_psd_apply():
    _, _, _, Kmat = _padded_K()
    n = 5
    L = chol.masked_cholesky(_t(Kmat), torch.tensor(n))
    jL = jchol.masked_cholesky(jnp.asarray(Kmat), n)
    _close(L, jL)
    np.testing.assert_array_equal(np.asarray(L[n:, n:]), np.eye(3))   # identity padding
    Li = chol.tri_inv_padded(L)
    jLi = jchol.tri_inv_padded(jL)
    _close(Li, jLi)
    b = np.r_[np.random.default_rng(0).standard_normal(n), np.zeros(3)]
    _close(chol.psd_apply(Li, _t(b)), jchol.psd_apply(jLi, jnp.asarray(b)))


def test_chol_append_row_with_inv_per_lane_n():
    jk, k, X, Kmat = _padded_K()
    xnew = np.array([0.3, -0.4])
    kvec = np.asarray(jK.eval_KxX(jk, jnp.asarray(xnew), jnp.asarray(X)))
    k0 = 1.0 + 1e-5
    lanes_L, lanes_Li, ns = [], [], [3, 5]
    for n in ns:
        jL = jchol.masked_cholesky(jnp.asarray(Kmat), n)
        lanes_L.append(np.asarray(jL))
        lanes_Li.append(np.asarray(jchol.tri_inv_padded(jL)))
    # two lanes with different active counts in one batched call
    L2, Li2 = chol.chol_append_row_with_inv(_t(lanes_L), _t(lanes_Li), _t(kvec),
                                            torch.tensor(k0, dtype=f64),
                                            torch.tensor(ns))
    for i, n in enumerate(ns):
        jL2, jLi2 = jchol.chol_append_row_with_inv(
            jnp.asarray(lanes_L[i]), jnp.asarray(lanes_Li[i]), jnp.asarray(kvec), k0, n)
        _close(L2[i], jL2)
        _close(Li2[i], jLi2)


def test_small_chol_and_spd_solve():
    rng = np.random.default_rng(11)
    B = rng.standard_normal((4, 6, 6))
    A = B @ np.swapaxes(B, -1, -2) + 0.5 * np.eye(6)
    b = rng.standard_normal((4, 6))
    _close(small_chol.chol_small(_t(A)), jax.vmap(jsmall.chol_small)(jnp.asarray(A)))
    _close(small_chol.spd_solve_small(_t(A), _t(b)),
           jax.vmap(jsmall.spd_solve_small)(jnp.asarray(A), jnp.asarray(b)))
    # not PD: NaN, never an exception (the IFT guard relies on it)
    A_bad = A.copy()
    A_bad[1] = -A_bad[1]
    out = small_chol.spd_solve_small(_t(A_bad), _t(b))
    assert torch.isnan(out[1]).any() and torch.isfinite(out[0]).all()
    assert torch.isnan(small_chol.chol_small(_t(A_bad))[1]).any()
