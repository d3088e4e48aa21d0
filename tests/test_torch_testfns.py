"""PyTorch port, the synthetic test-function suite against the JAX package.

Every registry name goes through both packages on the same 16 points, drawn
uniformly in the function's box from a numpy seed, in float64. Tolerances:
values rtol 1e-12 (the same closed forms; only the order of the sums
differs), autograd gradients against `jax.grad` rtol 1e-9; each with an
absolute floor of the same factor times the largest magnitude over the 16
points, for entries that cancel to nearly zero.
"""

import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu_torch.models import testfns as tf

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64


def _points(f, seed=0, n=16):
    rng = np.random.default_rng(seed)
    return f.lbs + (f.ubs - f.lbs) * rng.uniform(size=(n, f.dim))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_registry_has_the_same_names():
    assert list(tf.FUNCTION_REGISTRY) == list(jtf.FUNCTION_REGISTRY)
    assert len(tf.FUNCTION_REGISTRY) == 53
    with pytest.raises(KeyError, match="Unknown test function"):
        tf.get_function("nope")


@pytest.mark.parametrize("name", sorted(jtf.FUNCTION_REGISTRY))
def test_function_matches_jax(name):
    f, jf = tf.get_function(name), jtf.get_function(name)
    assert f.dim == jf.dim
    np.testing.assert_array_equal(f.bounds, jf.bounds)
    np.testing.assert_array_equal(f.lbs, jf.lbs)
    np.testing.assert_array_equal(f.ubs, jf.ubs)
    assert len(f.xopt) == len(jf.xopt)
    for a, b in zip(f.xopt, jf.xopt):
        np.testing.assert_array_equal(a, b)
    assert f.fmin == pytest.approx(jf.fmin, rel=1e-12, abs=1e-12)

    X = _points(f)
    Xt = torch.tensor(X, dtype=f64)
    want = jf.batch(X)
    _close(f.batch(Xt), want, 1e-12)
    _close(f(Xt[3]), want[3], 1e-12)                  # a single point (d,) -> ()
    _close(f.f(Xt.reshape(4, 4, f.dim)).reshape(16), want, 1e-12)   # any lane shape
    wantg = jf.batch_grad(X)
    _close(f.batch_grad(Xt), wantg, 1e-9)
    _close(f.grad(Xt[5]), wantg[5], 1e-9)
    # float32 on request: the function runs in its argument's dtype
    assert f.batch(Xt.float()).dtype == torch.float32


def _pair(name):
    return tf.get_function(name), jtf.get_function(name)


COMBINATORS = {
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "scalar_scale": lambda a, b: a.scalar_scale(2.5),
    "vshift": lambda a, b: a.vshift(-3.0),
    "hshift": lambda a, b: a.hshift(np.array([0.3, -0.2])),
}


@pytest.mark.parametrize("op", sorted(COMBINATORS))
def test_combinators_match_jax(op):
    (a, ja), (b, jb) = _pair("braninhoo"), _pair("sixhump")
    g, jg = COMBINATORS[op](a, b), COMBINATORS[op](ja, jb)
    np.testing.assert_array_equal(g.bounds, jg.bounds)
    for x, jx in zip(g.xopt, jg.xopt):
        np.testing.assert_array_equal(x, jx)
    X = _points(g, seed=1)
    _close(g.batch(torch.tensor(X, dtype=f64)), jg.batch(X), 1e-12)
    _close(g.batch_grad(torch.tensor(X, dtype=f64)), jg.batch_grad(X), 1e-9)


@pytest.mark.parametrize("ctor,kw", [
    ("constant", dict(n=1.5, lbs=[0.0, -1.0], ubs=[1.0, 2.0])),
    ("quadratic1d", dict(a=2.0, b=-1.0, c=0.5)),
    ("linearcosine1d", dict(a=1.5, b=3.0)),
])
def test_unregistered_constructors_match_jax(ctor, kw):
    f, jf = getattr(tf, ctor)(**kw), getattr(jtf, ctor)(**kw)
    np.testing.assert_array_equal(f.bounds, jf.bounds)
    X = _points(f, seed=2)
    _close(f.batch(torch.tensor(X, dtype=f64)), jf.batch(X), 1e-12)
    _close(f.batch_grad(torch.tensor(X, dtype=f64)), jf.batch_grad(X), 1e-9)


def test_tplot_draws_one_and_two_dimensions():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    assert tf.tplot(tf.get_function("gramacylee"), num_points=20) is not None
    assert tf.tplot(tf.get_function("braninhoo"), num_points=10) is not None
    with pytest.raises(ValueError, match="1- or 2-dimensional"):
        tf.tplot(tf.get_function("hartmann3d"))
