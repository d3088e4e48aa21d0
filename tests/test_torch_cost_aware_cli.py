"""PyTorch port, the cost-aware experiment CLI against the JAX package's.

Both CLIs run a tiny float64 trial on hartmann3d (budget 2, h 1, 4 QMC
samples, 2 + 2 restarts, 2 SGA iterations; the port with `--device cpu`),
one mode per test: the same files, headers and sentinel rows, the JAX
CLI's sampled points within 1e-5 of the box width (each the end of an Adam
ascent on IFT gradients, as in tests/test_torch_bo.py) and its costs CSV
at rtol 1e-8. The nonuniform mode is here, the gp mode in
tests/test_torch_cost_aware_gp_cli.py: the JAX side compiles a rollout
program per mode, ~30-40 s each, and one file per mode keeps each file
under a minute.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.experiments import cost_aware as jca
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu_torch.experiments import cost_aware as ca
from rollout_bo_tpu_torch.models import cost_functions as cf
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import logging as log

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers.
torch.set_num_threads(1)

f64 = torch.float64


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def run_both_clis(tmp_path, monkeypatch, mode):
    """Both CLIs on the same arguments; returns the output roots and the
    points each trial sampled (recorded around both packages' loops)."""
    points = {"port": [], "jax": []}
    for pkg, mod in (("port", bo), ("jax", jbo)):
        loop = mod.run_nonmyopic_bo

        def recorded(*a, loop=loop, pkg=pkg, **kw):
            res = loop(*a, **kw)
            points[pkg].append(res.X)
            return res

        monkeypatch.setattr(mod, "run_nonmyopic_bo", recorded)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--function-name", "hartmann3d", "--trials", "1", "--budget", "2",
            "--horizon", "1", "--mc-samples", "4", "--starts", "4", "--batch-size", "2",
            "--sgd-iterations", "2", "--cost-design", "6", "--modes", mode,
            "--dtype", "float64", "--variance-reduction"]
    ca.main(args + ["--output-dir", out, "--device", "cpu"])
    jca.main(args + ["--output-dir", jout])
    return out, jout, points


def assert_same_outputs(out, jout, points, mode):
    assert _files(out) == _files(jout) == sorted(
        [os.path.join("hartmann3d", f"{mode}_costs.csv"), os.path.join("hartmann3d",
                                                                       "metadata.txt")]
        + [os.path.join("hartmann3d", f"{mode}_rollout_h1_{m}.csv")
           for m in ("gaps", "observations", "times")])
    for rel in _files(out):
        with open(os.path.join(out, rel)) as fh, open(os.path.join(jout, rel)) as jfh:
            mine, theirs = fh.read().splitlines(), jfh.read().splitlines()
        if rel.endswith("metadata.txt"):
            assert mine == theirs
        else:
            assert mine[:2] == theirs[:2] and len(mine) == len(theirs) == 3
    f = tf.get_function("hartmann3d")
    width = float(np.max(f.ubs - f.lbs))
    ((mine,), (theirs,)) = points["port"], points["jax"]
    assert mine.shape == (3, 3)
    np.testing.assert_allclose(mine, theirs, rtol=0.0, atol=1e-5 * width)
    name = os.path.join("hartmann3d", f"{mode}_costs")
    costs = log.read_rows(os.path.join(out, name))
    np.testing.assert_allclose(costs, log.read_rows(os.path.join(jout, name)), rtol=1e-8)
    assert costs.shape == (1, 2) and np.all(costs >= 1.0) and np.all(costs <= 4.0)


def test_cost_aware_cli_nonuniform_matches_jax_cli(tmp_path, monkeypatch):
    out, jout, points = run_both_clis(tmp_path, monkeypatch, "nonuniform")
    assert_same_outputs(out, jout, points, "nonuniform")


def test_cost_aware_cli_flags_and_rules():
    required = ["--output-dir", "o"]
    mine, theirs = vars(ca.parse_args(required)), vars(jca.parse_args(required))
    assert mine.pop("device") == "cuda" and mine == theirs
    f, jf = tf.get_function("braninhoo"), jtf.get_function("braninhoo")
    c = ca.make_true_cost(f, "braninhoo", 3.0, 2.0)
    jc = jca.make_true_cost(jf, "braninhoo", 3.0, 2.0)
    pts = np.array([[np.pi, 2.275], [-5.0, 14.0], [1.0, 1.0]])
    np.testing.assert_allclose(c(torch.tensor(pts)).numpy(),
                               [float(jc(jnp.asarray(p))) for p in pts], rtol=1e-14)
    assert float(c(torch.tensor(pts[0]))) > 3.9 and float(c(torch.tensor(pts[1]))) < 1.1
    for mode in ("uniform", "nonuniform", "gp"):
        rule = ca.build_rule(mode, c, f, 8, 0, f64, "cpu")
        assert isinstance(rule, cf.CostAwareRule) and rule.name == "EI" and rule.cost
    assert ca.build_rule("uniform", c, f, 8, 0, f64, "cpu").cost.uniform
    gp = ca.build_rule("gp", c, f, 8, 0, f64, "cpu").cost
    jgp = jca.build_rule("gp", jc, jf, 8, 0, jnp.float64).cost
    np.testing.assert_allclose(gp(torch.tensor(pts)).numpy(),
                               [float(jgp(jnp.asarray(p))) for p in pts], rtol=1e-10)
    assert gp.state.X.device.type == "cpu" and gp.state.capacity == 8


def test_cost_aware_cli_defaults_to_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ca.main(["--output-dir", str(tmp_path), "--budget", "1", "--trials", "1"])
    assert _files(str(tmp_path)) == []
