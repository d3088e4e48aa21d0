"""PyTorch port, the adaptive-horizon loop and its CLI against the JAX package.

Both packages run the same trial (sixhump, the alternating schedule 0 / 1,
4 QMC samples, 2 + 2 restarts, budget 3; the port with device="cpu") in
float64: sampled X within 1e-5 of the box width (each point is the end of
an Adam ascent on IFT gradients, as in tests/test_torch_bo.py), gaps rtol
1e-6, allocations 0 on both CPU routes. The CLI writes the JAX CLI's files
with the same headers, and its numbers agree at rtol 1e-5 (times are only
held to be positive). The stochastic trial and the CLI use the same
configuration, so the JAX package compiles their rollout programs once.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.experiments import adaptive as jadaptive
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu.utils import logging as jlog
from rollout_bo_tpu_torch.experiments import adaptive
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.ops import newton_lanes
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import logging as log

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers.
torch.set_num_threads(1)

# the CLI's flags for the same trial as _KW (seed 7 is the CLI's seed + trial 0)
_KW = dict(horizon=1, mc_iters=4, budget=3, num_starts=4, num_restarts=2, sgd_iters=2,
           seed=7)
_CLI = ["--function-name", "sixhump", "--trials", "1", "--budget", "3", "--starts", "4",
        "--mc-samples", "4", "--horizon", "1", "--batch-size", "2", "--sgd-iterations", "2",
        "--variance-reduction", "--seed", "7"]


def _width(f):
    return float(np.max(f.ubs - f.lbs))


def test_horizon_schedules_match_jax():
    for name, h, budget, want in (("alternating_horizon", 2, 6, [0, 2, 0, 2, 0, 2]),
                                  ("alternating_horizon", 1, 5, [0, 1, 0, 1, 0]),
                                  ("truncated_horizon", 3, 5, [3, 3, 2, 1, 0]),
                                  ("fixed_horizon", 2, 4, [2, 2, 2, 2])):
        mine, theirs = getattr(bo, name)(h), getattr(jbo, name)(h)
        assert [mine(b, budget) for b in range(budget)] == want
        assert [theirs(b, budget) for b in range(budget)] == want
    assert bo.alternating_horizon()(1, 2) == 1              # max_horizon defaults to 1


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "ghq"])
def test_run_adaptive_bo_matches_jax(deterministic):
    f, jf = tf.get_function("sixhump"), jtf.get_function("sixhump")
    kw = dict(_KW, deterministic=deterministic, ghq_nodes=3)
    if deterministic:
        kw["solver_iterations"] = 4
    jres = jbo.run_adaptive_bo(jf, dtype=jnp.float64, **kw)
    res = bo.run_adaptive_bo(f, device="cpu", **kw)
    np.testing.assert_allclose(res.X, np.asarray(jres.X), rtol=0.0, atol=1e-5 * _width(f))
    np.testing.assert_allclose(res.gaps, jres.gaps, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res.y, jres.y, rtol=1e-6, atol=1e-9)
    assert np.all(res.allocations == 0.0) and np.all(jres.allocations == 0.0)
    assert res.allocations.shape == res.times.shape == (3,) and np.all(res.times > 0.0)
    assert res.X.shape == (4, 2) and res.state.capacity == 4       # n_init 1 + budget 3
    assert np.all(np.diff(res.minimum_observations) <= 0.0)
    assert res.fallbacks.shape == (3,) and res.sga_iterations.shape == (3,)


def test_adaptive_launch_identity_and_horizon_zero(monkeypatch):
    """The lane solver runs h x (SGA iterations + 1) times per iteration plus
    once per fallback, and never in an h = 0 iteration but for its
    fallback: the identity chip_smoke.py phase 8 checks on the card."""
    calls = []
    solve = newton_lanes.newton_solve_lanes

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return solve(*a, **kw)

    monkeypatch.setattr(newton_lanes, "newton_solve_lanes", counted)
    f = tf.get_function("hartmann3d")
    per_iter, before = [], [0]

    def schedule(b, budget):
        per_iter.append(len(calls) - before[0])
        before[0] = len(calls)
        return [0, 2, 0, 1][b]

    x_init = np.random.default_rng(3).uniform(f.lbs, f.ubs, (3, 3))
    res = bo.run_adaptive_bo(f, schedule=schedule, mc_iters=4, budget=4, num_starts=4,
                             num_restarts=2, sgd_iters=3, lr=0.05, x_init=x_init,
                             device="cpu")
    per_iter = per_iter[1:] + [len(calls) - before[0]]
    hs = np.array([0, 2, 0, 1])
    want = hs * (res.sga_iterations + 1) + res.fallbacks
    assert per_iter == want.tolist()
    # rollout solves over (2 + 2) restarts x 4 trajectories; the fallback's over 1 lane
    assert sorted(set(calls)) in ([16], [1, 16]) and calls.count(1) == res.fallbacks.sum()
    assert res.state.capacity == 3 + 4                     # len(x_init) + budget
    np.testing.assert_array_equal(res.X[:3], x_init)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_adaptive_cli_matches_jax_cli(tmp_path):
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    adaptive.main(_CLI + ["--output-dir", out, "--device", "cpu"])
    jadaptive.main(_CLI + ["--output-dir", jout])
    metrics = ("allocations", "gaps", "observations", "times")
    assert _files(out) == _files(jout) == sorted(
        [os.path.join("sixhump", "metadata.txt")]
        + [os.path.join("sixhump", f"rollout_h1_{m}.csv") for m in metrics])
    for rel in _files(out):
        with open(os.path.join(out, rel)) as fh, open(os.path.join(jout, rel)) as jfh:
            mine, theirs = fh.read().splitlines(), jfh.read().splitlines()
        if rel.endswith("metadata.txt"):
            strip = lambda ls: [l for l in ls if not l.startswith("Data Directory")]
            assert strip(mine) == strip(theirs)
            continue
        assert mine[:2] == theirs[:2] and len(mine) == len(theirs) == 3
        rows = log.read_rows(os.path.join(out, rel[:-4]))
        jrows = jlog.read_rows(os.path.join(jout, rel[:-4]))
        assert rows.shape == jrows.shape == (1, 3)
        if rel.endswith("_times.csv"):
            assert np.all(rows > 0.0)
        else:
            np.testing.assert_allclose(rows, jrows, rtol=1e-5, atol=1e-9, err_msg=rel)
    assert not os.path.exists(os.path.join(out, "sixhump", "sixhump_failed.txt"))


def test_adaptive_cli_captures_a_failed_trial(tmp_path, monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("synthetic failure")

    monkeypatch.setattr(bo, "run_adaptive_bo", boom)
    adaptive.main(["--function-name", "sixhump", "--output-dir", str(tmp_path),
                   "--trials", "2", "--budget", "2", "--device", "cpu"])
    failed = tmp_path / "sixhump" / "sixhump_failed.txt"
    assert "(sixhump) Trial 2 failed with error: synthetic failure" in failed.read_text()
    assert capsys.readouterr().out.count("FAILED: synthetic failure") == 2
    # the CSVs hold their header and sentinel and no trial row
    assert log.read_rows(str(tmp_path / "sixhump" / "rollout_h1_gaps")).shape[0] == 0


def test_adaptive_cli_flags_and_device():
    required = ["--function-name", "f", "--output-dir", "o"]
    mine, theirs = vars(adaptive.parse_args(required)), vars(jadaptive.parse_args(required))
    assert mine.pop("device") == "cuda" and mine == theirs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            adaptive.main(required)
