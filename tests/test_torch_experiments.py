"""PyTorch port, the experiment CLIs against the JAX package's.

Both CLIs run tiny trials on the same arguments (the port with
`--device cpu`): the files written, each CSV's header, sentinel and row
count, and `metadata.txt` must be the same; the numbers in the rows agree
to the BO loops' tolerances (tests/test_torch_bo.py), here rtol 1e-5. The
`times` rows are wall clocks and are only held to be positive.
"""

import os

import numpy as np
import pytest
import torch

from rollout_bo_tpu.experiments import myopic as jmyopic
from rollout_bo_tpu.experiments import nonmyopic as jnonmyopic
from rollout_bo_tpu.utils import logging as jlog
from rollout_bo_tpu.utils import metrics as jmetrics
from rollout_bo_tpu_torch.experiments import myopic, nonmyopic
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import logging as log
from rollout_bo_tpu_torch.utils import metrics

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def _assert_same_outputs(out, jout, budget, trials, timed=("times",)):
    assert _files(out) == _files(jout)
    for rel in _files(out):
        mine, theirs = _lines(os.path.join(out, rel)), _lines(os.path.join(jout, rel))
        if rel.endswith("metadata.txt"):
            strip = lambda ls: [l for l in ls if not l.startswith("Data Directory")]
            assert strip(mine) == strip(theirs)
            assert [l.split(":")[0] for l in mine] == [l.split(":")[0] for l in theirs]
            continue
        assert mine[:2] == theirs[:2]                       # header and sentinel
        assert mine[0] == ",".join(["trial"] + [str(i) for i in range(1, budget + 1)])
        assert len(mine) == len(theirs) == 2 + trials
        rows = log.read_rows(os.path.join(out, rel[:-4]))
        jrows = jlog.read_rows(os.path.join(jout, rel[:-4]))
        assert rows.shape == jrows.shape == (trials, budget)
        if any(rel.endswith(f"_{m}.csv") for m in timed):
            assert np.all(rows > 0.0)
        elif "random_" not in rel:      # the Random rule's stream is torch's own
            np.testing.assert_allclose(rows, jrows, rtol=1e-5, atol=1e-7, err_msg=rel)


def test_myopic_cli_tiny_matches_jax_cli(tmp_path, capsys):
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--function-name", "hartmann3d", "--budget", "3", "--trials", "2",
            "--starts", "4", "--acquisitions", "ei", "lcb", "random", "--seed", "7"]
    myopic.main(args + ["--output-dir", out, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[hartmann3d] acquisition=EI" in printed and "trial 2/2: final gap" in printed
    jmyopic.main(args + ["--output-dir", jout])
    _assert_same_outputs(out, jout, budget=3, trials=2)
    assert len(_files(out)) == 3 * len(myopic.METRICS) + 1
    assert myopic.METRICS == jmyopic.METRICS and sorted(myopic.ACQS) == sorted(jmyopic.ACQS)
    for name, (rule_fn, theta) in myopic.ACQS.items():
        jrule_fn, jtheta = jmyopic.ACQS[name]
        rule, jrule = rule_fn(), jrule_fn()
        assert theta == jtheta and (rule.name, rule.sigma_tol, rule.solve_f_tol,
                                    rule.solve_x_tol) == (
            jrule.name, jrule.sigma_tol, jrule.solve_f_tol, jrule.solve_x_tol)
    assert np.all(log.read_rows(os.path.join(out, "hartmann3d", "ei_allocations")) == 0.0)


def test_nonmyopic_cli_tiny_matches_jax_cli(tmp_path):
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--function-name", "hartmann3d", "--budget", "2", "--trials", "1",
            "--starts", "4", "--mc-samples", "4", "--horizon", "1", "--batch-size", "2",
            "--sgd-iterations", "2", "--variance-reduction", "--optimize", "--seed", "9"]
    nonmyopic.main(args + ["--output-dir", out, "--device", "cpu"])
    jnonmyopic.main(args + ["--output-dir", jout, "--nworkers", "1"])
    _assert_same_outputs(out, jout, budget=2, trials=1)
    assert _files(out) == ["hartmann3d/rollout_h1_gaps.csv",
                           "hartmann3d/rollout_h1_observations.csv",
                           "hartmann3d/rollout_h1_times.csv", "metadata.txt"]


def test_nonmyopic_cli_deterministic_solve_and_float32(tmp_path):
    out = str(tmp_path / "det")
    nonmyopic.main(["--function-name", "gramacylee", "--budget", "2", "--trials", "1",
                    "--starts", "4", "--horizon", "1", "--batch-size", "2",
                    "--sgd-iterations", "2", "--deterministic-solve", "--ghq-nodes", "3",
                    "--dtype", "float32", "--steps-per-call", "3", "--solve-f-tol", "1e-3",
                    "--output-dir", out, "--device", "cpu"])
    rows = log.read_rows(os.path.join(out, "gramacylee", "rollout_h1_observations"))
    assert rows.shape == (1, 2) and np.all(np.isfinite(rows))


def test_flags_defaults_match_the_jax_clis():
    """Same flags and defaults; the port adds --device, and the non-myopic
    CLI the ranks' --backend and --init-method."""
    for mod, jmod, required in (
            (myopic, jmyopic, ["--function-name", "f"]),
            (nonmyopic, jnonmyopic, ["--function-name", "f", "--output-dir", "o"])):
        mine, theirs = vars(mod.parse_args(required)), vars(jmod.parse_args(required))
        assert mine.pop("device") == "cuda"
        if mod is nonmyopic:
            assert (mine.pop("backend"), mine.pop("init_method")) == ("nccl", None)
        assert mine == theirs


@pytest.mark.parametrize("flag,value,item", [("--outer-solver", "scanned", "16"),
                                             ("--outer-solver", "batch", "16")])
def test_nonmyopic_cli_rejects_what_is_not_ported(tmp_path, monkeypatch, flag, value, item):
    """The batch and scanned outer solvers are ported: the CLI hands them,
    with --steps-per-call, to `run_nonmyopic_bo` (whose results
    tests/test_torch_outer_solvers.py holds to the JAX package's); a value
    outside the JAX CLI's choices is still refused before anything is
    written."""
    seen = {}

    class Reached(Exception):
        pass

    def record(*args, **kw):
        seen.update(kw)
        raise Reached

    monkeypatch.setattr(bo, "run_nonmyopic_bo", record)
    argv = ["--function-name", "gramacylee", "--output-dir", str(tmp_path), "--device",
            "cpu", "--trials", "1", "--steps-per-call", item]
    with pytest.raises(Reached):
        nonmyopic.main(argv + [flag, value])
    assert (seen["outer_solver"], seen["steps_per_call"]) == (value, int(item))
    with pytest.raises(SystemExit):
        nonmyopic.main(["--function-name", "gramacylee", "--output-dir",
                        str(tmp_path / "refused"), "--device", "cpu", flag, "stepped"])
    assert not (tmp_path / "refused").exists()


@pytest.mark.parametrize("mod", [myopic, nonmyopic], ids=["myopic", "nonmyopic"])
def test_cli_defaults_to_the_card_and_raises_without_one(tmp_path, mod):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--function-name", "gramacylee", "--output-dir", str(tmp_path),
                  "--budget", "1", "--trials", "1"])
    assert _files(str(tmp_path)) == []


def test_myopic_cli_resumes_by_counting_csv_rows(tmp_path, capsys):
    """With --checkpoint-every, a rerun skips the trials that already hold a
    CSV row and appends only the missing ones."""
    out = str(tmp_path / "resume")
    base = ["--function-name", "hartmann3d", "--budget", "2", "--starts", "4",
            "--acquisitions", "ei", "--checkpoint-every", "1", "--output-dir", out,
            "--device", "cpu"]
    myopic.main(base + ["--trials", "1"])
    first = log.read_rows(os.path.join(out, "hartmann3d", "ei_gaps"))
    capsys.readouterr()
    myopic.main(base + ["--trials", "2"])
    assert "resuming: 1 completed trial(s) on disk" in capsys.readouterr().out
    rows = log.read_rows(os.path.join(out, "hartmann3d", "ei_gaps"))
    assert rows.shape == (2, 2)
    np.testing.assert_array_equal(rows[0], first[0])
    assert not any(f.endswith(".npz") for f in _files(out))     # snapshots dropped


def test_nonmyopic_cli_resume_keeps_the_initial_sample_stream(tmp_path):
    """A resumed sweep draws the skipped trials' x_init anyway, so trial 2
    gets the same initial design as in an unbroken sweep."""
    base = ["--function-name", "hartmann3d", "--budget", "1", "--starts", "4",
            "--mc-samples", "2", "--horizon", "0", "--batch-size", "2",
            "--sgd-iterations", "1", "--variance-reduction", "--checkpoint-every", "1",
            "--device", "cpu"]
    whole, resumed = str(tmp_path / "whole"), str(tmp_path / "resumed")
    nonmyopic.main(base + ["--trials", "2", "--output-dir", whole])
    nonmyopic.main(base + ["--trials", "1", "--output-dir", resumed])
    nonmyopic.main(base + ["--trials", "2", "--output-dir", resumed])
    name = os.path.join("hartmann3d", "rollout_h0_observations")
    a, b = log.read_rows(os.path.join(whole, name)), log.read_rows(os.path.join(resumed, name))
    assert a.shape == b.shape == (2, 1)
    np.testing.assert_allclose(a, b, rtol=1e-10)


def test_logging_and_metrics_are_the_same_copies(tmp_path):
    p, jp = str(tmp_path / "a"), str(tmp_path / "b")
    for mod, path in ((log, p), (jlog, jp)):
        mod.create_csv(path, 4)
        mod.write_to_csv(path, [0.1, 0.2, 0.3, 0.4])
        mod.create_csv(path, 4)                            # keeps the existing rows
        mod.write_metadata(path + "_meta", budget=4, should_optimize=True)
    assert _lines(p + ".csv") == _lines(jp + ".csv")
    assert _lines(p + "_meta/metadata.txt") == _lines(jp + "_meta/metadata.txt")
    obs = [3.0, 2.0, 2.5, 1.0]
    np.testing.assert_array_equal(metrics.update_gaps(obs, 0.0), jmetrics.update_gaps(obs, 0.0))
    assert metrics.gap(1.0, 1.0, 1.0) == jmetrics.gap(1.0, 1.0, 1.0) == 1.0
    assert metrics.simple_regret(0.5, 2.0) == jmetrics.simple_regret(0.5, 2.0) == 1.5
