"""PyTorch port: the notebook-analog examples (`rollout_bo_tpu_torch/examples/`).

Each example runs on the CPU route at tests/test_examples.py's small argv,
its own gates included (derivs_ei's 1e-5 FD gate, fantasy_conditioning's
reset at 1e-12, laplace_approximation's finite history). The explanatory
sweep is held to the JAX package's script on the same argv: x, alpha and
the adjoint-gradient column of the two CSVs to rtol 1e-6 / atol 1e-10, the
tolerance of tests/test_torch_rollout.py (the port batches the grid
points into one simulate call, the JAX script evaluates them one by one).
The JAX rollout_bo example is not run here: tests/test_examples.py does.
"""

import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

# The tensors here are tiny: one intra-op thread (see tests/test_torch_bo.py).
torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
NAMES = ["derivs_ei", "fantasy_conditioning", "laplace_approximation", "overview",
         "explanatory", "rollout_bo"]


def _port(name):
    return importlib.import_module(f"rollout_bo_tpu_torch.examples.{name}")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_derivs_ei_passes_its_fd_gate():
    out = _port("derivs_ei").main(["--n", "6", "--dim", "2", "--device", "cpu"])
    assert out["worst"] <= 1e-5 and len(out["checks"]) == 17


def test_fantasy_conditioning_reset_and_sigmas():
    out = _port("fantasy_conditioning").main(
        ["--capacity", "12", "--n-init", "4", "--horizon", "3", "--dim", "2",
         "--device", "cpu"])
    s0, s1 = out["reset_sigmas"]
    assert abs(s0 - s1) < 1e-12 and s0 == out["sigmas"][-1]
    # conditioning never raises the posterior standard deviation
    sig = [out["sigmas"][i] for i in range(-1, 3)]
    assert all(b <= a + 1e-12 for a, b in zip(sig, sig[1:]))
    assert out["condition_s"] > 0.0 and out["refit_s"] > 0.0


def test_laplace_approximation_example():
    out = _port("laplace_approximation").main(["--device", "cpu"])
    assert out["episodes"] == 10_000 and out["wall_s"] > 0.0
    assert np.isnan(out["peak_mb"])                  # not measured on the CPU


def test_overview_runs_the_myopic_loop():
    out = _port("overview").main(["--budget", "4", "--n-init", "3", "--grid", "3",
                                  "--device", "cpu"])
    assert out["mu_sigma_ei"].shape == (3, 3) and np.all(np.isfinite(out["mu_sigma_ei"]))
    assert out["X"].shape == (7, 1) and out["gaps"].shape == (4,)
    assert np.all(np.diff(out["gaps"]) >= 0.0)


def test_rollout_bo_runs_end_to_end():
    out = _port("rollout_bo").main(["--budget", "3", "--mc", "6", "--horizon", "1",
                                    "--device", "cpu"])
    assert np.all(np.isfinite(out["surface"])) and out["surface"].shape == (5, 3)
    if out["adjoint_case3_interior"]:
        assert out["adjoint_rel_err"] <= 1e-7
    assert 1 <= out["sga_iterations"] <= 15 and out["gaps_rollout"].shape == (3,)
    assert out["gaps_myopic"].shape == (3,)


def test_explanatory_matches_jax(tmp_path):
    argv = ["--grid", "5", "--mc", "16", "--horizon", "1", "--csv"]
    out = _port("explanatory").main(argv + [str(tmp_path / "port.csv"), "--device", "cpu"])
    _jax_example("explanatory").main(argv + [str(tmp_path / "jax.csv")])
    mine = np.loadtxt(tmp_path / "port.csv", delimiter=",", skiprows=1)
    theirs = np.loadtxt(tmp_path / "jax.csv", delimiter=",", skiprows=1)
    assert mine.shape == theirs.shape == (5, 4)
    np.testing.assert_array_equal(mine[:, 0], theirs[:, 0])
    np.testing.assert_allclose(mine[:, 1:3], theirs[:, 1:3], rtol=1e-6, atol=1e-10)
    np.testing.assert_array_equal(out["rows"], mine)
    assert out["fd_agree"] == int(np.sum(np.abs(mine[:, 2] - mine[:, 3])
                                         <= 5e-3 * np.abs(mine[:, 3]) + 5e-6))


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_the_card_and_raises_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main([])
