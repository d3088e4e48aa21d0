"""PyTorch port, the cost-aware CLI's gp mode against the JAX CLI's: the
learned cost model (a GP fit per trial to the true cost at a Sobol design)
end to end. Same configuration and tolerances as
tests/test_torch_cost_aware_cli.py, whose helpers run both CLIs."""

import torch

from test_torch_cost_aware_cli import assert_same_outputs, run_both_clis

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers.
torch.set_num_threads(1)


def test_cost_aware_cli_gp_matches_jax_cli(tmp_path, monkeypatch):
    out, jout, points = run_both_clis(tmp_path, monkeypatch, "gp")
    assert_same_outputs(out, jout, points, "gp")
