"""A run with the timed path broken underneath comes out not correct: the
harness's whole run on the CPU (its look for a card skipped) at the tiny
BO cell, once for each fault the cell can have (`benchmark/faults.py`).
The cell does not span chips, so no exchange between chips can be left
out."""

import pytest
import torch

from benchmark import faults
from benchmark.tests import tiny

torch.set_num_threads(1)
BO = "hartmann6d-f64.tiny-bo"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = tiny.run(tmp_path, BO, seconds=1e-3)
    assert out["correct"] is False, out["checks"]
