"""The benchmark's frozen yardsticks equal the program's originals as they
stand: the lane kernel's work count at the cells' shapes, the QMC designs
and the test functions."""

import numpy as np
import pytest
import torch

from benchmark.reference import testfns
from benchmark.yardstick import lane_work, qmc
from rollout_bo_tpu_torch.models import testfns as program_fns
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.ops import qmc as program_qmc

# (lanes, n_base, capacity + h + 1, d, starts, Newton iterations, itemsize)
SHAPES = {
    "hartmann6d-f64.rollout-h2": (2000, (5, 12, 19), 23, 6, 18, 12, 8),
}


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_lane_work_is_the_programs(cell):
    lanes, bases, cap, d, S, its, itemsize = SHAPES[cell]
    for n_base in bases:
        for j in (1, 2, 3):
            n = [n_base + j] * lanes
            assert lane_work.solve_work(n, cap, d, S, its, itemsize) == \
                nl.lane_solve_work(n, cap, d, S, its, itemsize)
            runs = torch.full((lanes, S), 3, dtype=torch.int32)
            assert lane_work.solve_work(n, cap, d, S, 3, itemsize) == \
                nl.lane_solve_work(n, cap, d, S, its, itemsize, runs=runs)


@pytest.mark.parametrize("name", ["hartmann6d"])
def test_designs_and_functions_are_the_programs(name):
    f, d, lbs, ubs = testfns.get(name)
    prog = program_fns.get_function(name)
    np.testing.assert_array_equal(lbs, prog.lbs)
    np.testing.assert_array_equal(ubs, prog.ubs)
    np.testing.assert_array_equal(qmc.normals(200, d, 3),
                                  program_qmc.gen_low_discrepancy_sequence(200, d, 3))
    np.testing.assert_array_equal(qmc.starts(16, lbs, ubs, 1e-6),
                                  program_qmc.generate_initial_guesses(16, lbs, ubs))
    np.testing.assert_array_equal(qmc.starts(8, lbs, ubs, 1e-2),
                                  program_qmc.generate_batch(8, lbs, ubs))
    np.testing.assert_array_equal(qmc.uniform(np.random.default_rng(4), 12, lbs, ubs),
                                  program_qmc.randsample(12, d, lbs, ubs,
                                                         np.random.default_rng(4)))
    X = torch.tensor(qmc.uniform(np.random.default_rng(5), 64, lbs, ubs))
    np.testing.assert_allclose(f(X).numpy(), prog.batch(X).numpy(), rtol=1e-14, atol=1e-12)
