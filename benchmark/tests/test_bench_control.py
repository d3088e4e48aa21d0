"""The control: the reference put in the program's place in the precision
just below the configuration's (float32 for the float64 cell), at the
tiny cell's size, judged by the cell's own limits, comes out not correct
where the program's own answers are."""

import pytest
import torch

from benchmark import control, core
from benchmark.tests import tiny

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_float64_cells_control_fails(tmp_path, seed):
    spec = tiny.write_root(tmp_path)
    cell = core.Cell("hartmann6d-f64.tiny-bo", spec_path=spec, data_root=tmp_path)
    loop = core.loop_module(cell.traffic["loop"]).Loop(cell, seed, torch.device("cpu"),
                                                       log=lambda *a: None)
    loop.setup()
    run = loop.window(1e-3, trace=False)
    loop.release()
    mine, ctrl, _ = control.readings(loop, run, True)
    limits = cell.figures["limits"]
    assert core.judge([(k, mine[k], float(v)) for k, v in limits.items()], run.attempted), mine
    assert not core.judge([(k, ctrl[k], float(v)) for k, v in limits.items()],
                          run.attempted), ctrl
