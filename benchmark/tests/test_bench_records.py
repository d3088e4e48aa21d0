"""The readers of the program's own trace records (`benchmark/records.py`
and the metrics `outer.step_gap_ms`, `device.idle_share.untraced`,
`bo.refit_ms`): the window's last N records, the traced ones dropped, None
on a mismatch or off CUDA, the arithmetic on synthetic records, and a tiny
CPU cell whose records match its trials."""

from collections import deque

import pytest
import torch

from benchmark import common, core, records
from benchmark.tests import tiny
from rollout_bo_tpu_torch.utils import profiling

torch.set_num_threads(1)
READERS = ("outer.step_gap_ms", "device.idle_share.untraced", "bo.refit_ms")
MS = 1e6        # ns


def _record(serial, b, *, traced=False, cuda=True, refit=True):
    """An iteration of 100 ms: two SGA steps, the final pass and an observe
    step, whose replays take 10, 10, 5 and 8 ms on the device, with 1, 3
    and 2 ms of device idle before the last three."""
    tree = [("bo.iteration", -1), ("bo.acquire", 0), ("outer.step", 1), ("outer.stop_read", 1),
            ("outer.step", 1), ("outer.stop_read", 1), ("outer.final", 1), ("bo.observe", 0)]
    spans = [profiling.Span(name, 0, 100 * MS if i == 0 else 1, parent=p)
             for i, (name, p) in enumerate(tree)]
    replays = [profiling.Replay(2, 10e-3, None), profiling.Replay(4, 10e-3, 1e-3),
               profiling.Replay(6, 5e-3, 3e-3), profiling.Replay(7, 8e-3, 2e-3)]
    return profiling.IterationRecord(serial, b, "nonmyopic", spans=spans, replays=replays,
                                     refit=refit, traced=traced, cuda=cuda)


def _run(*iterations):
    return common.Run(cell=None, trials=[common.Trial(1.0, 0.5, n) for n in iterations])


@pytest.fixture
def kept(monkeypatch):
    """The program's RECORDS, emptied for the test."""
    monkeypatch.setattr(profiling, "RECORDS", deque(maxlen=1024))
    return profiling.RECORDS


def _read(run):
    return {name: core.metric_reader(name).read(run) for name in READERS}


def test_the_readers_take_the_last_n_records_and_drop_the_traced(kept):
    kept.append(_record(0, 0, refit=False))                       # set-up's warm-up
    kept.extend(_record(1, b, traced=b == 1) for b in range(3))
    kept.extend(_record(2, b, refit=b != 0) for b in range(3))
    got = records.window(_run(3, 3))
    assert [(r.serial, r.b) for r in got] == [(1, 0), (1, 2), (2, 0), (2, 1), (2, 2)]
    assert _read(_run(3, 3)) == {"outer.step_gap_ms": pytest.approx(2.0),
                                 "device.idle_share.untraced": pytest.approx(67.0),
                                 "bo.refit_ms": pytest.approx(8.0)}


@pytest.mark.parametrize("case", ["fewer", "order", "serial", "split", "cpu", "none"])
def test_the_readers_read_nothing_from_records_that_do_not_match(kept, monkeypatch, case):
    trials = {"fewer": (3, 3), "split": (2, 4)}.get(case, (3, 3))
    serials = {"serial": (2, 1)}.get(case, (1, 2))
    for serial, n in zip(serials, (3, 3)):
        order = [1, 0, 2] if case == "order" and serial == 2 else range(n)
        kept.extend(_record(serial, b, cuda=case != "cpu") for b in order)
    if case == "fewer":
        kept.pop()
    if case == "none":
        monkeypatch.delattr(profiling, "RECORDS")     # a program that keeps none
    if case == "cpu":
        assert len(records.window(_run(*trials))) == 6
    else:
        assert records.window(_run(*trials)) is None
    assert _read(_run(*trials)) == dict.fromkeys(READERS)


def test_a_tiny_cpu_cell_keeps_a_record_per_iteration_and_reads_no_device_metric(tmp_path):
    out = tiny.run(tmp_path, "hartmann6d-f64.tiny-bo", seconds=1e-3)
    assert out["correct"]
    budget = tiny.TINY_TRAFFIC["tiny-bo"]["budget"]
    got = records.window(_run(budget))
    assert [(r.b, r.loop, r.cuda, r.traced) for r in got] == [
        (b, "nonmyopic", False, False) for b in range(budget)]
    assert _read(_run(budget)) == dict.fromkeys(READERS)
    traced = tiny.run(tmp_path, "hartmann6d-f64.tiny-bo", seed=6, seconds=1e-3, trace=True)
    assert traced["correct"] and not set(READERS) & set(traced["metrics"])
    assert all(r.traced for r in list(profiling.RECORDS)[-budget:])
    assert not {n for n, _ in traced["breakdown"]["device_ops"]} & {
        s.name for r in profiling.RECORDS for s in r.spans}
