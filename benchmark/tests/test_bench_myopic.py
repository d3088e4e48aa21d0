"""The myopic cell on the CPU: a tiny data-only version of
`hartmann6d-f64-myopic.ei-b100` (capacity 5) correct traced and untraced,
its float32 control not correct, the lone-lane work at the cell's shape
equal to the program's count, and the readers of the chunk records
(`benchmark/chunks.py`, `myopic.refit_ms`, `myopic.solve_ms`) and of the
lone-lane roofline on synthetic records and traces."""

import json
import shutil
from collections import deque

import pytest
import torch

from benchmark import common, control, core, trace
from benchmark import chunks
from benchmark.tests import tiny
from benchmark.yardstick import lane_work
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.utils import profiling

torch.set_num_threads(1)
REAL = "hartmann6d-f64-myopic.ei-b100"
CELL = "hartmann6d-f64-myopic.tiny-ei"
TRAFFIC = dict(loop="myopic_trials", rule="EI", theta=0.0, num_starts=2, solver_iterations=3,
               mle_every=1, budget=2, n_init=3, steps_per_call=0, trace_iteration=0,
               replay_samples=2, designs=2, design_key=7)
READERS = ("myopic.refit_ms", "myopic.solve_ms")
MS = 1e6        # ns


def write_root(root):
    """tiny.write_root's data root with the tiny myopic cell added."""
    spec_path = tiny.write_root(root)
    spec = json.loads(spec_path.read_text())
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "tiny-ei.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(tiny.BENCH / "cells" / f"{REAL}.json",
                root / "benchmark" / "cells" / f"{CELL}.json")
    spec["workloads"].append(dict(name=CELL, config="hartmann6d-f64-myopic", traffic="tiny-ei",
                                  chips=1, why="tiny"))
    listed = {m["name"]: m.get("workloads") for m in real["end_to_end"] + real["per_layer"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if listed[m["name"]] is not None and REAL in listed[m["name"]]:
            m["workloads"].append(CELL)
    spec_path.write_text(json.dumps(spec))
    return spec_path


def _cell(root):
    return core.Cell(CELL, spec_path=write_root(root), data_root=root)


def test_the_tiny_myopic_cell_runs_correct_traced_and_untraced(tmp_path):
    cell = _cell(tmp_path)
    out = core.run_cell(cell, 5, 1e-3, False, torch.device("cpu"), 0.0, log=lambda *a: None)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == TRAFFIC["budget"] and out["failed"] == 0
    assert {"bo_iter_s", "setup_s"} <= set(out["metrics"])
    assert set(out["checks"]) == set(cell.figures["limits"])
    traced = core.run_cell(cell, 2 ** 31 + 7, 1e-3, True, torch.device("cpu"), 0.0,
                           log=lambda *a: None)
    assert traced["correct"] is True, traced["checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"]) and "breakdown" in traced
    # on the CPU no reader finds device time
    assert not {"myopic.refit_ms", "myopic.solve_ms",
                "lane_kernel.f64_lone_roofline"} & set(traced["metrics"])


@pytest.mark.parametrize("seed", [3, 4])
def test_the_myopic_cells_control_fails(tmp_path, seed):
    cell = _cell(tmp_path)
    loop = core.loop_module(cell.traffic["loop"]).Loop(cell, seed, torch.device("cpu"),
                                                       log=lambda *a: None)
    loop.setup()
    run = loop.window(1e-3, trace=False)
    loop.release()
    mine, ctrl, shortfalls = control.readings(loop, run, True)
    limits = cell.figures["limits"]
    assert len(shortfalls) == TRAFFIC["replay_samples"]
    assert core.judge([(k, mine[k], float(v)) for k, v in limits.items()], run.attempted), mine
    assert not core.judge([(k, ctrl[k], float(v)) for k, v in limits.items()],
                          run.attempted), ctrl


@pytest.mark.parametrize("n", [5, 55, 104])
def test_the_lone_lane_work_is_the_programs(n):
    cell = core.Cell(REAL, spec_path=tiny.REPO / "BENCHMARK.json", data_root=tiny.REPO)
    cap, d, S = cell.config["capacity"], cell.config["d"], cell.traffic["num_starts"] + 2
    its = cell.traffic["solver_iterations"]
    assert lane_work.solve_work([n], cap, d, S, its, 8) == nl.lane_solve_work([n], cap, d, S,
                                                                             its, 8)


def _chunk(serial, b, k, *, traced=False, cuda=True):
    """A chunk of k iterations: each a solve replay of 2 ms and an observe
    replay of 30 ms (refit) or 1 ms (no refit: odd iterations)."""
    spans = [profiling.Span("bo.chunk", 0, 100 * MS)]
    replays, refits = [], []
    for i in range(k):
        refit = (b + i) % 2 == 0
        for name, s in (("bo.acquire", 2e-3), ("bo.observe", 30e-3 if refit else 1e-3)):
            spans.append(profiling.Span(name, 1, 2, parent=0))
            replays.append(profiling.Replay(len(spans) - 1, s, None))
        refits.append(refit)
    return profiling.IterationRecord(serial, b, "myopic", k, spans=spans, replays=replays,
                                     refit=any(refits), refits=refits, traced=traced, cuda=cuda)


def _run(*iterations):
    return common.Run(cell=None, trials=[common.Trial(1.0, 1.0, n) for n in iterations])


@pytest.fixture
def kept(monkeypatch):
    """The program's RECORDS, emptied for the test."""
    monkeypatch.setattr(profiling, "RECORDS", deque(maxlen=1024))
    return profiling.RECORDS


def _read(run):
    return {name: core.metric_reader(name).read(run) for name in READERS}


def test_the_readers_split_the_untraced_chunks(kept):
    kept.append(_chunk(0, 0, 1))                                  # set-up's warm-up
    kept.append(_chunk(1, 0, 4, traced=True))
    kept.extend([_chunk(2, 0, 3), _chunk(2, 3, 1)])
    assert [(r.serial, r.b) for r in chunks.window(_run(4, 4))] == [(2, 0), (2, 3)]
    assert len(chunks.steps(_run(4, 4))) == 4
    # refits at b 0 and 2 (30 ms each); four solves of 2 ms
    assert _read(_run(4, 4)) == {"myopic.refit_ms": pytest.approx(30.0),
                                 "myopic.solve_ms": pytest.approx(2.0)}


@pytest.mark.parametrize("case", ["fewer", "order", "serial", "loop", "cpu", "no_split",
                                  "none"])
def test_the_readers_read_nothing_from_records_that_do_not_match(kept, monkeypatch, case):
    kept.extend([_chunk(1, 0, 2), _chunk(1, 2, 2)])
    kept.append(_chunk(2 if case != "serial" else 0, 0, 4, cuda=case != "cpu"))
    if case == "fewer":
        kept.popleft()
    if case == "order":
        kept[0], kept[1] = kept[1], kept[0]
    if case == "loop":
        kept[0].loop = "nonmyopic"
    if case == "no_split":
        kept[2].refits = []
    if case == "none":
        monkeypatch.delattr(profiling, "RECORDS")     # a program that keeps none
    assert _read(_run(4, 4)) == dict.fromkeys(READERS)
    if case in ("cpu", "no_split"):
        assert len(chunks.window(_run(4, 4))) == 3
    else:
        assert chunks.window(_run(4, 4)) is None


def test_the_lone_roofline_counts_the_frozen_work():
    cell = core.Cell(REAL, spec_path=tiny.REPO / "BENCHMARK.json", data_root=tiny.REPO)
    kernels = [("void newton_li_kernel_d8<0>(double const*)", 0.0, 0.002),
               ("li_best_start_kernel", 0.002, 0.0021), ("elementwise", 0.01, 0.04),
               ("void newton_li_kernel_d8<0>(double const*)", 0.05, 0.052)]
    tr = trace.Trace(kernels, [], (0.0, 0.06))
    run = common.Run(cell=cell, trace=tr)
    run.acquisitions = [common.Acquisition(0.05, 0, 5 + b, 1, traced=b in (50, 51))
                        for b in range(100)]
    got = core.metric_reader("lane_kernel.f64_lone_roofline").read(run)
    peaks = json.loads((tiny.BENCH / "yardstick" / "peaks.json").read_text())
    bound = sum(max(f / peaks["flops_per_s"]["float64"], b / peaks["bytes_per_s"])
                for f, b in (lane_work.solve_work([n], 105, 6, 66,
                                                  cell.figures["iterations_per_start"], 8)
                             for n in (55, 56)))
    assert got == pytest.approx(100.0 * bound / 0.0041) and 0 < got < 100
    run.trace = trace.Trace(kernels[2:3], [], (0.0, 0.06))
    assert core.metric_reader("lane_kernel.f64_lone_roofline").read(run) is None
    rollout = core.Cell("hartmann6d-f64.rollout-h2", spec_path=tiny.REPO / "BENCHMARK.json",
                        data_root=tiny.REPO)
    run = common.Run(cell=rollout, trace=tr, acquisitions=run.acquisitions)
    assert core.metric_reader("lane_kernel.f64_lone_roofline").read(run) is None
