"""The harness on the CPU: everything found by its name, a cell added as
data only, the traffic's designs, the metric arithmetic, the reference
against the port at a tiny size, and the command's refusal without a
card."""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import common, core, trace
from benchmark.reference import rollout as RR
from benchmark.tests import tiny

torch.set_num_threads(1)
REPO = tiny.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_piece_of_a_cell_is_found_by_its_name(workload):
    cell = core.Cell(workload, spec_path=REPO / "BENCHMARK.json", data_root=REPO)
    assert core.loop_module(cell.traffic["loop"]).Loop
    assert cell.figures["iterations_per_start"] > 0 and cell.figures["limits"]
    for kind in ("end_to_end", "per_layer"):
        for m in cell.metrics(kind):
            assert callable(core.metric_reader(m["name"]).read)
    assert trace.load_patterns("lane_kernel")


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_a_cell_added_as_data_only_runs(tmp_path, workload):
    out = tiny.run(tmp_path, workload, seconds=1e-3)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"
    traced = tiny.run(tmp_path, workload, seed=6, seconds=1e-3, trace=True)
    assert traced["correct"] is True
    assert {"busy_s", "window_s"} <= set(traced["device"]) and "breakdown" in traced


def _run(window_s, seconds, iterations=(1,), trials=()):
    run = common.Run(cell=None, window_s=window_s, trials=list(trials))
    run.acquisitions = [common.Acquisition(s, it, 12, 1600)
                        for s, it in zip(seconds, iterations * len(seconds))]
    return run


def test_rates_are_all_the_work_over_all_the_window():
    trials = [common.Trial(5.0, 4.0, 15), common.Trial(6.0, 5.5, 15)]
    run = _run(11.5, [0.1] * 30, trials=trials)
    assert core.metric_reader("bo_iter_s").read(run) == pytest.approx(11.5 / 30)
    assert core.metric_reader("bo.outside_acq_ms").read(run) == pytest.approx(1e3 * 1.5 / 30)
    assert core.metric_reader("bo.outside_acq_ms").read(_run(1.0, [])) is None


def test_the_cards_warm_up_is_read_apart_from_set_up():
    run = common.Run(cell=None, setup_s=20.0, warm_s=4.5)
    assert core.metric_reader("setup_s").read(run) == 20.0
    assert core.metric_reader("device.warm_s").read(run) == 4.5
    assert core.metric_reader("device.warm_s").read(common.Run(cell=None)) is None


def test_every_seed_gives_the_same_designs_in_another_order():
    cell = core.Cell("hartmann6d-f64.rollout-h2", spec_path=REPO / "BENCHMARK.json",
                     data_root=REPO)
    loop = core.loop_module("bo_trials")
    pool = cell.traffic["designs"]
    orders = {seed: [loop.Loop(cell, seed, torch.device("cpu")).design(k) for k in range(pool)]
              for seed in (1, 2 ** 31 + 5, 4600000001)}
    assert all(sorted(o) == list(range(pool)) for o in orders.values())
    assert len({tuple(o) for o in orders.values()}) > 1
    a = loop.Loop(cell, 1, torch.device("cpu")).x_init((loop.DESIGN, 0), 5)
    b = loop.Loop(cell, 2, torch.device("cpu")).x_init((loop.DESIGN, 0), 5)
    np.testing.assert_array_equal(a, b)


def test_the_idle_share_is_one_less_the_union_of_the_kernels():
    kernels = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0), ("d", 9.5, 11.0)]
    spans = [("bench.window", 0.0, 10.0), ("bench.acquisition", 0.0, 5.0)]
    tr = trace.Trace(kernels, spans, (0.0, 10.0), outside="observe")
    assert tr.busy_s == pytest.approx(3.0)
    run = common.Run(cell=None, trace=tr)
    assert core.metric_reader("device.idle_share.bo").read(run) == pytest.approx(70.0)
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["observe", pytest.approx(5.5)]
    assert gaps[1] == ["acquisition", pytest.approx(1.5)] and len(gaps) == 2
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_the_lane_kernel_roofline_counts_the_frozen_work():
    cell = core.Cell("hartmann6d-f64.rollout-h2", spec_path=REPO / "BENCHMARK.json",
                     data_root=REPO)
    kernels = [("void newton_li_kernel_d8<0>(double const*)", 0.05, 0.85),
               ("li_best_start_kernel", 0.86, 0.87), ("elementwise", 0.9, 0.95)]
    tr = trace.Trace(kernels, [("bench.acquisition", 0.0, 1.0)], (0.0, 1.0))
    run = common.Run(cell=cell, trace=tr)
    run.acquisitions = [common.Acquisition(1.1, 50, 12, 2000, traced=True)]
    share = core.metric_reader("lane_kernel.f64_roofline").read(run)
    from benchmark.lane_roofline import share as lane_share
    assert share == lane_share(run, "float64") and 0 < share < 100
    assert lane_share(run, "float32") is None
    run.trace = trace.Trace(kernels[2:], [("bench.acquisition", 0.0, 1.0)], (0.0, 1.0))
    assert core.metric_reader("lane_kernel.f64_roofline").read(run) is None


@pytest.mark.parametrize("dtype", [torch.float64])
def test_the_reference_agrees_with_the_port(dtype):
    from rollout_bo_tpu_torch.models import surrogate as sg
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.ops import kernels as K
    from rollout_bo_tpu_torch.rollout import mc, outer
    from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

    from benchmark.reference import testfns
    from benchmark.yardstick import qmc

    f, d, lbs, ubs = testfns.get("hartmann6d")
    X = qmc.uniform(np.random.default_rng(3), 8, lbs, ubs)
    y = f(torch.tensor(X)).numpy()
    st = sg.fit(K.matern52((0.7,), device="cpu", dtype=dtype), X, y, capacity=12, noise=1e-6,
                device="cpu", dtype=dtype)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    xst, z = t(qmc.starts(4, lbs, ubs, 1e-6)), t(qmc.normals(6, d, 3))
    rs = t(qmc.starts(3, lbs, ubs, 1e-2)[:3])
    tp = TrajectoryParams(rs, torch.zeros(1, dtype=dtype), t(lbs), t(ubs), z)
    eto = mc.simulate_trajectory_mc(st, tp, EI(), xst, iterations=12)
    prob = RR.Problem(t(X), t(y), 0.7, 1e-6, t(lbs), t(ubs), xst, z, 12)
    est = RR.estimate(prob, rs, with_gradients=True)
    assert common.rel_gap(eto.mu.numpy(), est.mu.numpy()) < 1e-8
    assert common.rel_gap(eto.grad_x.numpy(), est.grad.numpy()) < 1e-7
    res = outer.stochastic_solve_fused(st, tp, EI(), xst, rs, max_iters=4, lr=0.01,
                                       inner_iterations=12, select_best=True)
    sol = RR.solve(prob, rs, max_iters=4, lr=0.01)
    assert res.iterations == sol.iterations
    assert common.rel_gap(res.x.numpy(), sol.x.numpy()) < 1e-8
    assert abs(float(res.value) - float(sol.value)) < 1e-8 * abs(float(sol.value))


def test_the_command_refuses_without_a_card_and_prints_no_result(tmp_path):
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:                 # BENCHMARK.json and the benchmark alone
            (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
            subprocess.run(["cp", "-r", str(REPO / "benchmark"), str(tmp_path)], check=True)
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                              SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert not out.stdout.strip()


def test_a_run_with_no_answer_is_not_correct():
    assert not core.judge([("value_gap", 0.0, 1.0)], 0)
    assert not core.judge([("value_gap", math.nan, 1.0)], 3)
    assert core.judge([("value_gap", 0.5, 1.0), ("box_excess", 0.0, 0.0)], 3)
