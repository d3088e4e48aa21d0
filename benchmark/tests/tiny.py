"""Tiny cells written as data only (a BENCHMARK.json and the files it
names) into a directory, for the CPU tests: the real cells' configurations
and limits at widths a CPU run holds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from benchmark import core

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_TRAFFIC = {
    "tiny-bo": dict(loop="bo_trials", horizon=1, mc_iters=4, num_restarts=1, sgd_iters=10,
                    lr=0.05, num_starts=2, solver_iterations=3, rule="EI", mle_every=1,
                    budget=2, n_init=3, trace_iteration=0, replay_samples=4, designs=2,
                    design_key=7),
}
CELLS = {"hartmann6d-f64.tiny-bo": ("hartmann6d-f64", "tiny-bo", "hartmann6d-f64.rollout-h2")}


def write_root(root: Path) -> Path:
    """A data root holding the tiny cells; returns its BENCHMARK.json."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic").mkdir(parents=True)
    (root / "benchmark" / "cells").mkdir()
    (root / "benchmark" / "configs").mkdir()
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["capacity"] = 5
        (root / c["file"]).write_text(json.dumps(cfg))
    for name, traffic in TINY_TRAFFIC.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    workloads = []
    for name, (config, traffic, real) in CELLS.items():
        shutil.copy(BENCH / "cells" / f"{real}.json", root / "benchmark" / "cells" / f"{name}.json")
        workloads.append(dict(name=name, config=config, traffic=traffic, chips=1, why="tiny"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (_, _, real) in CELLS.items() if real in m["workloads"]]
    spec["workloads"] = workloads
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def run(root: Path, cell: str, seed: int = 5, seconds: float = 0.0, trace: bool = False):
    spec = write_root(root) if not (root / "BENCHMARK.json").exists() else root / "BENCHMARK.json"
    c = core.Cell(cell, spec_path=spec, data_root=root)
    return core.run_cell(c, seed, seconds, trace, torch.device("cpu"), 0.0, log=lambda *a: None)
