"""The lane kernel's share of its roofline over the traced acquisitions.

Device time: every kernel whose name matches a pattern of
`benchmark/kernels/lane_kernel/` (the solve and, where the launch has
one, its best-start pass) that started inside a traced acquisition. The
bound: each acquisition makes (SGA iterations + 1) simulate calls of h
solves; the j-th solve of a call runs on every lane at n_base + j
observations, capacity + h + 1 slots, num_starts + 2 starts, each running
the cell's fixed iterations per start. Its work comes from the frozen
`yardstick/lane_work.py`, and its least time is the larger of the
operations over the dtype's peak and the bytes over the memory's peak
(`yardstick/peaks.json`). The share is the sum of the bounds over the sum
of the device times, in percent; None where the cell runs another dtype or
the trace holds no lane kernel."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import trace
from benchmark.yardstick.lane_work import solve_work

PEAKS = Path(__file__).resolve().parent / "yardstick" / "peaks.json"


def share(run, dtype: str):
    cfg, tr, fig = run.cell.config, run.cell.traffic, run.cell.figures
    traced = run.traced
    if cfg["dtype"] != dtype or run.trace is None or not traced:
        return None
    lane = trace.load_patterns("lane_kernel")
    device_s = sum(b - a for name, a, b in run.trace.kernels_in("acquisition")
                   if trace.matches(name, lane))
    if device_s <= 0:
        return None
    peaks = json.loads(PEAKS.read_text())
    itemsize = 8 if dtype == "float64" else 4
    h = tr["horizon"]
    cap = cfg["capacity"] + h + 1
    starts = tr["num_starts"] + 2
    bound = 0.0
    for a in traced:
        for j in range(1, h + 1):
            flops, nbytes = solve_work([a.n_base + j] * a.lanes, cap, cfg["d"], starts,
                                       fig["iterations_per_start"], itemsize)
            bound += (a.iterations + 1) * max(flops / peaks["flops_per_s"][dtype],
                                              nbytes / peaks["bytes_per_s"])
    return 100.0 * bound / device_s
