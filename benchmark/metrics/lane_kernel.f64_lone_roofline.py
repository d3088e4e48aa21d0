"""The float64 lane kernel's share of its roofline at one lane (the start
blocks of the myopic solve), over the traced BO iterations of a myopic
cell.

Device time: every kernel of the traced stretch whose name matches a
pattern of `benchmark/kernels/lane_kernel/` (the solve and its best-start
pass); the loop's profiler covers exactly the traced iterations. The
bound: the solve of BO iteration b runs one lane at n_init + b
observations, the configuration's capacity, num_starts + 2 starts, each
running the cell's fixed iterations per start; its work comes from the
frozen `yardstick/lane_work.py`, and its least time is the larger of the
operations over the float64 peak and the bytes over the memory's peak
(`yardstick/peaks.json`). The share is the sum of the bounds over the sum
of the device times, in percent; None where the cell is no float64
myopic cell or the trace holds no lane kernel."""

import json

from benchmark import trace
from benchmark.lane_roofline import PEAKS
from benchmark.yardstick.lane_work import solve_work


def read(run):
    cfg, tr, fig = run.cell.config, run.cell.traffic, run.cell.figures
    traced = run.traced
    if (cfg["dtype"] != "float64" or tr["loop"] != "myopic_trials" or run.trace is None
            or not traced):
        return None
    lane = trace.load_patterns("lane_kernel")
    device_s = sum(b - a for name, a, b in run.trace.kernels if trace.matches(name, lane))
    if device_s <= 0:
        return None
    peaks = json.loads(PEAKS.read_text())
    bound = 0.0
    for a in traced:
        flops, nbytes = solve_work([a.n_base], cfg["capacity"], cfg["d"], tr["num_starts"] + 2,
                                   fig["iterations_per_start"], 8)
        bound += max(flops / peaks["flops_per_s"]["float64"], nbytes / peaks["bytes_per_s"])
    return 100.0 * bound / device_s
