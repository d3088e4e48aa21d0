"""The harness: one run of one cell, from BENCHMARK.json to the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by its name:

- the cell (`workloads` entry) names its configuration and its traffic;
  the configuration's file is the `file` of its `configs` entry, the
  traffic's is `benchmark/traffic/<traffic>.json`, and the cell's fixed
  figures (its lane kernel's iterations per start, its correctness
  limits) are in `benchmark/cells/<cell>.json`;
- the traffic's `loop` names the loop module, `benchmark/loops/<loop>.py`:
  it sets the cell up from the seed, runs the window, and gives the
  answers that `correct` judges;
- every metric of BENCHMARK.json is read by `benchmark/metrics/<name>.py`,
  whose `read(run)` returns a number, or None where the run holds nothing
  to read; a metric that reads None is left out of the line;
- the lane kernel's names are `benchmark/kernels/lane_kernel/*.json`.

A run: set-up (inputs and weights from the seed, the warm-up of every
program the window uses, then of the card itself), the window (`--seconds`; with `--trace 1` a part
of it under the profiler), the peak of device memory, the metrics, the
program's state released, the reference's check of the answers, the check
that neither JAX nor the JAX package was loaded, and the result line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rollout_bo_tpu")
# the device warm-up before every window (`warm_device`)
WARM_N = 4096
PROBE_KERNELS, PROBE_BLOCK_S, PROBE_FAST_US, PROBE_CAP_S = 2000, 0.5, 1.17, 40.0


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and figures."""

    def __init__(self, workload: str, *, spec_path: Path, data_root: Path):
        spec = json.loads(Path(spec_path).read_text())
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                             f"{sorted(by_name)}")
        self.spec = spec
        self.name = workload
        self.entry = by_name[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((data_root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (data_root / "benchmark" / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.figures = json.loads(
            (data_root / "benchmark" / "cells" / f"{workload}.json").read_text())
        self.chips = int(self.entry["chips"])

    def metrics(self, kind: str) -> list[dict]:
        """The metrics of `kind` ("end_to_end" or "per_layer") this cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(loop: str) -> ModuleType:
    return _load(HERE / "loops" / f"{loop}.py", f"benchmark.loops.{loop}")


def metric_reader(name: str) -> ModuleType:
    return _load(HERE / "metrics" / f"{name}.py", f"benchmark.metrics.{name}")


def read_metrics(cell: Cell, run, kind: str) -> dict:
    out = {}
    for m in cell.metrics(kind):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def judge(checks: list[tuple[str, float, float]], answered: int) -> bool:
    """True when answers came and every compared number is finite and
    within its limit."""
    return answered > 0 and bool(checks) and all(math.isfinite(v) and v <= limit
                                                 for _, v, limit in checks)


def _probe_graph(device):
    """A CUDA graph of PROBE_KERNELS one-element additions: its device time
    per kernel reads the card's state for streams of small kernels."""
    import torch

    x = torch.zeros(1, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            x.add_(1.0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PROBE_KERNELS):
            x.add_(1.0)
    return graph, x


def warm_device(device, log=print) -> tuple[int, float]:
    """Bring the card to its steady state for streams of small kernels;
    return the program's peak of allocated memory until then (the peak is
    reset afterwards, the warm-up's own memory freed) and the warm-up's
    seconds.

    An H100 runs graphs of small kernels up to 30% slower for a spell after
    a process starts (0 to 30 s and more, from process to process, and
    one way: once over, it stays over), with the SM clock, the power limit
    and large products unchanged. Products under way end the spell within
    seconds. So blocks of PROBE_BLOCK_S alternate the probe graph with a
    float32 product until two blocks running read the probe under
    PROBE_FAST_US per kernel (the steady H100 reads 1.03-1.05, the spell
    1.31-1.39), or PROBE_CAP_S pass. Nothing on the CPU."""
    import torch

    if device.type != "cuda":
        return 0, 0.0
    torch.cuda.synchronize(device)
    before = int(torch.cuda.max_memory_allocated(device))
    t0 = time.perf_counter()
    graph, x = _probe_graph(device)
    a = torch.randn(WARM_N, WARM_N, device=device)
    b = torch.empty_like(a)
    fast, blocks, reading = 0, 0, math.nan
    while fast < 2 and time.perf_counter() - t0 < PROBE_CAP_S:
        times = []
        tb = time.perf_counter()
        while time.perf_counter() - tb < PROBE_BLOCK_S:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            torch.mm(a, a, out=b)
            torch.cuda.synchronize(device)
            times.append(e0.elapsed_time(e1) * 1e3 / PROBE_KERNELS)
        reading = sum(times) / len(times)
        fast = fast + 1 if reading < PROBE_FAST_US else 0
        blocks += 1
    del a, b, graph, x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    seconds = time.perf_counter() - t0
    log(f"set-up: device warm-up {seconds:.3f} s, {blocks} blocks, the probe "
        f"at {reading:.4f} us per kernel{'' if fast >= 2 else ' (capped)'}")
    return before, seconds


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=print) -> dict:
    """One run of `cell` on `device`: the result line's object."""
    import torch

    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the loop")
    loop = loop_module(cell.traffic["loop"]).Loop(cell, seed, device, log=log)
    loop.setup()
    peak_setup, warm_s = warm_device(device, log)
    # the card's warm-up lasts as long as its state asks, whatever the
    # program: `setup_s` is the rest, `device.warm_s` the warm-up
    setup_s = time.perf_counter() - t_start - warm_s
    log(f"set-up: {setup_s + warm_s:.3f} s to the window")
    run = loop.window(seconds, trace=trace)
    run.setup_s, run.warm_s = setup_s, warm_s
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    run.peak_bytes = max(peak_setup, int(torch.cuda.max_memory_allocated(device))) if cuda else 0
    metrics = read_metrics(cell, run, "per_layer" if trace else "end_to_end")
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = loop.check(run)
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    out = {
        "correct": judge(checks, run.attempted - run.failed),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": cell.chips,
            "memory_peak_bytes": run.peak_bytes,
        },
    }
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json for one seed.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = Cell(args.workload, spec_path=ROOT / "BENCHMARK.json", data_root=ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start, log=log)
    loaded = forbidden_modules()
    if loaded:
        print(f"refused: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
