"""Tracing and profiling utilities.

Port of `rollout_bo_tpu/utils/profiling.py`. The reference's only
observability is per-iteration `@timed` wall time and allocated bytes in
`*_times.csv` / `*_allocations.csv` (myopic_bayesopt.jl:224-234,
adaptive_bayesopt.jl:508-520). Here: (a) a `torch.profiler` trace of CPU
and CUDA activity exported as a Chrome trace (chrome://tracing or
ui.perfetto.dev), with named regions from `annotate`; (b) a per-phase
wall-clock accumulator that can end each phase in a device synchronize;
(c) the CUDA caching allocator's statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["trace", "annotate", "PhaseTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity where
    there is a card) and write `trace.json` (Chrome trace format) into
    log_dir; yields the profiler. Usage:

        with profiling.trace("traces/acq") as prof:
            acquire(state, rnstream, restarts)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulate wall seconds per named phase (the @timed analog).

    With a CUDA `device`, each phase ends in `torch.cuda.synchronize`, so
    that the seconds cover the device work queued inside it; otherwise the
    caller synchronizes.

        t = PhaseTimer(device="cuda")
        with t.phase("acquisition"):
            xnext = acquire(...)
        t.report()
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        out = "\n".join(
            f"{name}: total {self.totals[name]:.3f}s over "
            f"{self.counts[name]} calls (mean {self.mean(name):.3f}s)"
            for name in sorted(self.totals))
        print(out)
        return out


def device_memory_stats(device=None) -> dict:
    """The CUDA caching allocator's statistics of `device` (default: the
    current CUDA device), or {} for a CPU device or without a card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
