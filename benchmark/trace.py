"""The traced part of a window: torch.profiler over a stretch of the work
the loop chooses, and the arithmetic that reads it.

The loop calls `start()` and `stop()` around the stretch and wraps its
own calls into the program in `span(name)` (a `record_function`, so that
the spans lie on the trace's clock). `stop()` reads the trace:

- kernel intervals (every device event but the spans' annotations) and
  the harness spans;
- the traced window: the `bench.window` span that `start()` opens and
  `stop()` closes, after a synchronize;
- busy seconds: the union of the kernel intervals inside the window (a
  copy of the arithmetic of `scripts/profile_bench_torch.py::summarize`);
- the breakdown: the kernels that took most device time, and the longest
  idle gaps, each named by the harness span it fell in.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from pathlib import Path

SPAN_PREFIX = "bench."
TOP = 10


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) gaps in [lo, hi] that no interval covers."""
    gaps, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def load_patterns(group: str) -> list[dict]:
    """The kernel-name patterns of `group` (`benchmark/kernels/<group>/*.json`,
    each {"pattern": a substring of the kernels' names}): a kernel added or
    renamed later adds a file."""
    folder = Path(__file__).resolve().parent / "kernels" / group
    return [json.loads(p.read_text()) for p in sorted(folder.glob("*.json"))]


def matches(name: str, patterns) -> bool:
    return any(p["pattern"] in name for p in patterns)


class Trace:
    """The read trace: kernels [(name, start_s, end_s)], spans [(name, start_s,
    end_s)], the window (start_s, end_s), all on the trace's clock."""

    def __init__(self, kernels, spans, window, outside: str = "harness"):
        self.outside = outside
        self.kernels = kernels
        self.spans = spans
        self.window = window
        lo, hi = window
        self.clipped = [(max(a, lo), min(b, hi)) for _, a, b in kernels if min(b, hi) > max(a, lo)]
        self.busy_s = union_length(self.clipped)
        self.window_s = hi - lo

    def kernels_in(self, span_name: str):
        """The kernels that start inside a span named `span_name`."""
        spans = [(a, b) for n, a, b in self.spans if n == SPAN_PREFIX + span_name]
        return [k for k in self.kernels if any(a <= k[1] <= b for a, b in spans)]

    def label(self, t: float) -> str:
        """The innermost harness span around time t, or `outside`."""
        inside = [(b - a, n) for n, a, b in self.spans
                  if a <= t <= b and n != SPAN_PREFIX + "window"]
        return min(inside)[1][len(SPAN_PREFIX):] if inside else self.outside

    def breakdown(self) -> dict:
        dur = defaultdict(float)
        for name, a, b in self.kernels:
            dur[name] += b - a
        ops = sorted(dur.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(idle_gaps(self.clipped, *self.window), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.label(0.5 * (a + b)), b - a] for a, b in gaps]}


class Tracer:
    """torch.profiler over what lies between `start()` and `stop()`; off
    when `enabled` is False (then spans cost nothing). An idle gap outside
    every span is named `outside`."""

    def __init__(self, enabled: bool, device, outside: str = "harness"):
        self.outside = outside
        self.enabled = enabled
        self.device = device
        self.active = False
        self.trace: Trace | None = None
        self._prof = None
        self._window = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        import torch

        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield

    def start(self) -> None:
        if not self.enabled or self.active or self.trace is not None:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._window = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._window.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.active = False
        self.trace = read(self._prof, self.outside)
        self._prof = None


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of the profile."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            dev = e.device_type().name == "CUDA"
            start = e.start_ns() / 1e3
            out.append((e.name(), dev, start, start + e.duration_ns() / 1e3))
        return out
    except AttributeError:
        pass
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        dev = dev is not None and dev.name == "CUDA"
        out.append((e.name, dev, float(e.time_range.start), float(e.time_range.end)))
    return out


def read(prof, outside: str = "harness") -> Trace:
    kernels, spans = [], []
    for name, dev, a, b in _events(prof):
        if name.startswith(SPAN_PREFIX):
            # a span is also drawn on the device's timeline (a user
            # annotation): it is no device work
            if not dev:
                spans.append((name, a * 1e-6, b * 1e-6))
        elif dev:
            kernels.append((name, a * 1e-6, b * 1e-6))
    win = [(a, b) for n, a, b in spans if n == SPAN_PREFIX + "window"]
    if win:
        window = win[0]
    elif kernels:
        window = (min(k[1] for k in kernels), max(k[2] for k in kernels))
    else:
        window = (0.0, 0.0)
    return Trace(kernels, spans, window, outside)
