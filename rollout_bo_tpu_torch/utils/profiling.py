"""The port's tracing: a record of every BO iteration, with its spans, its
counters and the device time of its graph replays, and a torch.profiler
trace that shows the spans over the kernels.

The reference's only observability is per-iteration `@timed` wall time
and allocated bytes (myopic_bayesopt.jl:224-234,
adaptive_bayesopt.jl:508-520). Here the BO loops (`rollout.bo`) keep an
`IterationRecord` of each BO iteration (of each chunk in the myopic loop),
always, whether a profiler runs or not:

- `record(root, ...)` opens the iteration's record and its root span
  (`bo.iteration`, or `bo.chunk`); on its close the record goes to
  `RECORDS`;
- `span(name)` stamps the start and end of a region on the profiler's
  clock (`time.time_ns()`: torch.profiler's events lie on the epoch
  clock) with the span it opened in; with no record open and no `trace()`
  running it does nothing but the test;
- `note(**counters)` sets counters of the open record (the fallback taken,
  the acquisition's best value); `note_refit(refit)` counts one BO
  iteration's observe step and whether it refit;
- `replay_start(device)` / `replay_end(mark)`: `utils.graphs.GraphProgram`
  brackets each replay (its launch to its last output clone) with a pair
  of CUDA timing events from a reused pool, recorded on the current stream
  of the program's device, the stream the replay runs on, and charged to
  the innermost open span, where a record is open and no stream captures
  (a timing event recorded during a capture becomes a node of the graph,
  one event that every replay records anew: by the host read at a
  chunk's end only the last replay's time is left in it). The argument
  copies before the launch lie outside the pair: each is a CUDA call the
  host issues while the device waits, so they belong to the device's idle
  time between replays. A pair is resolved into seconds once the device has passed it
  (`Event.query`, which does not wait): during the next replay, while the
  host waits for the device anyway, and the last at the record's close,
  after the loop's own host read. Nothing here synchronizes. Off CUDA only
  the host stamps are taken.

The spans the port opens: `bo.iteration` / `bo.chunk` (root),
`bo.acquire` (the acquisition and the loop's synchronize: `times[b]`; in
a chunk, each iteration's solve), `bo.fallback` (the exploration
fallback, when taken), `bo.observe` (true function, condition, MLE when
due, the host read; in a chunk, each iteration's observe step),
`outer.step` (one call of an SGA step: copies, replay, clones),
`outer.stop_read` (the host's read of "all stopped") and `outer.final`
(the value-only pass and argmax).
`IterationRecord.steps` splits a record's device time by BO iteration:
the solve's and the observe step's, with the iteration's refit flag.

Spans and replays are tuples of plain values, which the garbage collector
stops tracking, so the records kept cost its passes nothing.

No span reaches a profiler that the port did not start: a
`record_function` also draws an annotation on the device's timeline,
which a reader of someone else's profile would count as device work.
Inside `trace()`, and only there, every span also opens a
`record_function` of its name, so that the exported `trace.json` shows
the program's spans over the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from collections import deque
from typing import NamedTuple

import torch

__all__ = ["Span", "Replay", "Step", "IterationRecord", "RECORDS", "record", "span", "note",
           "note_refit", "replay_start", "replay_end", "next_serial", "trace"]

RECORDS: deque = deque(maxlen=1024)     # the finished records, oldest first
_OPEN = None                            # the record of the iteration running
_MIRROR = False                         # inside `trace()`
_SERIALS = itertools.count()
_EVENT_POOL: dict = {}                  # device index -> free timing events
_NO_SPAN = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int                   # time.time_ns(), the profiler's clock
    end_ns: int                     # 0 while the span is open
    parent: int = -1                # index of the enclosing span; -1 for the root

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Replay(NamedTuple):
    """One graph replay's device time, from its pair of timing events."""

    span: int                       # the span it is charged to
    device_s: float                 # the replay's launch to its last output clone
    idle_s: float | None            # device time since the record's previous replay ended


class Step(NamedTuple):
    """One BO iteration of a record: the device seconds of the replays inside
    its `bo.acquire` span (the solve) and inside its `bo.observe` span (true
    function, condition, MLE where due), None off CUDA, and whether it refit."""

    solve_s: float | None
    observe_s: float | None
    refit: bool


@dataclasses.dataclass
class IterationRecord:
    """One BO iteration (a myopic chunk of `iterations`), identified by the
    serial of its `run_*_bo` call and its first BO iteration `b`."""

    serial: int
    b: int
    loop: str                       # "nonmyopic", "adaptive" or "myopic"
    iterations: int = 1
    spans: list = dataclasses.field(default_factory=list)      # [Span], in order of start
    replays: list = dataclasses.field(default_factory=list)    # [Replay], in order
    fallback: bool = False          # the exploration fallback taken
    refit: bool = False             # the MLE run (in any of the record's iterations)
    refits: list = dataclasses.field(default_factory=list)     # [bool], per BO iteration
    value: float | None = None      # the acquisition's best value, as the fallback test read it
    captures: int = 0               # graph captures (`graphs.CAPTURES` delta)
    # lane-kernel launches of the lane-block design (`newton_lanes
    # .LANE_BLOCK_LAUNCHES` delta): how many of the iteration's solves took it
    lane_block_launches: int = 0
    lane_launches: int = 0          # every lane-kernel launch (`newton_lanes.LAUNCHES` delta)
    traced: bool = False            # a profiler was recording at some point
    cuda: bool = False
    _stack: list = dataclasses.field(default_factory=lambda: [-1], repr=False)
    # pairs not resolved yet: (span, device index, start event, end event)
    _pending: list = dataclasses.field(default_factory=list, repr=False)
    _last: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def sga_steps(self) -> int:
        """SGA steps run: calls of the step (a scanned window counts one)."""
        return sum(s.name == "outer.step" for s in self.spans)

    @property
    def steps(self) -> list:
        """[Step] of the record's BO iterations, in order: the k-th
        `bo.acquire` and the k-th `bo.observe` child of the root are
        iteration k's (a myopic chunk opens both once per iteration)."""
        top, seen = {}, {"bo.acquire": 0, "bo.observe": 0}
        for i, s in enumerate(self.spans):
            if s.parent == 0 and s.name in seen:
                top[i] = (s.name == "bo.observe", seen[s.name])
                seen[s.name] += 1
        times = [[0.0, 0.0] for _ in range(seen["bo.acquire"])]
        for r in self.replays:
            i = r.span
            while i > 0 and self.spans[i].parent != 0:
                i = self.spans[i].parent
            if i in top and top[i][1] < len(times):
                times[top[i][1]][top[i][0]] += r.device_s
        return [Step(a if self.cuda else None, o if self.cuda else None, refit)
                for (a, o), refit in zip(times, self.refits)]

    def within(self, i: int, name: str) -> bool:
        """Whether span i is a span named `name` or lies inside one."""
        while i >= 0:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def _enter(self, name: str) -> int:
        self.traced = self.traced or torch.autograd._profiler_enabled()
        i = len(self.spans)
        self.spans.append(Span(name, time.time_ns(), 0, self._stack[-1]))
        self._stack.append(i)
        return i

    def _exit(self, i: int) -> None:
        s = self.spans[i]
        self.spans[i] = Span(s.name, s.start_ns, time.time_ns(), s.parent)
        self._stack.pop()
        self.traced = self.traced or torch.autograd._profiler_enabled()

    def _settle(self, keep: int) -> None:
        """Resolve the pending pairs, oldest first and all but the newest
        `keep`, while the device has passed them, into `replays`; their
        events go back to the pool, but for the last end, which the next
        pair's idle time reads."""
        while len(self._pending) > keep and self._pending[0][3].query():
            s, dev, start, end = self._pending.pop(0)
            idle = None
            if self._last is not None:
                if self._last[0] == dev:
                    idle = self._last[1].elapsed_time(start) * 1e-3
                _EVENT_POOL[self._last[0]].append(self._last[1])
            _EVENT_POOL[dev].append(start)
            self._last = (dev, end)
            self.replays.append(Replay(s, start.elapsed_time(end) * 1e-3, idle))

    def _close(self) -> None:
        """Resolve every pair; one the device has not passed (none, after
        the loops' host read) is dropped, its events reused."""
        self._settle(0)
        for _, dev, start, end in self._pending:
            _EVENT_POOL[dev].extend((start, end))
        if self._last is not None:
            _EVENT_POOL[self._last[0]].append(self._last[1])
        self._pending.clear()
        self._last = None


class _Span:
    """An open span: `seconds` once it has closed."""

    __slots__ = ("rec", "name", "i", "mirror")

    def __init__(self, rec, name):
        self.rec, self.name, self.mirror = rec, name, None

    def __enter__(self):
        if _MIRROR:
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        if self.rec is not None:
            self.i = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._exit(self.i)
        if self.mirror is not None:
            self.mirror.__exit__(*exc)

    @property
    def seconds(self) -> float:
        return self.rec.spans[self.i].seconds


def next_serial() -> int:
    """The serial of a new `run_*_bo` call."""
    return next(_SERIALS)


@contextlib.contextmanager
def record(root: str, *, serial: int, b: int, loop: str, device, iterations: int = 1):
    """Open the record of one BO iteration (or myopic chunk) and its root
    span `root`; yields the record, which goes to `RECORDS` on a normal
    exit, its replays resolved."""
    global _OPEN
    from rollout_bo_tpu_torch.ops import newton_lanes
    from rollout_bo_tpu_torch.utils import graphs      # graphs imports this module

    rec = IterationRecord(serial, b, loop, iterations, cuda=torch.device(device).type == "cuda")
    captures, launches = graphs.CAPTURES, newton_lanes.LAUNCHES
    lane_block = newton_lanes.LANE_BLOCK_LAUNCHES
    enclosing, _OPEN = _OPEN, rec
    try:
        with span(root):
            yield rec
        rec.captures = graphs.CAPTURES - captures
        rec.lane_launches = newton_lanes.LAUNCHES - launches
        rec.lane_block_launches = newton_lanes.LANE_BLOCK_LAUNCHES - lane_block
        rec._close()
        RECORDS.append(rec)
    finally:
        _OPEN = enclosing


def span(name: str):
    """A span of the open record (see the module docstring); `with
    span(name) as s` gives `s.seconds` after the block where a record is
    open."""
    if _OPEN is None and not _MIRROR:
        return _NO_SPAN
    return _Span(_OPEN, name)


def note(**counters) -> None:
    """Set counters (`fallback`, `value`) of the open record."""
    rec = _OPEN
    if rec is not None:
        for name, v in counters.items():
            setattr(rec, name, v)


def note_refit(refit: bool) -> None:
    """Count one BO iteration's observe step in the open record: its
    `refit` flag joins `refits`, and `refit` tells whether any refit."""
    rec = _OPEN
    if rec is not None:
        rec.refits.append(refit)
        rec.refit = rec.refit or refit


def replay_start(device: torch.device):
    """Record the start event of a replay on `device`'s current stream,
    where a record is open on CUDA and no stream captures; returns the
    mark for `replay_end`, or None."""
    rec = _OPEN
    if rec is None or not rec.cuda or torch.cuda.is_current_stream_capturing():
        return None
    stream = torch.cuda.current_stream(device)
    pool = _EVENT_POOL.setdefault(stream.device_index, [])
    # an event is made on the device of the first stream it is recorded on
    start = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return rec, stream, pool, start


def replay_end(mark) -> None:
    """Record the end event of the replay `mark` started, charge the pair
    to the innermost open span, and resolve the record's earlier pairs that
    the device has passed, while it runs this replay."""
    if mark is None:
        return
    rec, stream, pool, start = mark
    end = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    end.record(stream)
    rec._pending.append((rec._stack[-1], stream.device_index, start, end))
    rec._settle(keep=1)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity where
    there is a card) with the program's spans mirrored into it, and write
    `trace.json` (Chrome trace format: ui.perfetto.dev) into log_dir;
    yields the profiler. Usage:

        with profiling.trace("traces/acq") as prof:
            acquire(state, rnstream, restarts)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    global _MIRROR
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    mirror, _MIRROR = _MIRROR, True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        _MIRROR = mirror
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
