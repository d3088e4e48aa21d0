"""PyTorch port, the trace records of the BO loops (`utils.profiling`): one
record per BO iteration (per myopic chunk) with its span tree and
counters, the fallback's span, spans kept out of a profiler the port did
not start and their stamps on that profiler's clock, spans mirrored inside
`profiling.trace()`, and on the card the device time of the graph
replays.

The CPU tests run tiny trials in float64. The test marked `cuda` skips
without a CUDA device; this file imports no jax, so on a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import math

import numpy as np
import pytest
import torch

from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.rollout import bo, outer
from rollout_bo_tpu_torch.utils import graphs, profiling

torch.set_num_threads(1)

SPANS = {"bo.iteration", "bo.chunk", "bo.acquire", "bo.fallback", "bo.observe", "outer.step",
         "outer.stop_read", "outer.final"}
# kineto takes its timestamps from a clock of its own converted to the
# epoch's: a few microseconds either way of time.time_ns()
CLOCK_SLACK_NS = 20_000


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())


def _trial(loop="nonmyopic", device="cpu", budget=2, **kw):
    """(result, the trace records of its BO iterations)."""
    res = _run(loop, device, budget, **kw)
    last = profiling.RECORDS[-1].serial
    return res, [r for r in profiling.RECORDS if r.serial == last]


def _run(loop, device, budget, **kw):
    f = tf.get_function("hartmann3d")
    x_init = np.random.default_rng(3).uniform(f.lbs, f.ubs, (5, f.dim))
    common = dict(budget=budget, num_starts=4, x_init=x_init, device=device,
                  solver_iterations=4)
    if loop == "myopic":
        from rollout_bo_tpu_torch.models.decision_rules import EI
        return bo.run_myopic_bo(f, EI(), steps_per_call=2, **common, **kw)
    rollout = dict(horizon=1, mc_iters=4, num_restarts=2, sgd_iters=4, **common, **kw)
    if loop == "adaptive":
        return bo.run_adaptive_bo(f, mle_every=1, **rollout)
    return bo.run_nonmyopic_bo(f, outer_solver="fused", **rollout)


def _tree(rec):
    """(name, parent's name) of every span but the root."""
    return [(s.name, rec.spans[s.parent].name) for s in rec.spans[1:]]


@pytest.mark.parametrize("loop", ["nonmyopic", "adaptive"])
def test_each_bo_iteration_keeps_one_record_with_its_span_tree(loop):
    kept = len(profiling.RECORDS)
    res, recs = _trial(loop)
    assert len(recs) == 2 and list(profiling.RECORDS)[kept:] == recs
    for b, rec in enumerate(recs):
        assert (rec.b, rec.loop, rec.iterations, rec.cuda) == (b, loop, 1, False)
        assert rec.spans[0].name == "bo.iteration" and rec.spans[0].parent == -1
        steps = int(res.sga_iterations[b])
        acquire = ([("bo.acquire", "bo.iteration")]
                   + [("outer.step", "bo.acquire"), ("outer.stop_read", "bo.acquire")] * steps
                   + [("outer.final", "bo.acquire")])
        assert _tree(rec) == acquire + [("bo.observe", "bo.iteration")]
        assert rec.sga_steps == steps > 0
        assert rec.fallback == bool(res.fallbacks[b]) and rec.refit
        assert math.isfinite(rec.value) and rec.value > 0
        assert rec.spans[1].seconds == res.times[b]
        for s in rec.spans:
            assert s.end_ns >= s.start_ns
            if s.parent >= 0:
                p = rec.spans[s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert rec.replays == [] and not rec.traced and rec.captures == 0
    assert _trial(loop)[1][0].serial > recs[0].serial


def test_a_myopic_chunk_is_one_record():
    """One record per chunk, with a `bo.acquire` and a `bo.observe` span
    for each of its iterations and their steps (no device time here)."""
    _, recs = _trial("myopic", budget=3)
    assert [(r.b, r.iterations, r.loop) for r in recs] == [(0, 2, "myopic"), (2, 1, "myopic")]
    for rec in recs:
        assert _tree(rec) == [("bo.acquire", "bo.chunk"),
                              ("bo.observe", "bo.chunk")] * rec.iterations
        assert rec.refit and rec.refits == [True] * rec.iterations
        assert rec.steps == [profiling.Step(None, None, True)] * rec.iterations
        assert rec.value is None and rec.sga_steps == 0 and rec.lane_launches == 0


def test_a_flat_acquisition_records_the_fallback(monkeypatch):
    solve = outer.stochastic_solve_fused

    def answers_zero(*args, **kw):
        res = solve(*args, **kw)
        return res._replace(value=res.value * 0.0)

    monkeypatch.setattr(outer, "stochastic_solve_fused", answers_zero)
    res, recs = _trial()
    assert res.fallbacks.all()
    for rec in recs:
        assert rec.fallback and rec.value == 0.0
        assert ("bo.fallback", "bo.acquire") in _tree(rec)
        (i,) = [i for i, s in enumerate(rec.spans) if s.name == "bo.fallback"]
        assert rec.spans[i - 1].name == "outer.final"


def _profiled():
    """A tiny trial under a bare torch.profiler, as the harness runs it,
    with a `record_function` probe inside every SGA step: (result, its
    records, kineto events as (name, start_ns, end_ns))."""
    step = outer._sga_step

    def probed(*args, **kw):
        with torch.profiler.record_function("probe.step"):
            return step(*args, **kw)

    outer._sga_step = probed
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res, recs = _trial()
    finally:
        outer._sga_step = step
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return res, recs, events


def test_spans_stay_out_of_a_profiler_the_port_did_not_start_and_share_its_clock():
    res, recs, events = _profiled()
    assert not SPANS & {name for name, _, _ in events}
    assert all(rec.traced for rec in recs)
    probes = [(a, b) for name, a, b in events if name == "probe.step"]
    steps = [s for rec in recs for s in rec.spans if s.name == "outer.step"]
    assert len(probes) == len(steps) == int(res.sga_iterations.sum())
    for a, b in probes:
        inside = [s for s in steps
                  if s.start_ns - CLOCK_SLACK_NS <= a and b <= s.end_ns + CLOCK_SLACK_NS]
        assert len(inside) == 1


def test_trace_mirrors_the_spans_into_its_own_profile(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        _, recs = _trial(budget=1)
    names = {e.key for e in prof.key_averages()}
    assert {"bo.iteration", "bo.acquire", "bo.observe", "outer.step", "outer.stop_read",
            "outer.final"} <= names
    assert "outer.step" in (tmp_path / "trace" / "trace.json").read_text()
    assert recs[0].traced
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer.step"):
            torch.ones(2).sum()
    assert "outer.step" not in {e.key for e in prof.key_averages()}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and timing events are CUDA's")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replays_carry_device_time_on_the_card():
    dev = _card()
    _, recs = _trial(device=dev)
    for rec in recs:
        assert rec.cuda and rec.replays
        assert all(r.device_s > 0 for r in rec.replays)
        assert rec.replays[0].idle_s is None
        assert all(r.idle_s >= 0 for r in rec.replays[1:])
        names = [rec.spans[r.span].name for r in rec.replays]
        assert names == ["outer.step"] * rec.sga_steps + ["outer.final", "bo.observe"]
    assert recs[0].captures > 0 and recs[1].captures == 0

    prog = graphs.GraphProgram(lambda x: x * 2.0 + 1.0, device=dev)
    x = torch.ones(8, device=dev)
    with profiling.record("bo.iteration", serial=-1, b=0, loop="nonmyopic", device=dev) as rec:
        with profiling.span("outer.step"):
            prog(x)                                         # the capture, then a replay
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            assert profiling.replay_start(dev) is None      # no event inside a capture
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profiling.span("outer.step"):
                prog(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        y = prog(x).cpu()                                   # the loop's own host read
    assert rec.captures == 1 and len(rec.replays) == 3 and float(y[0]) == 3.0
    assert [rec.spans[r.span].name for r in rec.replays] == ["outer.step", "outer.step",
                                                            "bo.iteration"]
    try:
        with profiling.record("bo.iteration", serial=-1, b=1, loop="nonmyopic",
                              device=dev) as rec:
            prog(x).cpu()
            torch.cuda.set_sync_debug_mode("error")         # the record's close
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(rec.replays) == 1 and rec.replays[0].device_s > 0


def _matmuls(w):
    def fn(x):
        for _ in range(40):
            x = torch.tanh(x @ w)
        return x
    return fn


@pytest.mark.cuda
def test_a_myopic_chunk_times_each_solve_and_observe_step_on_the_card():
    """Each iteration's solve replay and observe replay are charged to its
    own `bo.acquire` and `bo.observe` spans; a chunk that captures nothing
    launches the lane kernel once an iteration, never the lane block."""
    _, recs = _trial("myopic", device=_card(), budget=3)
    assert [r.captures for r in recs] == [2, 0]         # the solve's and the observe's
    for rec in recs:
        assert [rec.spans[r.span].name for r in rec.replays] == [
            "bo.acquire", "bo.observe"] * rec.iterations
        assert len(rec.steps) == rec.iterations and rec.lane_block_launches == 0
        assert all(s.solve_s > 0 and s.observe_s > 0 and s.refit for s in rec.steps), rec.steps
    assert recs[1].lane_launches == 1


@pytest.mark.cuda
def test_replay_events_lie_on_the_stream_the_replay_runs_on():
    """A replay on a side stream, and where there are two cards one on the
    second while the first is current, is timed on its own stream: its
    device time is the matmuls' (milliseconds), not an idle stream's."""
    devs = [_card()] + ([torch.device("cuda", 1)] if torch.cuda.device_count() > 1 else [])
    for dev in devs:
        w = torch.randn(2048, 2048, device=dev) / 64
        prog = graphs.GraphProgram(_matmuls(w), device=dev)
        x = torch.randn(2048, 2048, device=dev)
        prog(x)                                             # the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with profiling.record("bo.iteration", serial=-1, b=0, loop="nonmyopic",
                              device=dev) as rec:
            alone = prog(x).cpu()
            with torch.cuda.stream(side):
                on_side = prog(x).cpu()
        assert torch.equal(alone, on_side)
        assert len(rec.replays) == 2 and all(r.device_s > 1e-4 for r in rec.replays)
        assert torch.cuda.current_device() == 0
