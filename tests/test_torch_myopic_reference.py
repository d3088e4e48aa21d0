"""PyTorch port: the myopic loop against the benchmark's plain reference
(`benchmark/reference/`, plain PyTorch that imports nothing of the port),
on the CPU, and the split of a myopic chunk's trace record.

A trial at hartmann6d, capacity 8 (5 initial points, budget 3), 4 + 2
starts, float64: every observation against the true function, the
lengthscale after each observation against the reference's chain of
warm-started fits, K^{-1} y after the last, and the EI shortfall of each
observed point below the reference's own projected-Newton winner from the
same starts. The reference computed in float32 in the program's place
fails at least one of the same tolerances. The chunk's record holds one
solve and one observe step per BO iteration, each with its refit flag,
and the points do not depend on whether a record is open.
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.reference import gp as RG
from benchmark.reference import rollout as RR
from benchmark.reference import testfns as RT
from benchmark.yardstick import qmc
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.models.decision_rules import EI
from rollout_bo_tpu_torch.rollout import bo
from rollout_bo_tpu_torch.utils import graphs, profiling

torch.set_num_threads(1)

N0, BUDGET, STARTS, ITERATIONS, NOISE = 5, 3, 4, 12, 1e-6
# float64 rounding, with room: the true function in another order of sums
# (y), 60 Adam steps on the likelihood (lengthscale), a solve at cond(K)
# up to ~1e6 (K^{-1} y), two ascents of one EI surface that stop within a
# few ulps of one another (shortfall)
TOL = dict(y_gap=1e-12, mle_gap=1e-9, posterior_gap=1e-8, ei_shortfall=1e-6)


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())


def _x_init():
    return qmc.uniform(np.random.default_rng(11), N0, *RT.get("hartmann6d")[2:])


def _trial(monkeypatch, **kw):
    """(the trial's result, the lengthscale after each of its fits)."""
    fits, optimize = [], sg.optimize_hypers

    def recorded(*a, **k):
        state = optimize(*a, **k)
        fits.append(float(state.kernel.theta[0]))
        return state

    monkeypatch.setattr(sg, "optimize_hypers", recorded)
    res = bo.run_myopic_bo(tf.get_function("hartmann6d"), EI(), budget=BUDGET, n_init=N0,
                           num_starts=STARTS, x_init=_x_init(), device="cpu", **kw)
    return res, fits


def _chain(X, y, dtype):
    """The reference's lengthscale before each BO iteration and after the last."""
    Xt, yt = torch.tensor(X, dtype=dtype), torch.tensor(y, dtype=dtype)
    ells = [1.0]
    for b in range(BUDGET):
        ells.append(RG.fit_lengthscale(Xt[:N0 + b + 1], yt[:N0 + b + 1], ells[-1], 0.1, 5.0,
                                       NOISE))
    return ells


def _solve(X, y, ell, dtype):
    """(the reference's GP of X, y at ell, its incumbent, its EI winner)."""
    _, _, lbs, ubs = RT.get("hartmann6d")
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    gp = RG.fit(t(X)[None], t(y)[None], ell, NOISE)
    fmini = t([np.min(y)])
    xw, vw = RR.inner_solve(gp, fmini, t(qmc.starts(STARTS, lbs, ubs, 1e-6)), t(lbs), t(ubs),
                            iterations=ITERATIONS)
    return gp, fmini, xw[0].double().numpy(), float(vw[0])


def _gaps(X, y, ells, c, winners):
    """The candidate's observations y, lengthscales after each fit, K^{-1} y
    and each iteration's point, against the float64 reference at the
    program's points X."""
    f = RT.get("hartmann6d")[0]
    ref_y = f(torch.tensor(X)).numpy()
    ref_ells = _chain(X, ref_y, torch.float64)
    c_ref = RG.fit(torch.tensor(X), torch.tensor(ref_y), ells[-1], NOISE).c.numpy()
    shortfalls = []
    for b, x in enumerate(winners):
        gp, fmini, _, vbest = _solve(X[:N0 + b], ref_y[:N0 + b], ref_ells[b], torch.float64)
        v = float(RG.ei(*RG.posterior_value(gp, torch.tensor(x)[None], 0), fmini)[0])
        shortfalls.append(max(0.0, vbest - v) / max(abs(vbest), 1e-300))
    return dict(y_gap=float(np.max(np.abs(y - ref_y) / np.maximum(np.abs(ref_y), 1.0))),
                mle_gap=max(abs(a - b) / b for a, b in zip(ells, ref_ells[1:])),
                posterior_gap=common.rel_gap(c, c_ref), ei_shortfall=max(shortfalls))


def test_the_myopic_trial_agrees_with_the_plain_reference(monkeypatch):
    res, fits = _trial(monkeypatch)
    X, y = res.X, res.y
    assert X.shape == (N0 + BUDGET, 6) and len(fits) == BUDGET
    n = int(res.state.n)
    assert fits[-1] == float(res.state.kernel.theta[0])
    gaps = _gaps(X, y, fits, res.state.c[:n].numpy(), X[N0:])
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps


def test_the_float32_reference_in_the_programs_place_fails(monkeypatch):
    """The reference in float32 at the program's points: its observations,
    chain of fits, K^{-1} y and EI winners judged by the same tolerances."""
    res, _ = _trial(monkeypatch)
    X = res.X
    f32 = torch.float32
    y32 = RT.get("hartmann6d")[0](torch.tensor(X, dtype=f32)).double().numpy()
    ells = _chain(X, y32, f32)
    c = RG.fit(torch.tensor(X, dtype=f32), torch.tensor(y32, dtype=f32), ells[-1],
               NOISE).c.double().numpy()
    winners = [_solve(X[:N0 + b], y32[:N0 + b], ells[b], f32)[2] for b in range(BUDGET)]
    gaps = _gaps(X, y32, ells[1:], c, winners)
    assert any(gaps[k] > TOL[k] for k in TOL), gaps


def test_a_myopic_chunk_records_each_iterations_solve_and_observe_step():
    """MLE every other observation: one `bo.acquire` and one `bo.observe`
    span per iteration, the refit flags 0, 1, 0, and no device time on the
    CPU."""
    bo.run_myopic_bo(tf.get_function("hartmann6d"), EI(), budget=BUDGET, n_init=N0,
                     num_starts=STARTS, x_init=_x_init(), device="cpu", mle_every=2)
    rec = profiling.RECORDS[-1]
    assert (rec.loop, rec.b, rec.iterations) == ("myopic", 0, BUDGET)
    assert [s.name for s in rec.spans] == ["bo.chunk"] + ["bo.acquire", "bo.observe"] * BUDGET
    assert rec.steps == [profiling.Step(None, None, r) for r in (False, True, False)]
    assert rec.refit and (rec.lane_launches, rec.lane_block_launches) == (0, 0)


def test_the_points_do_not_depend_on_an_open_record(monkeypatch):
    res, _ = _trial(monkeypatch)
    kept = len(profiling.RECORDS)

    @contextlib.contextmanager
    def no_record(*a, **k):
        yield None

    graphs.PROGRAM_CACHE.clear()
    monkeypatch.setattr(profiling, "record", no_record)
    bare, _ = _trial(monkeypatch)
    assert len(profiling.RECORDS) == kept
    np.testing.assert_array_equal(bare.X, res.X)
    np.testing.assert_array_equal(bare.y, res.y)
    assert torch.equal(bare.state.c, res.state.c)
    assert torch.equal(bare.state.kernel.theta, res.state.kernel.theta)
