"""PyTorch port: the BO loops' programs outside the SGA solve, on the CPU.

- the myopic loop's chunks (k calls of the "myopic_chunk" program of one
  BO iteration's solve and of the "nm_observe" program, the same two
  programs for every chunk length): any chunk size gives
  the per-iteration loop's trial bit for bit, in float64 and
  float32, for a solved rule (EI) and for Random, whose draws stay the
  same stream; against the JAX package's chunked loop at
  tests/test_torch_bo.py's tolerances; through a checkpoint and a resume;
  from the CLI's `--steps-per-call`;
- the test functions: a second call copies nothing from the host (their
  tables are device tensors made on the first), which a CUDA graph's
  capture requires;
- the observe program ("nm_observe": true function, condition, MLE when
  due) against the JAX package's own observe program on the same numpy
  state, in float64 to 1e-10;
- the observe, fallback, batch and Gauss-Hermite programs of the
  non-myopic and adaptive loops: from `_cached_program`, under the JAX
  package's keys with the device added, reused by a second trial, equal to
  the eager loop.

On the CPU a program calls its function eagerly, so a program route and
the eager route run the same torch ops: equal bit for bit.
tests/test_torch_cuda.py holds the programs' CUDA graphs to the eager route
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu_torch.experiments import myopic
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout import bo, outer, solvers
from rollout_bo_tpu_torch.utils import checkpoint as ckpt
from rollout_bo_tpu_torch.utils import graphs, metrics
from test_torch_bo import _assert_same_trial, _state_fields, _x_init

torch.set_num_threads(1)

f64 = torch.float64
MYOPIC = dict(num_starts=4, solver_iterations=4, seed=5)


@pytest.fixture(autouse=True)
def empty_cache(monkeypatch):
    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())


def _per_iteration(f, rule, theta, *, budget, dtype, x_init, num_starts, solver_iterations,
                   seed):
    """The myopic trial as a plain loop of the public pieces, one BO
    iteration per pass: solve (Random: one draw from the seeded CPU
    generator), the true function, condition, MLE (not for Random), the
    incumbent kept on the host."""
    t = lambda a: torch.tensor(np.array(a), dtype=dtype)  # noqa: E731
    y_init = f.batch(torch.as_tensor(x_init, dtype=f64)).numpy()
    st = sg.fit(K.matern52(device="cpu", dtype=dtype), x_init, y_init,
                capacity=len(x_init) + budget, noise=1e-6, device="cpu", dtype=dtype)
    lbs, ubs = t(f.lbs), t(f.ubs)
    xstarts = t(qmc.generate_initial_guesses(num_starts, f.lbs, f.ubs))
    gen = torch.Generator().manual_seed(seed)
    X, y, gaps = list(x_init), list(map(float, y_init)), []
    for _ in range(budget):
        res = solvers.multistart_maximize(st, rule, t(theta), lbs, ubs, xstarts,
                                          iterations=solver_iterations, generator=gen)
        gaps.append(metrics.gap(float(y_init.min()), min(y), f.fmin))
        yn = f.f(res.x)
        st = sg.condition(st, res.x, yn)
        if rule.name != "Random":
            st = sg.optimize_hypers(st, t((0.1,)), t((5.0,)))
        X.append(res.x.numpy().astype(float))
        y.append(float(yn))
    return np.stack(X), np.asarray(y), np.asarray(gaps), st


def _chunks(monkeypatch):
    """The length of every chunk the myopic loop records."""
    seen = []
    record = bo._Trial.record_chunk
    monkeypatch.setattr(bo._Trial, "record_chunk",
                        lambda self, b, rows, s: seen.append(len(rows)) or record(self, b, rows, s))
    return seen


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rule_name", ["EI", "Random"])
def test_myopic_chunks_equal_the_per_iteration_loop(monkeypatch, rule_name, dtype):
    """steps_per_call 0 (one chunk of 4), 1 and 3 (3 + 1): the points,
    observations, gaps, minimum observations and fitted state of the
    per-iteration loop, bit for bit; times uniform within each chunk; the
    two programs in the cache are the iteration's solve and observe step,
    whatever the chunks."""
    f = tf.get_function("hartmann3d")
    x_init, budget = _x_init(f), 4
    X, y, gaps, st = _per_iteration(f, dr.RULES[rule_name](), (0.0,), budget=budget,
                                    dtype=dtype, x_init=x_init, **MYOPIC)
    seen = _chunks(monkeypatch)
    for k, chunks in ((0, [4]), (1, [1, 1, 1, 1]), (3, [3, 1])):
        seen.clear()
        res = bo.run_myopic_bo(f, dr.RULES[rule_name](), budget=budget, x_init=x_init,
                               dtype=dtype, device="cpu", steps_per_call=k, **MYOPIC)
        np.testing.assert_array_equal(res.X, X)
        np.testing.assert_array_equal(res.y, y)
        np.testing.assert_array_equal(res.gaps, gaps)
        np.testing.assert_array_equal(res.minimum_observations,
                                      np.minimum.accumulate(y)[len(x_init):])
        for name in ("L", "Li", "c"):
            assert torch.equal(getattr(res.state, name), getattr(st, name)), (k, name)
        assert torch.equal(res.state.kernel.theta, st.kernel.theta)
        assert seen == chunks
        assert [key[0] for key in graphs.PROGRAM_CACHE] == ["myopic_chunk", "nm_observe"]
        starts = np.cumsum([0] + chunks)
        for a, b in zip(starts[:-1], starts[1:]):
            assert np.all(res.times[a:b] == res.times[a]) and res.times[a] > 0.0
        graphs.PROGRAM_CACHE.clear()
    if rule_name == "Random":
        assert float(st.kernel.theta[0]) == 1.0          # no MLE for the random baseline


def test_myopic_chunked_trial_matches_jax():
    """steps_per_call 3 on both packages (budget 6: two chunks), float64:
    tests/test_torch_bo.py's tolerances; each package's times equal within
    each chunk."""
    f, jf = tf.get_function("hartmann3d"), jtf.get_function("hartmann3d")
    kw = dict(budget=6, num_starts=8, x_init=_x_init(f), steps_per_call=3)
    jres = jbo.run_myopic_bo(jf, jdr.EI(), dtype=jnp.float64, **kw)
    res = bo.run_myopic_bo(f, dr.EI(), device="cpu", **kw)
    _assert_same_trial(res, jres, f, x_tol=1e-6)
    for times in (res.times, jres.times):
        assert np.all(times[:3] == times[0]) and np.all(times[3:] == times[3])


class _Killed(Exception):
    pass


@pytest.mark.parametrize("rule_name", ["EI", "Random"])
def test_myopic_chunked_trial_resumes_from_its_checkpoint(tmp_path, monkeypatch, rule_name):
    """Chunks of 3 with a snapshot every 3, killed after the snapshot at 3:
    the resumed trial (the Random stream replayed to the snapshot) equals
    the trial run in one chunk, bit for bit."""
    f = tf.get_function("hartmann3d")
    kw = dict(budget=6, x_init=_x_init(f), device="cpu", **MYOPIC)
    full = bo.run_myopic_bo(f, dr.RULES[rule_name](), **kw)
    ck = str(tmp_path / "ck")
    save = ckpt.save_bo_checkpoint

    def save_then_die(path, state, *, iteration, metrics=None):
        save(path, state, iteration=iteration, metrics=metrics)
        raise _Killed

    with monkeypatch.context() as m:
        m.setattr(ckpt, "save_bo_checkpoint", save_then_die)
        with pytest.raises(_Killed):
            bo.run_myopic_bo(f, dr.RULES[rule_name](), checkpoint_path=ck,
                             checkpoint_every=3, steps_per_call=3, **kw)
    assert ckpt.load_bo_checkpoint(ck, capacity=11, device="cpu")[1] == 3
    res = bo.run_myopic_bo(f, dr.RULES[rule_name](), checkpoint_path=ck,
                           checkpoint_every=3, **kw)
    for name in ("X", "y", "gaps", "simple_regrets", "minimum_observations"):
        np.testing.assert_array_equal(getattr(res, name), getattr(full, name), err_msg=name)


def test_myopic_cli_steps_per_call_reaches_the_loop(tmp_path, monkeypatch):
    """`--steps-per-call 3` at budget 4: the loop is called with it and runs
    a chunk of 3 and one of 1."""
    seen, chunks = [], _chunks(monkeypatch)
    run = bo.run_myopic_bo
    monkeypatch.setattr(bo, "run_myopic_bo",
                        lambda *a, **kw: seen.append(kw["steps_per_call"]) or run(*a, **kw))
    myopic.main(["--function-name", "sixhump", "--trials", "1", "--budget", "4",
                 "--starts", "4", "--acquisitions", "ei", "--steps-per-call", "3",
                 "--device", "cpu", "--output-dir", str(tmp_path)])
    assert seen == [3]
    assert chunks == [3, 1]


@pytest.mark.parametrize("name", sorted(tf.FUNCTION_REGISTRY))
def test_test_function_second_call_copies_nothing_from_the_host(monkeypatch, name):
    """After one call, the function evaluates again (float64 and float32)
    with `torch.as_tensor` / `torch.from_numpy` refusing numpy arrays: its
    tables are tensors made once per device and dtype, values unchanged."""
    f = tf.get_function(name)
    x = np.random.default_rng(0).uniform(f.lbs, f.ubs, (3, f.dim))
    xs = [torch.tensor(x, dtype=dt) for dt in (torch.float64, torch.float32)]
    warm = [f.f(v) for v in xs]
    as_tensor = torch.as_tensor

    def refuse(a, *args, **kw):
        if isinstance(a, np.ndarray):
            raise AssertionError(f"{name}: a tensor made from numpy")
        return as_tensor(a, *args, **kw)

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)
    for v, w in zip(xs, warm):
        assert torch.equal(f.f(v), w)
        assert torch.equal(f.f(v[0]), w[0])


class _Stop(Exception):
    pass


class _Stopper:
    """Stands for a program: calling it raises _Stop."""
    select_best = True

    def __call__(self, *args, **kw):
        raise _Stop


def _keys(module, run):
    """{key[0]: (key, builder)} of the programs `run()` asks `module`'s
    `_cached_program` for before its first acquisition (that program's
    call raises _Stop, so nothing is traced or run)."""
    asked = {}

    def record(key, builder):
        asked[key[0]] = (key, builder)
        return _Stopper()

    old = module._cached_program
    module._cached_program = record
    try:
        with pytest.raises(_Stop):
            run()
    finally:
        module._cached_program = old
    return asked


def _normal(key, f):
    """A key with the test function's id, the rule and the dtype named the
    same way in both packages, and the port's device ("cpu") taken off its
    shape key, the one element the port adds."""
    out = []
    for v in key:
        if isinstance(v, tuple) and len(v) in (6, 7) and isinstance(v[0], int):
            assert len(v) == 6 or v[6] == "cpu"
            v = (v[0], v[1], str(v[2]).replace("torch.", "")) + v[3:6]
        elif v == id(f):
            v = "testfn"
        elif hasattr(v, "name") and not isinstance(v, (int, float, str, tuple)):
            v = ("rule", v.name)
        out.append(v)
    return tuple(out)


def test_programs_are_cached_under_the_jax_keys():
    """The keys the port's loops ask the cache for are the JAX package's,
    with the device added to the shape key: "myopic_chunk" (without the
    chunk length, the JAX key's second element, which the port's program of
    one iteration does not depend on), and the non-myopic loop's
    "nm_acquire" (the port puts the horizon last), "nm_observe" and
    "nm_fallback"."""
    f, jf = tf.get_function("braninhoo"), jtf.get_function("braninhoo")
    x_init = _x_init(f)
    kw = dict(budget=3, num_starts=4, x_init=x_init, steps_per_call=2)
    ours = _keys(bo, lambda: bo.run_myopic_bo(f, dr.EI(), device="cpu", **kw))
    theirs = _keys(jbo, lambda: jbo.run_myopic_bo(jf, jdr.EI(), dtype=jnp.float64, **kw))
    jkey = _normal(theirs["myopic_chunk"][0], jf)
    assert jkey[1] == 2
    assert _normal(ours["myopic_chunk"][0], f) == jkey[:1] + jkey[2:]
    kw = dict(horizon=1, mc_iters=4, budget=2, num_starts=4, num_restarts=2, sgd_iters=2,
              x_init=x_init, outer_solver="batch", deterministic=False)
    ours = _keys(bo, lambda: bo.run_nonmyopic_bo(f, device="cpu", **kw))
    theirs = _keys(jbo, lambda: jbo.run_nonmyopic_bo(jf, dtype=jnp.float64, **kw))
    assert set(ours) == set(theirs) == {"nm_acquire", "nm_observe", "nm_fallback"}
    for name in ("nm_observe", "nm_fallback"):
        assert _normal(ours[name][0], f) == _normal(theirs[name][0], jf), name
    acq = _normal(ours["nm_acquire"][0], f)
    assert acq[:3] + acq[-1:] + acq[3:-1] == _normal(theirs["nm_acquire"][0], jf)


@pytest.mark.parametrize("do_mle", [True, False])
def test_observe_program_matches_the_jax_observe(do_mle):
    """Each package's own observe program (taken from its cache's builder)
    on the same numpy state, float64: the new observation and every field
    of the state to 1e-10."""
    f, jf = tf.get_function("braninhoo"), jtf.get_function("braninhoo")
    x_init = _x_init(f, n=6)
    kw = dict(horizon=1, mc_iters=4, budget=4, num_starts=4, num_restarts=2, sgd_iters=2,
              x_init=x_init)
    observe = _keys(bo, lambda: bo.run_nonmyopic_bo(f, device="cpu", **kw))["nm_observe"][1]()
    jobserve = _keys(jbo, lambda: jbo.run_nonmyopic_bo(jf, dtype=jnp.float64, **kw)
                     )["nm_observe"][1]()
    jst = jsg.fit(jK.matern52((0.9,)), x_init, np.asarray(jf.batch(x_init)), capacity=10,
                  noise=1e-6, dtype=jnp.float64)
    fields = {name: np.asarray(getattr(jst, name)) for name in
              ("X", "y", "L", "Li", "c", "n", "noise")}
    st = sg.from_numpy_state("matern52", np.asarray(jst.kernel.theta), device="cpu",
                             dtype=f64, **fields)
    xnext = np.array([1.25, 7.5])
    jout, jy = jobserve(jst, jnp.asarray(xnext), jnp.asarray(do_mle))
    out, y = observe(st, torch.tensor(xnext, dtype=f64), do_mle)
    np.testing.assert_allclose(float(y), float(jy), rtol=1e-10)
    ours = _state_fields(out)
    for name in ("X", "y", "L", "Li", "c", "theta"):
        theirs = np.asarray(jout.kernel.theta if name == "theta" else getattr(jout, name))
        np.testing.assert_allclose(ours[name], theirs, rtol=1e-10, atol=1e-10, err_msg=name)
    assert int(ours["n"]) == int(jout.n) == 7
    assert (float(out.kernel.theta[0]) != 0.9) == do_mle


def _calls(monkeypatch):
    """Every GraphProgram call, by program."""
    called = []
    call = graphs.GraphProgram.__call__
    monkeypatch.setattr(graphs.GraphProgram, "__call__",
                        lambda self, *a: called.append(self) or call(self, *a))
    return called


def _eager(monkeypatch):
    acquirer = bo._rollout_acquirer
    monkeypatch.setattr(bo, "_rollout_acquirer",
                        lambda *a, **kw: acquirer(*a, **dict(kw, program_key=None)))


@pytest.mark.parametrize("loop,solver", [("nonmyopic", "batch"), ("nonmyopic", "ghq"),
                                         ("adaptive", "ghq")])
def test_acquisition_observe_and_fallback_programs_equal_the_eager_loop(monkeypatch, loop,
                                                                        solver):
    """A trial (h 1, budget 2) whose acquisitions are the batch solver's or
    the Gauss-Hermite one's: each comes from the program cache
    (`_FusedSGAProgram` / `_DeterministicProgram`), the observe program runs
    once per BO iteration, and the trial equals the eager loop's; a second
    trial reuses every program. Then with the rollout value forced to zero
    every iteration runs the fallback's program."""
    f = tf.get_function("sixhump")
    kw = dict(horizon=1, mc_iters=6, budget=2, num_starts=4, num_restarts=2, sgd_iters=3,
              lr=0.05, solver_iterations=4, device="cpu", ghq_nodes=3,
              deterministic=solver == "ghq",
              x_init=np.random.default_rng(4).uniform(f.lbs, f.ubs, (4, f.dim)))
    if loop == "nonmyopic":
        run = lambda: bo.run_nonmyopic_bo(  # noqa: E731
            f, outer_solver="batch" if solver == "batch" else "fused", **kw)
    else:
        run = lambda: bo.run_adaptive_bo(f, **kw)  # noqa: E731
    with monkeypatch.context() as m:
        called = _calls(m)
        res = run()
    programs = dict(graphs.PROGRAM_CACHE)
    acquire = "nm_acquire" if loop == "nonmyopic" else "ad_acquire"
    assert {k[0] for k in programs} == {acquire, "nm_observe", "nm_fallback"}
    kind = outer._FusedSGAProgram if solver == "batch" else outer._DeterministicProgram
    acquisitions = [p for k, p in programs.items() if k[0] == acquire]
    assert all(isinstance(p, kind) for p in acquisitions)
    assert len(acquisitions) == (1 if loop == "nonmyopic" else 2)      # h 0 and 1
    (observe,) = [p for k, p in programs.items() if k[0] == "nm_observe"]
    assert called.count(observe) == 2
    assert res.sga_iterations.tolist() == [-1, -1]
    with monkeypatch.context() as m:
        _eager(m)
        eager = run()
    assert dict(graphs.PROGRAM_CACHE) == programs
    np.testing.assert_array_equal(res.X, eager.X)
    np.testing.assert_array_equal(res.fallbacks, eager.fallbacks)
    assert torch.equal(res.state.kernel.theta, eager.state.kernel.theta)
    again = run()
    assert dict(graphs.PROGRAM_CACHE) == programs
    np.testing.assert_array_equal(again.X, res.X)

    flat = lambda state, rnstream, restarts, h: (  # noqa: E731
        restarts[0], torch.zeros((), dtype=f64), -1)
    monkeypatch.setattr(bo, "_rollout_acquirer", lambda *a, **k: flat)
    called = _calls(monkeypatch)
    forced = run()
    (fallback,) = [p for k, p in graphs.PROGRAM_CACHE.items() if k[0] == "nm_fallback"]
    assert forced.fallbacks.all() and called.count(fallback) == 2
