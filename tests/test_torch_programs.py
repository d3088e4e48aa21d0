"""PyTorch port: the compiled SGA programs (`outer.make_batched_grad_step`,
`make_batched_sga_step`, `make_scanned_sga_program`,
`make_fused_sga_program`), the solvers' `program=` / `sga_step=`
arguments and `bo._cached_program`, against the JAX package on the CPU.

On the CPU a program (`utils.graphs.GraphProgram`) calls its function
eagerly, so these tests hold the programs' control flow and arithmetic;
tests/test_torch_cuda.py holds their CUDA graphs to the eager route on the
card. The problem is tests/test_adaptive.py's (sixhump, 4 observations,
3 restarts, 6 trajectories, h 1) in float64, the same numpy inputs handed
to both packages, at the tolerance of the JAX package's
`test_fused_matches_stepped` (rtol 1e-6, atol 1e-8). A program route and
the eager route run the same torch ops on the CPU: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTP
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns as tf
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.rollout import bo, outer
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams
from rollout_bo_tpu_torch.utils import graphs

# The tensors here are tiny: one intra-op thread (see tests/test_torch_bo.py).
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-8)
SOLVE = dict(lr=0.05, inner_iterations=4)   # and max_iters 5, a window of 2


def _t(a):
    return torch.tensor(np.asarray(a, float), dtype=torch.float64)


@pytest.fixture(scope="module")
def problem():
    """(JAX state, its TrajectoryParams, xstarts, starts), (the port's four)."""
    f = jtf.get_function("sixhump")
    X = qmc.randsample(4, f.dim, f.lbs, f.ubs, np.random.default_rng(0))
    y = np.array(f.batch(X))
    xstarts = qmc.generate_initial_guesses(4, f.lbs, f.ubs)
    starts = qmc.generate_batch(3, f.lbs, f.ubs)[:3]
    z = qmc.gen_low_discrepancy_sequence(6, f.dim, 2)
    jst = jsg.fit(jK.matern52((0.7,)), X, y, capacity=12, noise=1e-6)
    jtp = JTP(x0=jnp.zeros(f.dim), theta=jnp.asarray([0.0]), lbs=jnp.asarray(f.lbs),
              ubs=jnp.asarray(f.ubs), rnstream=jnp.asarray(z))
    st = sg.fit(K.matern52((0.7,), device="cpu"), X, y, capacity=12, noise=1e-6,
                device="cpu")
    tp = TrajectoryParams(x0=_t(np.zeros(f.dim)), theta=_t([0.0]), lbs=_t(f.lbs),
                          ubs=_t(f.ubs), rnstream=_t(z))
    return ((jst, jtp, jnp.asarray(xstarts), jnp.asarray(starts)),
            (st, tp, _t(xstarts), _t(starts)))


@pytest.fixture(scope="module")
def jax_program(problem):
    """jax_program(factory): the JAX factory's program on the problem, built
    once per module (its compile is most of this file's time)."""
    (jst, jtp, jxstarts, _), _ = problem
    built = {}

    def get(factory):
        if factory not in built:
            built[factory] = _build(jouter, factory, jst, jtp, jxstarts)
        return built[factory]

    return get


def _build(pkg, factory, st, tp, xstarts, **kw):
    """`factory` of package `pkg` (jouter or outer) on the problem."""
    kw = dict(SOLVE, **kw)
    if factory == "make_batched_grad_step":
        kw.pop("lr")
    elif factory == "make_scanned_sga_program":
        kw.setdefault("steps_per_call", 2)
    elif factory == "make_fused_sga_program":
        kw.setdefault("max_iters", 5)
    return getattr(pkg, factory)(st, tp, dr.EI() if pkg is outer else jdr.EI(), xstarts, **kw)


def _carry(pkg, xs):
    if pkg is outer:
        z = torch.zeros(xs.shape[0], dtype=torch.float64)
        return (xs, outer.adam_init(xs), z.bool(), z)
    return (xs, jouter.adam_init(xs), jnp.zeros(xs.shape[0], bool), jnp.zeros(xs.shape[0]))


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree, is_leaf=torch.is_tensor))]


def _close(ours, theirs):
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if a.dtype == bool or b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


def _call_twice(pkg, prog, st, tp, xs):
    """Two calls of a carry program (the second from the first's carry)."""
    carry = prog(st, tp.rnstream, _carry(pkg, xs))
    return carry, prog(st, tp.rnstream, carry)


@pytest.mark.parametrize("factory,select_best", [
    ("make_batched_grad_step", False), ("make_batched_sga_step", False),
    ("make_scanned_sga_program", False), ("make_fused_sga_program", False),
    ("make_fused_sga_program", True)])
def test_factory_matches_jax(problem, jax_program, factory, select_best):
    """Each factory's program against the JAX one of the same name: the
    step programs over two calls, each whole carry (Adam's m, v and step
    count too); the fused program's points and values, or its winner
    (held to the argmax of the JAX program's values, which is what the JAX
    program's select_best takes)."""
    (jst, jtp, _, jstarts), (st, tp, xstarts, starts) = problem
    kw = {"select_best": select_best} if factory == "make_fused_sga_program" else {}
    jprog = jax_program(factory)
    prog = _build(outer, factory, st, tp, xstarts, **kw)
    if factory in ("make_batched_sga_step", "make_scanned_sga_program"):
        _close(_call_twice(outer, prog, st, tp, starts),
               _call_twice(jouter, jprog, jst, jtp, jstarts))
    elif select_best:
        jxs, jvals = jprog(jst, jtp.rnstream, jstarts)
        j = int(jnp.argmax(jvals))
        _close(prog(st, tp.rnstream, starts), (jxs[j], jvals[j]))
    else:
        _close(prog(st, tp.rnstream, starts), jprog(jst, jtp.rnstream, jstarts))
    if factory == "make_fused_sga_program":
        eager = outer.stochastic_solve_fused(st, tp, dr.EI(), xstarts, starts, max_iters=5,
                                             select_best=select_best, **SOLVE)
        assert prog.iterations == eager.iterations
        assert torch.equal(prog(st, tp.rnstream, starts)[0], eager.x)


@pytest.mark.parametrize("solver,factory,arg", [
    ("fused", "make_fused_sga_program", "program"),
    ("scanned", "make_scanned_sga_program", "program"),
    ("stepped", "make_batched_sga_step", "sga_step")])
def test_solver_with_prebuilt_program_matches_jax(problem, jax_program, solver, factory, arg):
    """The solvers given a prebuilt program against the JAX solvers given
    theirs, and against the port's eager loop (no program): equal."""
    (jst, jtp, jxstarts, jstarts), (st, tp, xstarts, starts) = problem
    kw = dict(SOLVE, max_iters=5, **({"sync_every": 2} if solver == "stepped" else {}))
    jres = getattr(jouter, f"stochastic_solve_{solver}")(
        jst, jtp, jdr.EI(), jxstarts, jstarts, **{arg: jax_program(factory)}, **kw)
    solve = getattr(outer, f"stochastic_solve_{solver}")
    res = solve(st, tp, dr.EI(), xstarts, starts,
                **{arg: _build(outer, factory, st, tp, xstarts)}, **kw)
    _close(tuple(res[:2]), jres)
    eager = solve(st, tp, dr.EI(), xstarts, starts, **kw,
                  **({"steps_per_call": 2} if solver == "scanned" else {}))
    assert all(torch.equal(a, b) for a, b in zip(res[:2], eager[:2]))


def test_scanned_program_steps_per_call_overrides_the_argument(problem, jax_program):
    """A program of k = 2 passed with steps_per_call 5: windows of 2 (three
    for max_iters 5), as the JAX solver reads the program's k."""
    (jst, jtp, jxstarts, jstarts), (st, tp, xstarts, starts) = problem
    prog = _build(outer, "make_scanned_sga_program", st, tp, xstarts)
    calls, window = [], prog._fn
    prog._fn = lambda *a: calls.append(1) or window(*a)  # noqa: E731
    xs, vals = outer.stochastic_solve_scanned(st, tp, dr.EI(), xstarts, starts, max_iters=5,
                                              steps_per_call=5, program=prog, **SOLVE)
    assert prog.steps_per_call == 2 and len(calls) == 3
    jxs, jvals = jouter.stochastic_solve_scanned(
        jst, jtp, jdr.EI(), jxstarts, jstarts, max_iters=5, steps_per_call=5,
        program=jax_program("make_scanned_sga_program"), **SOLVE)
    _close((xs, vals), (jxs, jvals))
    ref = outer.stochastic_solve_scanned(st, tp, dr.EI(), xstarts, starts, max_iters=5,
                                         steps_per_call=2, **SOLVE)
    assert torch.equal(xs, ref[0]) and torch.equal(vals, ref[1])
    five = outer.stochastic_solve_scanned(st, tp, dr.EI(), xstarts, starts, max_iters=5,
                                          steps_per_call=5, **SOLVE)
    assert not torch.equal(xs, five[0])


def test_fused_program_refuses_what_it_cannot_run(problem):
    _, (st, tp, xstarts, starts) = problem
    prog = _build(outer, "make_fused_sga_program", st, tp, xstarts, select_best=True)
    for kw in (dict(select_best=False), dict(select_best=True, steps_per_call=2)):
        with pytest.raises(ValueError, match="fused program"):
            outer.stochastic_solve_fused(st, tp, dr.EI(), xstarts, starts, program=prog, **kw)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
def test_adam_update_with_a_step_tensor_matches_jax(dtype, rtol):
    """Five Adam steps from a zero state with the step count a 0-d int32
    tensor, against the JAX update (float32: a few ulps)."""
    rng = np.random.default_rng(3)
    x, grads = rng.standard_normal((3, 4)), rng.standard_normal((5, 3, 4))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    st, tx = outer.adam_init(torch.tensor(x, dtype=dtype)), torch.tensor(x, dtype=dtype)
    jst, jx = jouter.adam_init(jnp.asarray(x, jdt)), jnp.asarray(x, jdt)
    assert st.t.dtype == torch.int32 and st.t.shape == ()
    for g in grads:
        st, tx = outer.adam_update(st, tx, torch.tensor(g, dtype=dtype), lr=0.05)
        jst, jx = jouter.adam_update(jst, jx, jnp.asarray(g, jdt), lr=0.05)
    assert int(st.t) == int(jst.t) == 5 and tx.dtype == dtype
    for a, b in ((tx, jx), (st.m, jst.m), (st.v, jst.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=0.0)


def eager_acquisitions(monkeypatch):
    """The BO loops' acquisitions in the eager loop (no program key), the
    route their programs are held to."""
    acquirer = bo._rollout_acquirer
    monkeypatch.setattr(bo, "_rollout_acquirer",
                        lambda *a, **kw: acquirer(*a, **dict(kw, program_key=None)))


def test_cached_program_is_an_lru_of_64(monkeypatch):
    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())
    built = []

    def builder(i):
        return lambda: built.append(i) or object()

    first = bo._cached_program(0, builder(0))
    bo._cached_program(1, builder(1))
    assert bo._cached_program(0, builder(-1)) is first and built == [0, 1]
    assert list(graphs.PROGRAM_CACHE) == [1, 0]            # a hit moves to the end
    for i in range(2, graphs.PROGRAM_CACHE_MAX + 1):
        bo._cached_program(i, builder(i))
    assert len(graphs.PROGRAM_CACHE) == graphs.PROGRAM_CACHE_MAX == 64
    assert 1 not in graphs.PROGRAM_CACHE and 0 in graphs.PROGRAM_CACHE   # least recent went
    assert bo._cached_program(0, builder(-1)) is first


@pytest.mark.parametrize("loop,outer_solver", [("nonmyopic", "fused"),
                                               ("nonmyopic", "scanned"),
                                               ("adaptive", "fused")])
def test_bo_trial_through_cached_programs_equals_the_eager_loop(monkeypatch, loop,
                                                               outer_solver):
    """A trial (h 1, budget 2) with its acquisitions from the program
    cache equals the trial in the eager loop; its observe step and
    fallback come from the cache as well; a second trial reuses the
    programs (no new cache entry, no new build)."""
    monkeypatch.setattr(graphs, "PROGRAM_CACHE", type(graphs.PROGRAM_CACHE)())
    f = tf.get_function("sixhump")
    kw = dict(horizon=1, mc_iters=6, budget=2, num_starts=4, num_restarts=2, sgd_iters=3,
              lr=0.05, solver_iterations=4, device="cpu",
              x_init=np.random.default_rng(4).uniform(f.lbs, f.ubs, (4, f.dim)))
    if loop == "nonmyopic":
        run = lambda **k: bo.run_nonmyopic_bo(f, outer_solver=outer_solver,  # noqa: E731
                                              steps_per_call=2, **kw, **k)
    else:
        run = lambda **k: bo.run_adaptive_bo(f, **kw, **k)  # noqa: E731
    res = run()
    programs = dict(graphs.PROGRAM_CACHE)
    acquire = "nm_acquire" if loop == "nonmyopic" else "ad_acquire"
    acquisitions = {k: p for k, p in programs.items() if k[0] == acquire}
    # one program per horizon: the adaptive schedule alternates h 0 and 1
    assert [k[-1] for k in acquisitions] == ([1] if loop == "nonmyopic" else [0, 1])
    # the observe step and the exploration fallback come from the cache too
    assert {k[0] for k in programs} == {acquire, "nm_observe", "nm_fallback"}
    assert all(isinstance(p, outer._ScannedSGAProgram if outer_solver == "scanned"
                          else outer._FusedSGAProgram) for p in acquisitions.values())
    with monkeypatch.context() as m:
        eager_acquisitions(m)
        eager = run()
    assert dict(graphs.PROGRAM_CACHE) == programs
    np.testing.assert_array_equal(res.X, eager.X)
    np.testing.assert_array_equal(res.sga_iterations, eager.sga_iterations)
    np.testing.assert_array_equal(res.fallbacks, eager.fallbacks)
    again = run()
    assert dict(graphs.PROGRAM_CACHE) == programs
    np.testing.assert_array_equal(again.X, res.X)


def test_graph_program_structures_and_refusals():
    """The argument structures a program takes (a state with its kernel, a
    NamedTuple, a carry with constants) come back whole; on the CPU the
    program is the function; a CUDA program given a CPU tensor raises
    before anything runs (no eager fallback)."""
    st = sg.fit(K.matern52((0.7,), device="cpu"), np.zeros((2, 2)), np.zeros(2),
                capacity=4, device="cpu")
    tree = (st, [torch.ones(2), (None, "EI", 3)], outer.adam_init(torch.ones(2)))
    leaves = []
    spec = graphs._flatten(tree, leaves)
    assert len(leaves) == 12 and hash(spec) == hash(graphs._flatten(tree, []))
    back = graphs._unflatten(spec, iter(leaves))
    assert type(back[0]) is sg.SurrogateState and back[0].kernel.kind == "matern52"
    assert back[0].kernel.theta is st.kernel.theta and back[1][1] == (None, "EI", 3)
    assert type(back[2]) is outer.AdamState and isinstance(back[1], list)
    calls = []
    cpu = graphs.GraphProgram(lambda a, b: calls.append(1) or a + b, device="cpu")
    assert torch.equal(cpu(torch.ones(2), torch.ones(2)), 2 * torch.ones(2)) and calls
    cuda = graphs.GraphProgram(lambda a: calls.append(2) or a, device="cuda")
    with pytest.raises(ValueError, match="got a tensor on cpu"):
        cuda(torch.ones(2))
    assert 2 not in calls


def test_lane_arguments_are_made_on_the_device():
    """Numbers become device fills and tensors device conversions (neither
    copies from the host inside a capture); arrays are copied."""
    cpu = torch.device("cpu")
    t = nl._on_device(1.0, torch.float32, cpu)
    assert t.shape == () and t.dtype == torch.float32 and float(t) == 1.0
    x = torch.arange(3, dtype=torch.float64)
    assert torch.equal(nl._on_device(x, torch.float64, cpu), x)
    assert nl._on_device([0.5, 2.0], torch.float32, cpu).tolist() == [0.5, 2.0]
