"""PyTorch port, the sharded programs: the mesh routes of the SGA,
Gauss-Hermite and simulate programs against the eager mesh route and the
JAX package's sharded functions.

The ranks are processes of their own (gloo on the CPU, `tests/torch_parallel_ranks.py`),
started once for the module: two ranks at meshes (2, 1) and (1, 2), four
at (2, 2). On the CPU a program calls its functions eagerly, so what runs
here is the program route's code (the factories' `mesh=`, the blocks each
program takes, the collectives of its steps, the gather of its final
pass), not a CUDA graph; `tests/test_torch_cuda.py` and `chip_smoke.py`
phase 10 replay the graphs on an NCCL group. Everything is float64.
Tolerances:
- the program route against the eager mesh route on the same ranks: rtol
  1e-12, atol 1e-15 (the same step functions and collectives);
- against the JAX package's sharded functions on the same numpy problem:
  the solves within `SOLVE_TOL` of `tests/test_torch_parallel.py` with the
  same winner, `sharded_simulate_mc` within rtol 1e-6 (that file says why
  the port's unsharded estimate is itself that far from JAX's on this
  ill-conditioned problem);
- the BO loop on a (1, 2) mesh through its cached programs against the
  JAX loop on the same mesh: points within 1e-6 of the box width.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.parallel import mesh as jmesh
from rollout_bo_tpu.parallel import sharded as jsh
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.rollout import outer
from test_torch_parallel import LOOP, SCANNED_KW, SOLVE_TOL, _cli_x_init, _problem

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))

SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
SIM_KW = dict(iterations=15)
BATCH_KW = dict(max_iters=3, inner_iterations=10)
FUSED_KW = dict(max_iters=4, inner_iterations=10)
GHQ_KW = dict(horizon=1, num_nodes=4, max_iters=3, inner_iterations=10)
KINDS = ("simulate", "batch", "fused", "scanned", "ghq")


def _problems():
    return dict(simulate=_problem(16, n_guesses=6), batch=_problem(4, n_starts=8),
                fused=_problem(16, n_starts=8), scanned=_problem(16, n_starts=8),
                ghq=_problem(4, n_starts=8))


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _kw(kind):
    return dict(simulate=SIM_KW, batch=BATCH_KW, fused=FUSED_KW, scanned=SCANNED_KW,
                ghq=GHQ_KW)[kind]


def _jax_ref(kind, path):
    """One JAX reference, saved to `path`: a sharded function on a (2, 2)
    mesh of the virtual CPU devices (the Gauss-Hermite solve as the JAX
    loop runs it on a mesh: its restarts placed along 'restarts',
    `deterministic_solve_batch` jitted), or ("bo") the JAX loop on a
    ('restarts' = 1, 'mc' = 2) mesh."""
    if kind == "bo":
        f = jtf.gramacylee()
        mesh = jmesh.make_mesh(jax.devices()[:2], restarts=1, mc=2)
        res = jbo.run_nonmyopic_bo(f, dtype=jnp.float64, mesh=mesh, x_init=_cli_x_init(f),
                                   **LOOP)
        np.savez(path, X=res.X, y=res.y)
        return
    mesh = jmesh.make_mesh(jax.devices()[:4], restarts=2, mc=2)
    st, tp, xs, starts, _ = _problems()[kind]
    kw = _kw(kind)
    if kind == "simulate":
        eto = jsh.sharded_simulate_mc(st, tp, jdr.EI(), xs, mesh, **kw)
        out = [eto.mu, eto.std_mu, eto.grad_x, eto.std_grad_x]
    elif kind == "ghq":
        ghq = jax.jit(lambda s, r: jouter.deterministic_solve_batch(
            s, tp.theta, tp.lbs, tp.ubs, xs, r, jdr.EI(), **kw))
        out = ghq(jmesh.replicate(st, mesh),
                  jmesh.shard_leading(jnp.asarray(starts), mesh, "restarts"))
    else:
        fn = dict(batch=jsh.sharded_stochastic_solve_batch,
                  fused=jsh.sharded_stochastic_solve_fused,
                  scanned=jsh.sharded_stochastic_solve_scanned)[kind]
        out = fn(st, tp, jdr.EI(), xs, starts, mesh, **kw)
    np.savez(path, *[np.asarray(a) for a in out])


@pytest.fixture(scope="module")
def launched(problems, tmp_path_factory):
    """Started at once, all in the background: two and four ranks, each
    running every kind at its mesh shapes, the two ranks also the BO loop
    on a (1, 2) mesh and the refusals; and one process per JAX reference
    (`_jax_ref`: each traces for 15-50 s, so they run side by side)."""
    tmp = tmp_path_factory.mktemp("sharded-programs")
    handles = {}
    for world, shapes in SHAPES.items():
        solves = {f"{kind}_{r}x{m}": (kind, (r, m), problems[kind][4], _kw(kind))
                  for kind in KINDS for r, m in shapes}
        parts = [("sharded_programs_case", dict(problems=solves))]
        if world == 2:
            f = jtf.gramacylee()
            parts += [("bo_program_case", dict(name="gramacylee", restarts=1, mc=2,
                                               kw=dict(LOOP, x_init=_cli_x_init(f)))),
                      ("program_mesh_error_case", dict(problem=problems["fused"][4])),
                      ("batch_problems_case", dict(problem=problems["batch"][4],
                                                   kw=BATCH_KW))]
        handles[world] = ranks.Ranks(ranks.combined, world, str(tmp), parts=parts)
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import conftest, "
            "test_torch_sharded_programs as m; m._jax_ref(sys.argv[1], sys.argv[2])"
            ).format(TESTS, os.path.dirname(TESTS))
    refs = {kind: (tmp / f"jax-{kind}.npz", subprocess.Popen(
        [sys.executable, "-c", code, kind, str(tmp / f"jax-{kind}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for kind in KINDS + ("bo",)}
    yield dict(ranks=handles, refs=refs)
    for h in handles.values():
        h.stop()
    for _, proc in refs.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def results(launched):
    out = {}
    for h in launched["ranks"].values():
        out.update(h.result())
    return out


@pytest.fixture(scope="module")
def jax_refs(launched):
    refs = {}
    for kind, (path, proc) in launched["refs"].items():
        printed = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"JAX reference {kind}:\n{printed}"
        with np.load(path) as z:
            refs[kind] = dict(z) if kind == "bo" else [z[f"arr_{i}"] for i in range(len(z))]
    return refs


CASES = [f"{kind}_{r}x{m}" for kind in KINDS for shapes in SHAPES.values()
         for r, m in shapes]


@pytest.mark.parametrize("name", CASES)
def test_program_route_equals_the_eager_mesh_route(results, name):
    outputs = sorted(k for k in results if k.startswith(f"{name}_prog"))
    assert len(outputs) == (6 if name.startswith("simulate") else 2)
    for key in outputs:
        np.testing.assert_allclose(results[key], results[key.replace("_prog", "_eager")],
                                   rtol=1e-12, atol=1e-15, err_msg=key)
    assert int(results[f"{name}_it"]) == int(results[f"{name}_eager_it"])
    # the CPU route launches no kernel (the card tests and chip_smoke.py hold
    # the per-rank identity h x (SGA iterations + 1))
    assert set(results[f"{name}_launches"].tolist()) == {0}


@pytest.mark.parametrize("name", CASES)
def test_program_route_matches_the_jax_sharded_functions(results, jax_refs, name):
    kind = name.split("_")[0]
    ref = jax_refs[kind]
    if kind == "simulate":
        for i, r in enumerate(ref):
            np.testing.assert_allclose(results[f"{name}_prog{i}"], r, rtol=1e-6, atol=0.0,
                                       err_msg=f"{name} output {i}")
        return
    xs, vals = results[f"{name}_prog0"], results[f"{name}_prog1"]
    np.testing.assert_allclose(xs, ref[0], **SOLVE_TOL["x"])
    np.testing.assert_allclose(vals, ref[1], **SOLVE_TOL["v"])
    assert int(vals.argmax()) == int(ref[1].argmax())
    if kind == "fused":
        assert 1 <= int(results[f"{name}_it"]) <= FUSED_KW["max_iters"]


def test_mesh_loop_takes_its_acquisitions_from_the_program_cache(results, jax_refs):
    keys = [k for k in results["keys"].tolist() if k.startswith("('nm_acquire'")]
    assert len(set(keys)) == 1 and len(keys) == LOOP["budget"]
    assert "('mesh', 1, 2, 'gloo')" in keys[0]
    assert int(results["programs_run"]) == LOOP["budget"]
    f = jtf.gramacylee()
    width = float(np.max(f.ubs - f.lbs))
    np.testing.assert_allclose(results["X"], jax_refs["bo"]["X"], rtol=0.0, atol=1e-6 * width)
    np.testing.assert_allclose(results["y"], jax_refs["bo"]["y"], rtol=1e-6, atol=1e-8)
    assert all(1 <= it <= LOOP["sgd_iters"] for it in results["sga_iterations"])


def test_the_batch_program_takes_the_problem_as_an_input(results):
    """Two batch solves whose theta, box and inner starts differ share one
    cached program, and each equals the eager mesh route on its own
    problem."""
    assert int(results["batch_programs"]) == 1
    for name in ("first", "second"):
        for i in range(2):
            key = f"batch_{name}_prog{i}"
            np.testing.assert_allclose(results[key], results[key.replace("_prog", "_eager")],
                                       rtol=1e-12, atol=1e-15, err_msg=key)
    assert not np.array_equal(results["batch_first_prog1"], results["batch_second_prog1"])


def test_a_mesh_solve_refuses_a_program_of_another_mesh(results):
    for key in ("fused_no_mesh", "scanned_no_mesh"):
        assert "a program built for mesh None cannot solve on mesh Mesh(restarts=2" in str(
            results[key]), key
    assert "cannot solve on mesh None" in str(results["fused_one_device"])


def test_a_gloo_mesh_on_the_card_takes_the_eager_route_by_rule():
    """No graph can hold a gloo collective: on CUDA tensors a gloo mesh runs
    eagerly and a program asked for on it raises, naming --backend nccl;
    elsewhere (the CPU, an NCCL mesh, no mesh) the programs run."""
    gloo, nccl = mesh_mod.Mesh(2, 1, 0, "gloo"), mesh_mod.Mesh(2, 1, 0, "nccl")
    assert not gloo.capturable and nccl.capturable and mesh_mod.Mesh(1, 1, 0).capturable
    assert not mesh_mod.programs_run_on(gloo, "cuda")
    assert mesh_mod.programs_run_on(gloo, "cpu") and mesh_mod.programs_run_on(nccl, "cuda")
    assert mesh_mod.programs_run_on(None, "cuda")
    with pytest.raises(ValueError, match="--backend nccl"):
        outer._program_mesh(gloo, torch.device("cuda", 0))
    assert outer._program_mesh(gloo, torch.device("cpu")) == (None, 1)
    # equal meshes share cached programs: equality is shape, rank and backend
    assert gloo == mesh_mod.Mesh(2, 1, 0, "gloo", {"mc": object()}) and gloo != nccl
