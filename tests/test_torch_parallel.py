"""PyTorch port, the multi-GPU layer (`parallel/`) against the JAX package.

The ranks are processes of their own, joined by torch.distributed with
gloo on the CPU; they run `tests/torch_parallel_ranks.py`, which imports no
jax, and meet through `file://` stores under tmp_path (no port is bound,
so parallel test workers cannot collide). The JAX side runs in this
process on its virtual CPU devices. Everything is float64. Tolerances:
- `sharded_simulate_mc` against JAX's unsharded `simulate_trajectory_mc`:
  rtol 1e-6, the JAX sharded test's own. On this problem (6 points at
  lengthscale 0.3, noise 1e-6: K is ill-conditioned) the port's unsharded
  estimate itself is 1.6e-10 (mu) to 4.0e-7 (grad_theta) from JAX's: the
  same L^{-1} form of the inner solve in another order of operations,
  which the IFT gradient amplifies by the inner Newton system's
  conditioning; what the
  sharding adds is held apart: equal to the port's unsharded estimate to
  1e-12 (the cross-rank sums only reorder additions);
- the sharded solves: the JAX tests' own tolerances (points rtol 1e-6,
  atol 1e-8; values rtol 1e-6, atol 1e-10) and the same winner index, and
  equal to the port's unsharded solve to 1e-12;
- the BO loop and the CLI on a 2-rank mesh against the JAX loop on a
  2-device mesh: points within 1e-6 of the box width.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as ranks
from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.models import testfns as jtf
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.parallel import mesh as jmesh
from rollout_bo_tpu.parallel import multihost_worker as jmw
from rollout_bo_tpu.rollout import bo as jbo
from rollout_bo_tpu.rollout import mc as jmc
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTP
from rollout_bo_tpu_torch.experiments import nonmyopic
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.parallel import multihost_worker as mw
from rollout_bo_tpu_torch.utils import logging as log

# The tensors here are tiny: one intra-op thread (the ranks set the same).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE_TOL = dict(x=dict(rtol=1e-6, atol=1e-8), v=dict(rtol=1e-6, atol=1e-10))
# the scanned solve: 3 iterations in windows of 2, so 4 run unless all stop
SCANNED_KW = dict(max_iters=3, steps_per_call=2, inner_iterations=10)
# the trial of the BO-loop and CLI tests, in the CLI's flags and as loop keywords
CLI = ["--function-name", "gramacylee", "--budget", "3", "--trials", "1", "--starts", "4",
       "--mc-samples", "4", "--horizon", "1", "--batch-size", "2", "--sgd-iterations", "3",
       "--variance-reduction", "--optimize", "--seed", "5"]
LOOP = dict(horizon=1, mc_iters=4, budget=3, n_init=5, num_starts=4, num_restarts=2,
            sgd_iters=3, seed=5, mle_every=1, use_low_discrepancy=True)


def _problem(M, h=1, n_starts=8, n_guesses=4):
    """test_outer_and_parallel.py's problem (a 1-d GP of 6 observations,
    capacity 12, x0 = 0.52): the JAX state and stream, and the same as
    numpy arrays for the ranks."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0.0, 1.0, size=(6, 1)), axis=0)
    y = np.sin(6 * X[:, 0]) + 0.3 * X[:, 0]
    st = jsg.fit(jK.matern52((0.3,)), X, y, capacity=12, noise=1e-6)
    z = np.random.default_rng(3).normal(size=(M, 2, h + 1))
    xstarts = qmc.generate_initial_guesses(n_guesses, [0.0], [1.0])
    starts = np.linspace(0.1, 0.9, n_starts)[:, None]
    tp = JTP(x0=jnp.asarray([0.52]), theta=jnp.asarray([0.0]), lbs=jnp.asarray([0.0]),
             ubs=jnp.asarray([1.0]), rnstream=jnp.asarray(z))
    fields = {f: np.asarray(getattr(st, f)) for f in ("X", "y", "L", "Li", "c", "n", "noise")}
    fields.update(kind="matern52", theta=np.asarray(st.kernel.theta), x0=[0.52],
                  theta_rule=[0.0], lbs=[0.0], ubs=[1.0], z=z, xstarts=xstarts, starts=starts)
    return st, tp, jnp.asarray(xstarts), starts, fields


def _cli_x_init(f, seed=5, n=5):
    """The CLI's initial design of its first trial."""
    rng = np.random.default_rng(seed)
    return np.asarray(f.lbs) + (np.asarray(f.ubs) - np.asarray(f.lbs)) \
        * rng.uniform(size=(n, f.dim))


@pytest.fixture(scope="module")
def problems():
    # "fused" is the worker's problem (jmw.build_problem): one JAX program
    # serves the (2, 2) mesh and the two-process worker
    return dict(sim=_problem(16, n_guesses=6), batch=_problem(4, n_starts=8),
                fused=_problem(16, n_starts=8))


@pytest.fixture(scope="module")
def launched(problems, tmp_path_factory):
    """The ranks and the worker processes, started before the JAX side
    compiles (they run meanwhile):
    - four ranks: sharded_simulate_mc at (1, 4), sharded_stochastic_solve_batch
      at (4, 1), sharded_stochastic_solve_fused and _scanned at (2, 2);
    - two ranks: sharded_simulate_mc at (1, 2), the non-myopic BO loop on a
      (2, 1) mesh, and the errors of the mesh;
    - the worker, two processes launched as `python -m`."""
    tmp = tmp_path_factory.mktemp("ranks")
    solves = dict(batch=("batch", (4, 1), problems["batch"][4],
                         dict(max_iters=3, inner_iterations=10)),
                  fused=("fused", (2, 2), problems["fused"][4], dict(jmw.SOLVE_KW)),
                  scanned=("scanned", (2, 2), problems["fused"][4], dict(SCANNED_KW)))
    sim = problems["sim"][4]
    f = jtf.gramacylee()
    handles = dict(
        world4=ranks.Ranks(ranks.combined, 4, str(tmp), parts=[
            ("simulate_case", dict(problem=sim, meshes=[(1, 4)], iterations=15)),
            ("solve_case", dict(problems=solves))]),
        world2=ranks.Ranks(ranks.combined, 2, str(tmp), parts=[
            ("simulate_case", dict(problem=sim, meshes=[(1, 2)], iterations=15)),
            ("bo_case", dict(name="gramacylee", restarts=2,
                             kw=dict(LOOP, x_init=_cli_x_init(f)))),
            ("mesh_error_case", {})]))
    out, init = tmp / "p0.npz", f"file://{tmp / 'worker-store'}"
    workers = [subprocess.Popen(
        [sys.executable, "-m", "rollout_bo_tpu_torch.parallel.multihost_worker",
         "--process-id", str(i), "--num-processes", "2", "--port", "0", "--backend", "gloo",
         "--device", "cpu", "--init-method", init] + (["--out", str(out)] if i == 0 else []),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    yield dict(handles, solves=solves, workers=workers, worker_out=out)
    for h in handles.values():
        h.stop()
    for w in workers:
        w.kill()
        w.communicate()


@pytest.fixture(scope="module")
def world4(launched):
    return launched["world4"].result()


@pytest.fixture(scope="module")
def world2(launched):
    return launched["world2"].result()


@pytest.fixture(scope="module")
def jax_refs(problems):
    """The JAX package's unsharded results on the same problems."""
    st, tp, xs, _, _ = problems["sim"]
    sim = jax.jit(lambda s, t: jmc.simulate_trajectory_mc(s, t, jdr.EI(), xs, iterations=15))
    st_b, tp_b, xs_b, starts_b, _ = problems["batch"]
    batch = jax.jit(lambda s, t, r: jouter.stochastic_solve_batch(
        s, t, jdr.EI(), xs_b, r, max_iters=3, inner_iterations=10))
    st_f, tp_f, xs_f, starts_f, _ = problems["fused"]
    fused = jouter.make_fused_sga_program(st_f, tp_f, jdr.EI(), xs_f, **jmw.SOLVE_KW)
    scanned = jouter.stochastic_solve_scanned(st_f, tp_f, jdr.EI(), xs_f,
                                              jnp.asarray(starts_f), **SCANNED_KW)
    return dict(sim=sim(st, tp), batch=batch(st_b, tp_b, jnp.asarray(starts_b)),
                fused=fused(st_f, tp_f.rnstream, jnp.asarray(starts_f)), scanned=scanned)


@pytest.fixture(scope="module")
def jax_bo():
    """The JAX loop on a 2-device ('restarts' = 2, 'mc' = 1) mesh."""
    f = jtf.gramacylee()
    mesh = jmesh.make_mesh(jax.devices()[:2], restarts=2, mc=1)
    return jbo.run_nonmyopic_bo(f, dtype=jnp.float64, mesh=mesh, x_init=_cli_x_init(f),
                                **LOOP)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_sharded_simulate_mc_matches_jax(launched, problems, jax_refs, world2, world4, shape):
    out = world2 if shape == "1x2" else world4
    ref = jax_refs["sim"]
    for f in ("mu", "std_mu", "grad_x", "std_grad_x"):
        np.testing.assert_allclose(out[f"{f}_{shape}"], np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=0.0, err_msg=f)
    _, tp, _, _, p = problems["sim"]
    st, tpp, xs, _ = ranks.port_problem(p)
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.rollout import mc
    mine = mc.simulate_trajectory_mc(st, tpp, dr.EI(), xs, iterations=15)
    for f in ("mu", "std_mu", "grad_x", "std_grad_x", "grad_theta", "std_grad_theta"):
        np.testing.assert_allclose(out[f"{f}_{shape}"], getattr(mine, f).numpy(),
                                   rtol=1e-12, atol=1e-15, err_msg=f)


@pytest.mark.parametrize("name", ["batch", "fused", "scanned"])
def test_sharded_solves_match_jax_and_unsharded(launched, jax_refs, world4, name):
    out = world4
    kind, _, p, kw = launched["solves"][name]
    xs_ref, vals_ref = (np.asarray(a) for a in jax_refs[name])
    xs, vals = out[f"{name}_xs"], out[f"{name}_vals"]
    np.testing.assert_allclose(xs, xs_ref, **SOLVE_TOL["x"])
    np.testing.assert_allclose(vals, vals_ref, **SOLVE_TOL["v"])
    assert int(vals.argmax()) == int(vals_ref.argmax())
    mine = ranks.unsharded_solve(kind, p, kw)
    np.testing.assert_allclose(xs, mine[0].numpy(), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(vals, mine[1].numpy(), rtol=1e-12, atol=1e-15)
    if kind == "fused":
        # the CPU route launches no kernel on any rank (the card tests and
        # chip_smoke.py hold the per-rank identity h x (iterations + 1))
        assert 1 <= int(out["fused_it"]) <= kw["max_iters"]
        assert out["fused_launches"].tolist() == [0] * 4


def test_stochastic_solve_matches_jax_rows(problems, jax_refs):
    """`stochastic_solve` from each start is the row of JAX's
    `stochastic_solve_batch` (a vmap of its `stochastic_solve`) for it."""
    from rollout_bo_tpu_torch.models import decision_rules as dr
    from rollout_bo_tpu_torch.rollout import outer

    xs_ref, vals_ref = (np.asarray(a) for a in jax_refs["batch"])
    st, tp, xstarts, starts = ranks.port_problem(problems["batch"][4])
    for j in range(starts.shape[0]):
        x, eto = outer.stochastic_solve(st, tp, dr.EI(), xstarts, starts[j], max_iters=3,
                                        inner_iterations=10)
        assert x.shape == (1,) and eto.mu.shape == () and eto.grad_x.shape == (1,)
        np.testing.assert_allclose(x.numpy(), xs_ref[j], **SOLVE_TOL["x"])
        np.testing.assert_allclose(eto.mu.numpy(), vals_ref[j], **SOLVE_TOL["v"])


def test_run_nonmyopic_bo_on_a_mesh_matches_jax(world2, jax_bo):
    f = jtf.gramacylee()
    width = float(np.max(f.ubs - f.lbs))
    np.testing.assert_allclose(world2["X"], jax_bo.X, rtol=0.0, atol=1e-6 * width)
    np.testing.assert_allclose(world2["y"], jax_bo.y, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(world2["theta"], np.asarray(jax_bo.state.kernel.theta),
                               rtol=1e-5)
    assert world2["X"].shape == (5 + LOOP["budget"], 1)
    assert all(1 <= it <= LOOP["sgd_iters"] for it in world2["sga_iterations"])


def test_nonmyopic_cli_on_two_ranks(tmp_path, capfd, jax_bo):
    out = str(tmp_path / "cli")
    nonmyopic.main(CLI + ["--output-dir", out, "--nworkers", "2", "--backend", "gloo",
                          "--device", "cpu"])
    printed = capfd.readouterr().out
    assert printed.count("trial 1/1: final gap") == 1         # rank 0 alone prints
    assert sorted(os.listdir(out)) == ["gramacylee", "metadata.txt"]   # store removed
    for metric in ("times", "gaps", "observations"):
        rows = log.read_rows(os.path.join(out, "gramacylee", f"rollout_h1_{metric}"))
        assert rows.shape == (1, 3)                           # one writer, one row
    obs = log.read_rows(os.path.join(out, "gramacylee", "rollout_h1_observations"))[0]
    np.testing.assert_allclose(obs, jax_bo.y[-3:], rtol=1e-6, atol=1e-8)


def test_finalize_stops_the_gloo_threads_of_a_cached_mesh(tmp_path):
    """A rank whose program cache still holds a mesh program (a CLI rank
    after its trials) leaves no gloo thread running once it has left its
    group. With them running, a rank could abort in its interpreter's
    teardown (SIGABRT, "terminate called without an active exception"),
    which failed test_nonmyopic_cli_on_two_ranks once in tens of runs."""
    out = str(tmp_path / "threads")
    mp.start_processes(ranks.cached_mesh_rank, args=(2, f"file://{tmp_path / 'store'}", out),
                       nprocs=2, start_method="spawn")
    for rank in range(2):
        with np.load(f"{out}-{rank}.npz") as z:
            assert z["threads"].tolist() == [], rank


def test_two_process_worker_matches_jax(launched, jax_refs):
    outputs = []
    for p in launched["workers"]:
        try:
            outputs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in launched["workers"]:
                q.kill()
            raise
    for i, (p, o) in enumerate(zip(launched["workers"], outputs)):
        assert p.returncode == 0, f"worker {i} failed:\n{o}"
        assert f"[p{i}] processes=2 world=2" in o and f"[p{i}] OK" in o, o
    xs_ref, vals_ref = (np.asarray(a) for a in jax_refs["fused"])
    got = np.load(launched["worker_out"])
    np.testing.assert_allclose(got["xs"], xs_ref, **SOLVE_TOL["x"])
    np.testing.assert_allclose(got["vals"], vals_ref, **SOLVE_TOL["v"])
    assert int(got["vals"].argmax()) == int(vals_ref.argmax())
    assert mw.SOLVE_KW == jmw.SOLVE_KW


def test_worker_build_problem_matches_jax():
    st, tp, xstarts, starts = mw.build_problem(device="cpu")
    jst, jtp, jxstarts, jstarts = jmw.build_problem()
    for f in ("X", "y", "L", "Li", "c"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(tp.rnstream.numpy(), np.asarray(jtp.rnstream))
    np.testing.assert_array_equal(xstarts.numpy(), np.asarray(jxstarts))
    np.testing.assert_array_equal(starts.numpy(), jstarts)


@pytest.mark.parametrize("n", [1, 3])
def test_worker_needs_an_even_world(n):
    with pytest.raises(SystemExit, match="even number of processes"):
        mw.main(["--process-id", "0", "--num-processes", str(n), "--port", "0",
                 "--backend", "gloo", "--device", "cpu"])


def test_mesh_refuses_what_does_not_divide(world2):
    assert "not divisible by restarts=3" in str(world2["mesh"])
    assert "mesh 2x2 != 2 ranks" in str(world2["shape"])
    assert "does not divide over the 2 ranks" in str(world2["shard"])
    # one process, no group
    with pytest.raises(ValueError, match="not divisible by restarts=2"):
        mesh_mod.make_mesh(restarts=2)
    mesh = mesh_mod.Mesh(restarts=2, mc=2, rank=3)
    with pytest.raises(ValueError, match="does not divide over the 2 ranks of mesh axis 'mc'"):
        mesh_mod.shard_leading(torch.zeros(5, 2), mesh, "mc")
    np.testing.assert_array_equal(
        mesh_mod.shard_leading(torch.arange(8.0), mesh, mesh_mod.AXES).numpy(), [6.0, 7.0])
    assert mesh.coordinate("restarts") == (1, 2) and mesh.coordinate("mc") == (1, 2)


def test_one_process_is_a_mesh_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_mod.initialize_distributed(backend="gloo") == 1
    mesh = mesh_mod.make_mesh()
    assert (mesh.restarts, mesh.mc, mesh.rank) == (1, 1, 0) and mesh.group(mesh_mod.AXES) is None
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh_mod.gather_leading(mesh_mod.shard_leading(x, mesh, "restarts"),
                                               mesh, "restarts"), x)
    assert mesh_mod.replicate(x, mesh) is x and mesh_mod.all_reduce_sum(x, mesh) is x


def test_nccl_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="--backend gloo"):
        mesh_mod.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="--backend gloo"):
        mesh_mod.check_backend("nccl", 2, "cpu")
    mesh_mod.check_backend("gloo", 2, "cpu")
    # the CLI refuses before it writes anything or starts a rank
    with pytest.raises(RuntimeError, match="--backend gloo"):
        nonmyopic.main(CLI + ["--output-dir", str(tmp_path / "o"), "--nworkers", "2",
                              "--device", "cpu"])
    assert not (tmp_path / "o").exists()


def test_cli_runs_on_one_device_when_the_ranks_do_not_divide(tmp_path, capsys):
    out = str(tmp_path / "one")
    nonmyopic.main(CLI + ["--output-dir", out, "--nworkers", "3", "--backend", "gloo",
                          "--device", "cpu", "--budget", "1"])
    printed = capsys.readouterr().out
    assert "--nworkers 3 does not divide --batch-size 2: running on one device" in printed
    assert log.read_rows(os.path.join(out, "gramacylee", "rollout_h1_gaps")).shape == (1, 1)
