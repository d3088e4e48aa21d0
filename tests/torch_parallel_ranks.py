"""What each rank runs in tests/test_torch_parallel.py and
tests/test_torch_cuda.py: the port's sharded paths in processes of their
own, joined by torch.distributed. This module imports no jax (the ranks
must not), so the spawned processes import it by name.

`Ranks(case, world, tmp_dir, **kw)` starts `world` ranks of `case` (a
function of this module) in the background; rank 0 saves what the case
returns to an .npz, which `Ranks.result()` loads once all have ended.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models import testfns
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.parallel import mesh as mesh_mod
from rollout_bo_tpu_torch.parallel import sharded
from rollout_bo_tpu_torch.rollout import bo, outer
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams
from rollout_bo_tpu_torch.utils import graphs

f64 = torch.float64


class Ranks:
    """`world` ranks of `case` (a function of this module) started in the
    background, rendezvous through a `file://` store under `tmp_dir`;
    `result()` waits for them and returns what rank 0 saved. A rank that
    fails ends the others and `result()` raises."""

    def __init__(self, case, world, tmp_dir, *, backend="gloo", **kw):
        tag = f"{case.__name__}-{world}-{backend}"
        self.out = os.path.join(tmp_dir, f"{tag}.npz")
        self.context = mp.start_processes(
            _rank, args=(case, world, f"file://{os.path.join(tmp_dir, 'store-' + tag)}",
                         backend, self.out, kw),
            nprocs=world, join=False, start_method="spawn")

    def result(self) -> dict:
        while not self.context.join():
            pass
        with np.load(self.out) as z:
            return dict(z)

    def stop(self) -> None:
        for p in self.context.processes:
            if p.is_alive():
                p.terminate()


def _rank(rank, case, world, init_method, backend, out, kw):
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method, world, rank, backend=backend)
    try:
        results = case(**kw)
        if rank == 0:
            np.savez(out, **{k: np.asarray(v) for k, v in results.items()})
    finally:
        mesh_mod.finalize_distributed()


def held_program_rank(rank, init_method, out):
    """One NCCL rank that leaves its group while it still holds a mesh
    program, whose graphs hold the group's collectives: saves to `out` what
    calling the program after `finalize_distributed` raised ("" if
    nothing). The test that starts it waits for it with a deadline: a
    destroy that waits for the live graphs would hang here."""
    mesh_mod.initialize_distributed(init_method, 1, rank, backend="nccl")
    dev = mesh_mod.rank_device("cuda")
    st, tp, xstarts, starts = port_problem(worker_fields(), dev)
    program = outer.make_fused_sga_program(st, tp, dr.EI(), xstarts, mesh=mesh_mod.make_mesh(),
                                           max_iters=2, inner_iterations=10)
    program(st, tp.rnstream, starts)
    mesh_mod.finalize_distributed()
    try:
        program(st, tp.rnstream, starts)
        raised = ""
    except RuntimeError as e:
        raised = str(e) or type(e).__name__
    np.savez(out, raised=raised)


def _mesh_program(world):
    mesh = mesh_mod.make_mesh(restarts=world, mc=1)
    return lambda: mesh


def cached_mesh_rank(rank, world, init_method, out):
    """A gloo rank that leaves its group while the program cache holds a
    program that holds its mesh, as a CLI rank's cache does after its
    trials: saves to `<out>-<rank>.npz` the names of the gloo threads still
    running once `finalize_distributed` has returned."""
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(init_method, world, rank, backend="gloo")
    graphs.cached_program(("a mesh program", rank), lambda: _mesh_program(world))
    mesh_mod.finalize_distributed()
    names = []
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/comm") as fh:
            names.append(fh.read().strip())
    np.savez(f"{out}-{rank}.npz", threads=np.asarray([n for n in names if "gloo" in n], str))


def port_state(fields, device="cpu", dtype=f64):
    """A port SurrogateState from the numpy fields of a JAX one."""
    return sg.from_numpy_state(fields["kind"], fields["theta"], fields["X"], fields["y"],
                               fields["L"], fields["Li"], fields["c"], fields["n"],
                               fields["noise"], device=device, dtype=dtype)


def port_problem(p, device="cpu", dtype=f64):
    """(state, tp, xstarts, starts) of a problem given as numpy arrays."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    st = port_state(p, device, dtype)
    tp = TrajectoryParams(x0=t(p["x0"]), theta=t(p["theta_rule"]), lbs=t(p["lbs"]),
                          ubs=t(p["ubs"]), rnstream=t(p["z"]))
    return st, tp, t(p["xstarts"]), t(p["starts"])


# --------------------------------------------------------------------------
# cases: each runs on every rank and returns rank 0's results
# --------------------------------------------------------------------------


def combined(parts):
    """Several cases in one group: parts is a list of (case name, keywords)."""
    out = {}
    for name, kw in parts:
        out.update(globals()[name](**kw))
    return out


def simulate_case(problem, meshes, iterations):
    """sharded_simulate_mc on each mesh shape of `meshes`."""
    out = {}
    for restarts, mc in meshes:
        mesh = mesh_mod.make_mesh(restarts=restarts, mc=mc)
        st, tp, xstarts, _ = port_problem(problem)
        eto = sharded.sharded_simulate_mc(st, tp, dr.EI(), xstarts, mesh,
                                          iterations=iterations)
        for f in ("mu", "std_mu", "grad_x", "std_grad_x", "grad_theta", "std_grad_theta"):
            out[f"{f}_{restarts}x{mc}"] = getattr(eto, f).numpy()
    return out


def solve_case(problems, device="cpu", dtype="float64"):
    """Each named problem: (kind, mesh shape, solver keywords); the sharded
    batch, fused or scanned solve, its kernel launches (those of the
    warm-up runs before a capture taken off) and its SGA iterations (-1
    where the solver does not report them)."""
    from rollout_bo_tpu_torch.utils import graphs

    dev, dt = mesh_mod.rank_device(device), getattr(torch, dtype)
    out = {}
    for name, (kind, (restarts, mc), p, kw) in problems.items():
        mesh = mesh_mod.make_mesh(restarts=restarts, mc=mc)
        st, tp, xstarts, starts = port_problem(p, dev, dt)
        before, warm = nl.LAUNCHES, graphs.WARMUP_LAUNCHES
        if kind == "batch":
            xs, vals = sharded.sharded_stochastic_solve_batch(st, tp, dr.EI(), xstarts,
                                                              starts, mesh, **kw)
            it = -1
        elif kind == "scanned":
            xs, vals = sharded.sharded_stochastic_solve_scanned(st, tp, dr.EI(), xstarts,
                                                                starts, mesh, **kw)
            it = -1
        else:
            xs, vals, it = sharded.sharded_stochastic_solve_fused(st, tp, dr.EI(), xstarts,
                                                                  starts, mesh, **kw)
        out[f"{name}_xs"], out[f"{name}_vals"] = xs.cpu().numpy(), vals.cpu().numpy()
        out[f"{name}_it"] = it
        launches = torch.tensor([nl.LAUNCHES - before - (graphs.WARMUP_LAUNCHES - warm)],
                                device=dev)
        out[f"{name}_launches"] = mesh_mod.gather_leading(launches, mesh, mesh_mod.AXES
                                                          ).cpu().numpy()
    return out


def bo_case(name, kw, restarts, mc=1, device="cpu"):
    """run_nonmyopic_bo of test function `name` on a (restarts, mc) mesh."""
    mesh = mesh_mod.make_mesh(restarts=restarts, mc=mc)
    res = bo.run_nonmyopic_bo(testfns.get_function(name), device=mesh_mod.rank_device(device),
                              mesh=mesh, **kw)
    return dict(X=res.X, y=res.y, theta=res.state.kernel.theta.cpu().numpy(),
                sga_iterations=res.sga_iterations, fallbacks=res.fallbacks)


def _program_route(kind, mesh, problem, kw):
    """One sharded solve or simulate call on `mesh` through its program: the
    `parallel.sharded` function (for "ghq", `outer.make_deterministic_program(mesh=)`).
    Returns (outputs, SGA iterations or -1)."""
    st, tp, xstarts, starts = problem
    rule = dr.EI()
    if kind == "simulate":
        eto = sharded.sharded_simulate_mc(st, tp, rule, xstarts, mesh, **kw)
        return [getattr(eto, f) for f in _SIMULATED], -1
    if kind == "ghq":
        program = outer.make_deterministic_program(st, tp.theta, tp.lbs, tp.ubs, xstarts, rule,
                                                   mesh=mesh, **kw)
        return list(program(st, starts)), -1
    if kind == "batch":
        return list(sharded.sharded_stochastic_solve_batch(st, tp, rule, xstarts, starts, mesh,
                                                           **kw)), -1
    if kind == "scanned":
        program = outer.make_scanned_sga_program(
            st, tp, rule, xstarts, mesh=mesh, **{k: v for k, v in kw.items() if k != "max_iters"})
        return list(sharded.sharded_stochastic_solve_scanned(
            st, tp, rule, xstarts, starts, mesh, program=program, **kw)), -1
    program = outer.make_fused_sga_program(st, tp, rule, xstarts, mesh=mesh, **kw)
    fs = sharded.sharded_stochastic_solve_fused(st, tp, rule, xstarts, starts, mesh,
                                                program=program, **kw)
    return [fs.x, fs.value], fs.iterations


def _eager_route(kind, mesh, problem, kw):
    """The same call on the eager mesh route: the same placement through
    the eager functions, with no program. Returns (outputs, SGA iterations
    or -1)."""
    from rollout_bo_tpu_torch.rollout import mc

    st, tp, xstarts, starts = problem
    rule = dr.EI()
    if kind == "simulate":
        rn = mesh_mod.shard_leading(tp.rnstream, mesh, mesh_mod.AXES)
        eto = mc.simulate_trajectory_mc(st, tp._replace(rnstream=rn), rule, xstarts,
                                        group=mesh.group(mesh_mod.AXES), **kw)
        return [getattr(eto, f) for f in _SIMULATED], -1
    if kind == "ghq":
        return list(outer.deterministic_solve_batch(st, tp.theta, tp.lbs, tp.ubs, xstarts,
                                                    starts, rule, mesh=mesh, **kw)), -1
    if kind == "batch":
        return list(outer.stochastic_solve_batch(st, tp, rule, xstarts, starts, mesh=mesh,
                                                 **kw)), -1
    fs = outer.stochastic_solve_fused(st, tp, rule, xstarts, starts, mesh=mesh, **kw)
    return [fs.x, fs.value], -1 if kind == "scanned" else fs.iterations


_SIMULATED = ("mu", "std_mu", "grad_x", "std_grad_x", "grad_theta", "std_grad_theta")


def sharded_programs_case(problems, device="cpu", dtype="float64"):
    """Each named problem: (kind, mesh shape, numpy problem, keywords), with
    kind "simulate", "batch", "scanned", "fused" or "ghq": the program
    route's outputs (`{name}_prog{i}`), the eager mesh route's
    (`{name}_eager{i}`), the SGA iterations of each (-1 where not
    reported) and, per rank, the lane-kernel launches of the program route
    with its graphs' warm-up runs taken off."""
    from rollout_bo_tpu_torch.utils import graphs

    dev, dt = mesh_mod.rank_device(device), getattr(torch, dtype)
    out = {}
    for name, (kind, (restarts, mc), p, kw) in problems.items():
        mesh = mesh_mod.make_mesh(restarts=restarts, mc=mc)
        problem = port_problem(p, dev, dt)
        before, warm = nl.LAUNCHES, graphs.WARMUP_LAUNCHES
        prog, it = _program_route(kind, mesh, problem, kw)
        launches = nl.LAUNCHES - before - (graphs.WARMUP_LAUNCHES - warm)
        eager, eager_it = _eager_route(kind, mesh, problem, kw)
        for i, (a, b) in enumerate(zip(prog, eager)):
            out[f"{name}_prog{i}"], out[f"{name}_eager{i}"] = a.cpu().numpy(), b.cpu().numpy()
        out[f"{name}_it"], out[f"{name}_eager_it"] = it, eager_it
        out[f"{name}_launches"] = mesh_mod.gather_leading(
            torch.tensor([launches], device=dev), mesh, mesh_mod.AXES).cpu().numpy()
    return out


def batch_problems_case(problem, kw):
    """`sharded_stochastic_solve_batch` on a (world, 1) mesh for two
    problems that differ in the rule's theta, the box and the inner starts
    only: the outputs of each through the program route and the eager mesh
    route, and how many batch programs of this mesh the cache holds after
    both (the problem is an input of the program's graphs, not part of its
    key)."""
    from rollout_bo_tpu_torch.utils import graphs

    mesh = mesh_mod.make_mesh(restarts=dist.get_world_size())
    st, tp, xstarts, starts = port_problem(problem)
    other = tp._replace(theta=tp.theta * 0.5, lbs=tp.lbs - 0.25, ubs=tp.ubs + 0.25)
    out = {}
    for name, (t, xs) in dict(first=(tp, xstarts), second=(other, xstarts.flip(0))).items():
        prog = sharded.sharded_stochastic_solve_batch(st, t, dr.EI(), xs, starts, mesh, **kw)
        eager = outer.stochastic_solve_batch(st, t, dr.EI(), xs, starts, mesh=mesh, **kw)
        for i, (a, b) in enumerate(zip(prog, eager)):
            out[f"batch_{name}_prog{i}"], out[f"batch_{name}_eager{i}"] = a.numpy(), b.numpy()
    out["batch_programs"] = len([k for k in graphs.PROGRAM_CACHE
                                 if k[0] == "sharded_batch" and k[2] == mesh])
    return out


def program_mesh_error_case(problem):
    """What a mesh solve refuses: a fused or scanned program built without a
    mesh, and a mesh's program on one device. Returns the messages."""
    mesh = mesh_mod.make_mesh(restarts=dist.get_world_size())
    st, tp, xstarts, starts = port_problem(problem)
    msgs = {}
    calls = {
        "fused_no_mesh": lambda: sharded.sharded_stochastic_solve_fused(
            st, tp, dr.EI(), xstarts, starts, mesh,
            program=outer.make_fused_sga_program(st, tp, dr.EI(), xstarts)),
        "scanned_no_mesh": lambda: sharded.sharded_stochastic_solve_scanned(
            st, tp, dr.EI(), xstarts, starts, mesh,
            program=outer.make_scanned_sga_program(st, tp, dr.EI(), xstarts)),
        "fused_one_device": lambda: outer.stochastic_solve_fused(
            st, tp, dr.EI(), xstarts, starts,
            program=outer.make_fused_sga_program(st, tp, dr.EI(), xstarts, mesh=mesh)),
    }
    for key, call in calls.items():
        try:
            call()
            msgs[key] = ""
        except ValueError as e:
            msgs[key] = str(e)
    return msgs


def bo_program_case(name, kw, restarts, mc=1, device="cpu"):
    """`bo_case` with the program keys the loop asked `bo._cached_program`
    for (as text) and the acquisitions that ran a cached program."""
    asked, cached = [], bo._cached_program
    acquisitions = {"count": 0}
    call = outer._FusedSGAProgram.__call__

    def asking(key, builder):
        asked.append(repr(key))
        return cached(key, builder)

    def counted(self, *a):
        acquisitions["count"] += 1
        return call(self, *a)

    bo._cached_program, outer._FusedSGAProgram.__call__ = asking, counted
    try:
        out = bo_case(name, kw, restarts, mc, device)
    finally:
        bo._cached_program, outer._FusedSGAProgram.__call__ = cached, call
    out.update(keys=np.asarray(asked), programs_run=acquisitions["count"])
    return out


def mesh_error_case():
    """What the ranks refuse: a mesh that is not the world, an axis the
    ranks do not divide. Returns the messages."""
    msgs = {}
    for key, call in (("mesh", lambda: mesh_mod.make_mesh(restarts=3)),
                      ("shape", lambda: mesh_mod.make_mesh(restarts=2, mc=2)),
                      ("shard", lambda: mesh_mod.shard_leading(
                          torch.zeros(3, 1), mesh_mod.make_mesh(restarts=2), "restarts"))):
        try:
            call()
            msgs[key] = ""
        except ValueError as e:
            msgs[key] = str(e)
    return msgs


def worker_fields(mc_iters=16):
    """The worker's problem (`multihost_worker.build_problem`) as numpy
    arrays, the form `port_problem` takes."""
    from rollout_bo_tpu_torch.parallel import multihost_worker as mw

    st, tp, xstarts, starts = mw.build_problem(mc_iters, device="cpu")
    out = {f: getattr(st, f).numpy() for f in ("X", "y", "L", "Li", "c", "n", "noise")}
    out.update(kind=st.kernel.kind, theta=st.kernel.theta.numpy(), x0=tp.x0.numpy(),
               theta_rule=tp.theta.numpy(), lbs=tp.lbs.numpy(), ubs=tp.ubs.numpy(),
               z=tp.rnstream.numpy(), xstarts=xstarts.numpy(), starts=starts.numpy())
    return out


def _pooled(parts):
    """(mean, ddof-1 std) over the union of samples, from each sample's
    (mean, std, size)."""
    total = sum(m for _, _, m in parts)
    mu = sum(mean * m for mean, _, m in parts) / total
    ss = sum(std**2 * (m - 1) + (mean - mu) ** 2 * m for mean, std, m in parts)
    return mu, torch.sqrt(ss / (total - 1))


def blocked(simulate, restarts, mc):
    """`simulate` (mc.simulate_trajectory_mc) evaluated the way the ranks
    of a (restarts, mc) mesh evaluate it: one call per block of the
    restarts (tp.x0's leading axis) and of the trajectories, so every
    kernel launch holds the lanes of one rank's launch; the blocks'
    statistics are pooled."""
    if restarts == mc == 1:
        return simulate

    def run(state, tp, rule, xstarts, **kw):
        rows = []
        for xb in tp.x0.chunk(restarts):
            parts = [(simulate(state, tp._replace(x0=xb, rnstream=zb), rule, xstarts, **kw),
                      zb.shape[0]) for zb in tp.rnstream.chunk(mc)]
            row = {}
            for f in ("mu", "grad_x", "grad_theta"):
                if getattr(parts[0][0], f) is not None:
                    row[f], row["std_" + f] = _pooled(
                        [(getattr(o, f), getattr(o, "std_" + f), m) for o, m in parts])
            rows.append(row)
        return type(parts[0][0])(**{f: torch.cat([row[f] for row in rows]) for f in rows[0]})

    return run


def unsharded_solve(kind, p, kw, device="cpu", dtype=f64):
    """The same solve on one rank with no mesh, for comparison."""
    st, tp, xstarts, starts = port_problem(p, device, dtype)
    if kind == "batch":
        return outer.stochastic_solve_batch(st, tp, dr.EI(), xstarts, starts, **kw)
    if kind == "scanned":
        return outer.stochastic_solve_scanned(st, tp, dr.EI(), xstarts, starts, **kw)
    return outer.stochastic_solve_fused(st, tp, dr.EI(), xstarts, starts, **kw)
