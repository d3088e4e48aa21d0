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
        dist.destroy_process_group()


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
    batch, fused or scanned solve, its kernel launches and its SGA
    iterations (-1 where the solver does not report them)."""
    dev, dt = mesh_mod.rank_device(device), getattr(torch, dtype)
    out = {}
    for name, (kind, (restarts, mc), p, kw) in problems.items():
        mesh = mesh_mod.make_mesh(restarts=restarts, mc=mc)
        st, tp, xstarts, starts = port_problem(p, dev, dt)
        before = nl.LAUNCHES
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
        launches = torch.tensor([nl.LAUNCHES - before], device=dev)
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
