"""Closed loop of non-myopic BO trials through `rollout.bo.run_nonmyopic_bo`.

The traffic (`benchmark/traffic/<name>.json`, "loop": "bo_trials") gives
the horizon, the trajectories, restarts and SGA settings, the inner starts
and Newton iterations, the MLE cadence, the budget, the initial
observations and the pool of initial designs: `designs` designs of
`n_init` points drawn uniformly in the box from the fixed key
`design_key`, the same in every run. The seed sets the order in which a
run's trials take them (trial k takes the design at place k of the seed's
permutation, cycling) and which acquisitions the reference replays, so
that every seed gives the window the same work and the same answers to
judge; everything else is the loop's own (the source's QMC stream and
starts). Set-up runs one BO iteration of a trial of the same capacity
(n_init + budget observations) with the window's settings, its
acquisition's answer taken as 0 so that the exploration fallback runs
too: that captures every program the window's trials take from the
program cache. The window runs whole trials back to back and starts none
after `--seconds` (the first always).

The loop reads each acquisition's own answer (its winner x and value)
where `run_nonmyopic_bo` takes it from the public
`rollout.outer.stochastic_solve_fused`, by wrapping that function for the
window; the points the trial observed, its fallbacks and SGA iterations
come from the trial's result. With `--trace 1` the profiler covers BO
iteration `trace_iteration` of the first trial: its acquisition and its
observe step.

`correct`, by the reference in float64: every observation against the
true function; the last lengthscale of each trial against the reference's
own chain of fits over the trial's points; the surrogate's coefficients
K^{-1} y after the last observation against the reference's over every
observation at the program's lengthscale; every acquisition's value
against the reference's estimate at its x on the reference's surrogate of
that iteration, in standard errors of the estimate; every observed point
against its acquisition's winner where no fallback was taken (exact), and
its excess over the box; and, for `replay_samples` acquisitions drawn from
the seed and every one that fell back, the shortfall of the reference's
estimate at the observed point below the winner of the reference's own
solve.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.reference import gp as RG
from benchmark.reference import rollout as RR
from benchmark.reference import testfns
from benchmark.trace import Tracer
from benchmark.yardstick import qmc

# the streams: the warm-up trial's points and the designs (of the traffic's
# fixed key), the order of the designs and the replayed acquisitions (of
# the seed)
WARM_UP, DESIGN, ORDER, REPLAY = 1, 2, 3, 4


class Loop:
    def __init__(self, cell, seed: int, device, log=print):
        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        cfg, tr = cell.config, cell.traffic
        self.dtype = getattr(torch, cfg["dtype"])
        self.f, self.d, self.lbs, self.ubs = testfns.get(cfg["function"])
        self.capacity = cfg["capacity"]
        if self.capacity != tr["n_init"] + tr["budget"]:
            raise ValueError(f"{cell.name}: the capacity {self.capacity} is not n_init + budget "
                             f"({tr['n_init']} + {tr['budget']}), which the trials hold")
        self.restarts = qmc.starts(tr["num_restarts"], self.lbs, self.ubs, 1e-2)
        self.xstarts = qmc.starts(tr["num_starts"], self.lbs, self.ubs, 1e-6)
        self.z = qmc.normals(tr["mc_iters"], self.d, tr["horizon"] + 1)

    def x_init(self, key, n: int) -> np.ndarray:
        """n points drawn uniformly in the box from the traffic's fixed key."""
        rng = common.seed_rng(self.cell.traffic["design_key"], *key)
        return qmc.uniform(rng, n, self.lbs, self.ubs)

    def design(self, k: int) -> int:
        """The design of the run's trial k."""
        order = common.seed_rng(self.seed, ORDER).permutation(self.cell.traffic["designs"])
        return int(order[k % len(order)])

    def setup(self) -> None:
        from rollout_bo_tpu_torch.models import testfns as program_fns
        from rollout_bo_tpu_torch.models.decision_rules import RULES
        from rollout_bo_tpu_torch.ops import kernels
        from rollout_bo_tpu_torch.rollout import bo, outer
        from rollout_bo_tpu_torch.utils import graphs

        cfg, tr = self.cell.config, self.cell.traffic
        self.bo, self.outer, self.graphs = bo, outer, graphs
        self.testfn = program_fns.get_function(cfg["function"])
        kernel = getattr(kernels, cfg["kernel"])((cfg["lengthscale"],), device=self.device,
                                                 dtype=self.dtype)
        self.settings = dict(
            horizon=tr["horizon"], mc_iters=tr["mc_iters"], num_starts=tr["num_starts"],
            num_restarts=tr["num_restarts"], sgd_iters=tr["sgd_iters"], lr=tr["lr"],
            kernel=kernel, kernel_lbs=tuple(cfg["kernel_lbs"]),
            kernel_ubs=tuple(cfg["kernel_ubs"]), noise=cfg["noise"],
            mle_every=tr["mle_every"], solver_iterations=tr["solver_iterations"],
            rule=RULES[tr["rule"]](), dtype=self.dtype, device=self.device,
            outer_solver="fused")
        warm = self.capacity - 1
        t0 = time.perf_counter()
        solve = outer.stochastic_solve_fused

        def answers_zero(*args, **kw):
            # the warm-up's acquisition answers 0, so that its fallback runs
            # and the fallback's program is captured here, not in the window
            res = solve(*args, **kw)
            return res._replace(value=res.value * 0.0)

        outer.stochastic_solve_fused = answers_zero
        try:
            res = bo.run_nonmyopic_bo(self.testfn, budget=1, n_init=warm,
                                      x_init=self.x_init((WARM_UP,), warm), seed=0,
                                      **self.settings)
        finally:
            outer.stochastic_solve_fused = solve
        if not res.fallbacks[0]:
            raise RuntimeError("the warm-up's acquisition never reached "
                               "rollout.outer.stochastic_solve_fused")
        self.sync()
        self.log(f"set-up: warm-up {time.perf_counter() - t0:.3f} s (the kernel's build or "
                 "load, the captures, one BO iteration and its fallback)")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, *, trace: bool) -> common.Run:
        tr = self.cell.traffic
        bo, outer = self.bo, self.outer
        n0 = tr["n_init"]
        # between two acquisitions the loop observes: the true function, the
        # condition, the MLE (and the exploration fallback, where taken)
        tracer = Tracer(trace, self.device, outside="observe")
        run = common.Run(self.cell)
        lanes = len(self.restarts) * tr["mc_iters"]
        trials = []
        calls: list = []
        solve = outer.stochastic_solve_fused

        def answered(*args, **kw):
            b = len(calls)
            if trace and not trials and b == tr["trace_iteration"]:
                tracer.start()
            elif tracer.active:
                tracer.stop()
            with tracer.span("acquisition"):
                res = solve(*args, **kw)
                if tracer.active:
                    self.sync()
            calls.append(dict(x=res.x, v=res.value, traced=tracer.active))
            return res

        outer.stochastic_solve_fused = answered
        captures = self.graphs.CAPTURES
        try:
            t0 = time.perf_counter()
            while not trials or time.perf_counter() - t0 < seconds:
                k = len(trials)
                j = self.design(k)
                calls.clear()
                ta = time.perf_counter()
                with tracer.span("trial"):
                    res = bo.run_nonmyopic_bo(self.testfn, budget=tr["budget"], n_init=n0,
                                              x_init=self.x_init((DESIGN, j), n0), seed=j,
                                              **self.settings)
                wall = time.perf_counter() - ta
                tracer.stop()
                if len(calls) != len(res.times):
                    raise RuntimeError(f"trial {k}: {len(calls)} acquisitions reached "
                                       "rollout.outer.stochastic_solve_fused, "
                                       f"{len(res.times)} BO iterations ran")
                trials.append((res, list(calls), wall))
            run.window_s = time.perf_counter() - t0
        finally:
            outer.stochastic_solve_fused = solve
        self.log(f"window: {len(trials)} trials (designs "
                 f"{[self.design(k) for k in range(len(trials))]}), "
                 f"{sum(int(np.sum(r.fallbacks)) for r, _, _ in trials)} fallbacks, "
                 f"{self.graphs.CAPTURES - captures} captures")
        run.trace = tracer.trace
        run.programs = list(self.graphs.PROGRAM_CACHE.values())
        run.answers = []
        for res, recs, wall in trials:
            st = res.state
            run.answers.append(dict(
                X=np.asarray(res.X, dtype=float), y=np.asarray(res.y, dtype=float),
                theta=float(st.kernel.theta[0]), n=int(st.n),
                c=st.c.double().cpu().numpy()[:int(st.n)],
                acq=[(r["x"].double().cpu().numpy(), float(r["v"])) for r in recs],
                fallbacks=np.asarray(res.fallbacks, dtype=bool),
                sga=np.asarray(res.sga_iterations)))
            run.trials.append(common.Trial(wall, float(np.sum(res.times)), len(res.times)))
            for b, (t, it) in enumerate(zip(res.times, res.sga_iterations)):
                run.acquisitions.append(common.Acquisition(
                    float(t), int(it), n0 + b, lanes, traced=recs[b]["traced"]))
        run.attempted = sum(len(a["acq"]) for a in run.answers)
        run.failed = sum(int(not np.all(np.isfinite(a["X"]))) + int(not np.all(np.isfinite(a["y"])))
                         for a in run.answers)
        return run

    def release(self) -> None:
        self.graphs.PROGRAM_CACHE.clear()
        self.settings = None

    # ------------------------------------------------------------------
    # correct

    def reference_device(self):
        return self.device if self.device.type == "cuda" else torch.device("cpu")

    def chain(self, X, y, dtype):
        """The lengthscale before each BO iteration and after the last, by
        the reference's fits (on the CPU) in `dtype`."""
        cfg, tr = self.cell.config, self.cell.traffic
        Xt = torch.tensor(X, dtype=dtype)
        yt = torch.tensor(y, dtype=dtype)
        ells = [cfg["lengthscale"]]
        for b in range(len(X) - tr["n_init"]):
            ell = ells[-1]
            if (b + 1) % tr["mle_every"] == 0:
                n = tr["n_init"] + b + 1
                ell = RG.fit_lengthscale(Xt[:n], yt[:n], ell, cfg["kernel_lbs"][0],
                                         cfg["kernel_ubs"][0], cfg["noise"])
            ells.append(ell)
        return ells

    def problem(self, X, y, ell, dtype, device) -> RR.Problem:
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
        return RR.Problem(t(X), t(y), ell, self.cell.config["noise"], t(self.lbs), t(self.ubs),
                          t(self.xstarts), t(self.z), self.cell.traffic["solver_iterations"])

    def replay_picks(self, answers):
        """The (trial, iteration) pairs whose solve the reference replays:
        `replay_samples` drawn from the seed, and every one that fell back."""
        pairs = [(i, b) for i, a in enumerate(answers) for b in range(len(a["acq"]))]
        n = min(self.cell.traffic["replay_samples"], len(pairs))
        rng = common.seed_rng(self.seed, REPLAY)
        picks = {pairs[j] for j in rng.choice(len(pairs), size=n, replace=False)}
        picks |= {(i, b) for i, b in pairs if answers[i]["fallbacks"][b]}
        return sorted(picks)

    def readings(self, answers, candidate=None, picks=None) -> dict:
        """The numbers compared, each the worst over the run; the values
        behind each are kept in `self.read`. `candidate(trial, picks)` gives
        the answers judged at the program's points: a dict with y (the
        observations), theta and c (the last lengthscale and K^{-1} y over
        every observation), values (each acquisition's value at the
        program's winner) and winners ({iteration: (x, SGA iterations)} of
        the replayed ones); None judges the program's own answers, whose
        observed points are its winners. `picks` replaces the replayed
        (trial, iteration) pairs."""
        dev = self.reference_device()
        tr, cfg = self.cell.traffic, self.cell.config
        n0 = tr["n_init"]
        picks = self.replay_picks(answers) if picks is None else picks
        width = self.ubs - self.lbs
        out = {k: [] for k in ("y_gap", "mle_gap", "posterior_gap", "value_gap",
                               "observed_gap", "winner_shortfall", "box_excess")}
        for i, a in enumerate(answers):
            X, y = a["X"], a["y"]
            ells = self.chain(X, y, torch.float64)
            mine = [b for (j, b) in picks if j == i]
            if candidate is None:
                c = np.zeros(len(X))
                c[:len(a["c"])] = a["c"]
                cand = dict(y=y, theta=a["theta"], c=c, values=[v for _, v in a["acq"]],
                            winners={b: (X[n0 + b], int(a["sga"][b])) for b in mine})
                for b, (x, _) in enumerate(a["acq"]):
                    if not a["fallbacks"][b]:
                        out["observed_gap"].append(float(np.max(np.abs(X[n0 + b] - x) / width)))
            else:
                cand = candidate(a, mine)
            f64 = self.f(torch.tensor(X, dtype=torch.float64)).numpy()
            out["y_gap"].append(float(np.max(np.abs(cand["y"] - f64)
                                             / np.maximum(np.abs(f64), 1.0))))
            out["mle_gap"].append(abs(cand["theta"] - ells[-1]) / ells[-1])
            c_ref = RG.fit(torch.tensor(X), torch.tensor(y), cand["theta"], cfg["noise"]).c
            out["posterior_gap"].append(common.rel_gap(cand["c"], c_ref.numpy()))
            for b, (x, _) in enumerate(a["acq"]):
                out["box_excess"].append(common.box_excess(X[n0 + b], self.lbs, self.ubs))
                prob = self.problem(X[:n0 + b], y[:n0 + b], ells[b], torch.float64, dev)
                xt = torch.tensor(x, dtype=torch.float64, device=dev)[None]
                out["value_gap"].append(common.se_gap(
                    cand["values"][b], RR.estimate(prob, xt, with_gradients=False)))
                if b not in mine:
                    continue
                restarts = torch.tensor(self.restarts, dtype=torch.float64, device=dev)
                best = RR.solve(prob, restarts, max_iters=tr["sgd_iters"], lr=tr["lr"])
                xw, its = cand["winners"][b]
                xw = torch.tensor(xw, dtype=torch.float64, device=dev)[None]
                vw = float(RR.estimate(prob, xw, with_gradients=False).mu[0])
                vbest = float(best.value)
                out["winner_shortfall"].append(max(0.0, vbest - vw) / max(abs(vbest), 1e-300))
                self.log(f"replay trial {i} iteration {b}: {its} SGA iterations, the "
                         f"reference's {best.iterations}; its winner {vbest!r}, at the "
                         f"observed point {vw!r}")
        self.read = out
        return {k: common.worst(v) for k, v in out.items()}

    def control(self, dtype):
        """`candidate` for `readings`: the reference in the program's place
        at `dtype`, at the program's points."""
        dev = self.reference_device()
        tr, cfg = self.cell.traffic, self.cell.config

        def candidate(a, mine):
            X, y = a["X"], a["y"]
            ells = self.chain(X, y, dtype)
            yc = self.f(torch.tensor(X, dtype=dtype)).double().numpy()
            c = RG.fit(torch.tensor(X, dtype=dtype), torch.tensor(y, dtype=dtype), ells[-1],
                       cfg["noise"]).c.double().numpy()
            values, winners = [], {}
            for b, (x, _) in enumerate(a["acq"]):
                prob = self.problem(X[:tr["n_init"] + b], y[:tr["n_init"] + b], ells[b],
                                    dtype, dev)
                xt = torch.tensor(x, dtype=dtype, device=dev)[None]
                values.append(float(RR.estimate(prob, xt, with_gradients=False).mu[0]))
                if b in mine:
                    sol = RR.solve(prob, torch.tensor(self.restarts, dtype=dtype, device=dev),
                                   max_iters=tr["sgd_iters"], lr=tr["lr"])
                    winners[b] = (sol.x.double().cpu().numpy(), sol.iterations)
            return dict(y=yc, theta=ells[-1], c=c, values=values, winners=winners)

        return candidate

    def witness(self, answers, picks) -> list:
        """The reference against itself: for each (trial, iteration) of
        `picks`, its solve from the restarts and from the restarts moved by
        one part in 2**52, and the shortfall of the second's winner below
        the first's (as `winner_shortfall` reads it), with both SGA
        iteration counts."""
        dev = self.reference_device()
        tr = self.cell.traffic
        n0 = tr["n_init"]
        out = []
        for i, b in picks:
            X, y = answers[i]["X"], answers[i]["y"]
            prob = self.problem(X[:n0 + b], y[:n0 + b], self.chain(X, y, torch.float64)[b],
                                torch.float64, dev)
            restarts = torch.tensor(self.restarts, dtype=torch.float64, device=dev)
            sols = [RR.solve(prob, r, max_iters=tr["sgd_iters"], lr=tr["lr"])
                    for r in (restarts, restarts * (1.0 + 2.0 ** -52))]
            v0, v1 = (float(RR.estimate(prob, s.x[None], with_gradients=False).mu[0])
                      for s in sols)
            out.append(dict(trial=i, iteration=b, shortfall=max(0.0, v0 - v1) / abs(v0),
                            iterations=[s.iterations for s in sols]))
        return out

    def check(self, run) -> list:
        limits = self.cell.figures["limits"]
        got = self.readings(run.answers)
        return [(name, got[name], float(limits[name])) for name in limits]
