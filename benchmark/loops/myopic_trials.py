"""Closed loop of myopic BO trials through `rollout.bo.run_myopic_bo`.

The traffic (`benchmark/traffic/<name>.json`, "loop": "myopic_trials")
gives the rule and its theta, the starts and Newton iterations, the MLE
cadence, the budget, the initial observations, the chunk length
(`steps_per_call`, 0 for the whole budget) and the pool of initial
designs: `designs` designs of `n_init` points drawn uniformly in the box
from the fixed key `design_key`, the same in every run. The seed sets the
order in which a run's trials take them (trial k takes the design at
place k of the seed's permutation, cycling) and which BO iterations the
reference replays, so that every seed gives the window the same work and
the same answers to judge. Set-up runs `mle_every` BO iterations of a
trial of the same capacity (n_init + budget observations), so that each
MLE constant the window's iterations take is captured: every program the
window's trials take from the program cache. The window runs whole trials
back to back and starts none after `--seconds` (the first always).

With `--trace 1` the profiler covers BO iterations `trace_iteration` and
the next of the first trial. The loop counts the calls of the program
cached under "myopic_chunk" (one per BO iteration) and synchronizes where
the profiler starts and stops, inside that trial's chunk; the untraced
trials read nothing from the device until their chunks end.

`correct`, by the reference in float64, for every trial: every
observation against the true function (`y_gap`); the last lengthscale
against the reference's own chain of warm-started fits over the trial's
points (`mle_gap`); K^{-1} y after the last observation against the
reference's at the program's lengthscale (`posterior_gap`); the excess of
every observed point over the box (`box_excess`); and, for
`replay_samples` BO iterations drawn from the seed, the shortfall of the
reference's EI at the observed point below the winner of the reference's
own `inner_solve` from the same starts, relative to that winner
(`ei_shortfall`). Trials that observed the same points (those of one
design) share the reference's work, which keeps the check's time to that
of the pool's designs. The reference runs on the CPU: its fits at these
sizes are bound by their Python and launches, and ran slower on the card.
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
# fixed key), the order of the designs and the replayed iterations (of the
# seed)
WARM_UP, DESIGN, ORDER, REPLAY = 1, 2, 3, 4
TRACED = 2          # BO iterations the profiler covers


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
        self.xstarts = qmc.starts(tr["num_starts"], self.lbs, self.ubs, 1e-6)
        self._chains: dict = {}

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
        from rollout_bo_tpu_torch.rollout import bo
        from rollout_bo_tpu_torch.utils import graphs

        cfg, tr = self.cell.config, self.cell.traffic
        self.bo, self.graphs = bo, graphs
        self.testfn = program_fns.get_function(cfg["function"])
        self.settings = dict(
            theta=(tr["theta"],), num_starts=tr["num_starts"],
            kernel_lbs=tuple(cfg["kernel_lbs"]), kernel_ubs=tuple(cfg["kernel_ubs"]),
            noise=cfg["noise"], mle_every=tr["mle_every"],
            solver_iterations=tr["solver_iterations"], dtype=self.dtype, device=self.device,
            steps_per_call=tr["steps_per_call"])
        self.rule = RULES[tr["rule"]]()
        self.settings["kernel"] = getattr(kernels, cfg["kernel"])(
            (cfg["lengthscale"],), device=self.device, dtype=self.dtype)
        warm = tr["mle_every"]
        t0 = time.perf_counter()
        bo.run_myopic_bo(self.testfn, self.rule, budget=warm, n_init=self.capacity - warm,
                         x_init=self.x_init((WARM_UP,), self.capacity - warm), seed=0,
                         **self.settings)
        self.sync()
        self.log(f"set-up: warm-up {time.perf_counter() - t0:.3f} s (the kernel's build or "
                 f"load, the captures, {warm} BO iteration(s) at capacity {self.capacity})")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, *, trace: bool) -> common.Run:
        tr = self.cell.traffic
        bo = self.bo
        n0 = tr["n_init"]
        tracer = Tracer(trace, self.device, outside="iteration")
        run = common.Run(self.cell)
        trials = []
        calls = [0]
        first = tr["trace_iteration"]
        cached_program = bo._cached_program

        def counted(key, make):
            # the program of one BO iteration's solve (or of the whole
            # iteration): the profiler starts and stops at its calls
            prog = cached_program(key, make)
            if key[0] != "myopic_chunk":
                return prog

            def call(*args):
                b = calls[0]
                calls[0] += 1
                if trace and not trials and b == first:
                    tracer.start()
                elif tracer.active and b == first + TRACED:
                    tracer.stop()
                return prog(*args)

            return call

        bo._cached_program = counted
        captures = self.graphs.CAPTURES
        try:
            t0 = time.perf_counter()
            while not trials or time.perf_counter() - t0 < seconds:
                k = len(trials)
                j = self.design(k)
                calls[0] = 0
                ta = time.perf_counter()
                res = bo.run_myopic_bo(self.testfn, self.rule, budget=tr["budget"], n_init=n0,
                                       x_init=self.x_init((DESIGN, j), n0), seed=j,
                                       **self.settings)
                wall = time.perf_counter() - ta
                tracer.stop()
                # the answers to the host, the trial's device state let go:
                # the window's peak of memory is one trial's, whatever their number
                trials.append((self.answer(res), res.times, wall))
                del res
            run.window_s = time.perf_counter() - t0
        finally:
            bo._cached_program = cached_program
        self.log(f"window: {len(trials)} trials (designs "
                 f"{[self.design(k) for k in range(len(trials))]}), "
                 f"{self.graphs.CAPTURES - captures} captures; {self.launches(trials)}")
        run.trace = tracer.trace
        run.programs = list(self.graphs.PROGRAM_CACHE.values())
        run.answers = []
        traced = range(first, first + TRACED) if trace else ()
        for k, (answer, times, wall) in enumerate(trials):
            run.answers.append(answer)
            run.trials.append(common.Trial(wall, float(np.sum(times)), len(times)))
            for b, t in enumerate(times):
                run.acquisitions.append(common.Acquisition(
                    float(t), 0, n0 + b, 1, traced=k == 0 and b in traced))
        run.attempted = sum(len(a["X"]) - n0 for a in run.answers)
        run.failed = sum(int(not np.all(np.isfinite(a["X"]))) + int(not np.all(np.isfinite(a["y"])))
                         for a in run.answers)
        return run

    @staticmethod
    def answer(res) -> dict:
        """What the check reads of a trial: its points and observations, the
        last lengthscale and K^{-1} y over every observation."""
        st = res.state
        n = int(st.n)
        return dict(X=np.asarray(res.X, dtype=float), y=np.asarray(res.y, dtype=float),
                    theta=float(st.kernel.theta[0]), n=n, c=st.c.double().cpu().numpy()[:n])

    def launches(self, trials) -> str:
        """The lane-kernel launches of the window's trials by design, from
        the program's records where it keeps them."""
        from rollout_bo_tpu_torch.utils import profiling

        recs = list(getattr(profiling, "RECORDS", ()))[-len(trials):]
        if len(recs) < len(trials) or not all(hasattr(r, "lane_launches") for r in recs):
            return "no launch counts in the records"
        return ("lane-kernel launches per trial " + str([r.lane_launches for r in recs])
                + ", of the lane block " + str([r.lane_block_launches for r in recs]))

    def release(self) -> None:
        self.graphs.PROGRAM_CACHE.clear()
        self.settings = None

    # ------------------------------------------------------------------
    # correct

    def chain(self, X, y, dtype):
        """The lengthscale before each BO iteration and after the last, by
        the reference's fits (on the CPU) in `dtype`; kept per trial's data."""
        key = (X.tobytes(), y.tobytes(), dtype)
        if key in self._chains:
            return self._chains[key]
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
        self._chains[key] = ells
        return ells

    def solve(self, X, y, ell, dtype):
        """(the GP of BO iteration b's data X, y at `ell`, its incumbent less
        theta, the reference's winner and EI from the traffic's starts), in
        `dtype` on the CPU."""
        tr, cfg = self.cell.traffic, self.cell.config
        t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
        gp = RG.fit(t(X)[None], t(y)[None], ell, cfg["noise"])
        fmini = t([np.min(y) - tr["theta"]])
        xw, vw = RR.inner_solve(gp, fmini, t(self.xstarts), t(self.lbs), t(self.ubs),
                                iterations=tr["solver_iterations"])
        return gp, fmini, xw[0], float(vw[0])

    def replay_picks(self, answers):
        """The (trial, iteration) pairs whose solve the reference replays:
        `replay_samples` drawn from the seed."""
        n0 = self.cell.traffic["n_init"]
        pairs = [(i, b) for i, a in enumerate(answers) for b in range(len(a["X"]) - n0)]
        n = min(self.cell.traffic["replay_samples"], len(pairs))
        rng = common.seed_rng(self.seed, REPLAY)
        return sorted(pairs[j] for j in rng.choice(len(pairs), size=n, replace=False))

    def readings(self, answers, candidate=None, picks=None) -> dict:
        """The numbers compared, each the worst over the run; the values
        behind each are kept in `self.read`. `candidate(trial, picks)` gives
        the answers judged at the program's points: a dict with y (the
        observations), theta and c (the last lengthscale and K^{-1} y over
        every observation) and winners ({iteration: x} of the replayed
        ones); None judges the program's own answers, whose winners are
        its observed points. `picks` replaces the replayed (trial,
        iteration) pairs."""
        tr, cfg = self.cell.traffic, self.cell.config
        n0 = tr["n_init"]
        picks = self.replay_picks(answers) if picks is None else picks
        out = {k: [] for k in ("y_gap", "mle_gap", "posterior_gap", "box_excess",
                               "ei_shortfall")}
        judged: dict = {}
        for i, a in enumerate(answers):
            X, y = a["X"], a["y"]
            mine = [b for (j, b) in picks if j == i]
            key = (X.tobytes(), y.tobytes(), a["theta"], a["c"].tobytes())
            if key not in judged:
                ells = self.chain(X, y, torch.float64)
                if candidate is None:
                    c = np.zeros(len(X))
                    c[:len(a["c"])] = a["c"]
                    cand = dict(y=y, theta=a["theta"], c=c, winners={})
                else:
                    cand = candidate(a, [])
                f64 = self.f(torch.tensor(X, dtype=torch.float64)).numpy()
                c_ref = RG.fit(torch.tensor(X), torch.tensor(y), cand["theta"], cfg["noise"]).c
                judged[key] = dict(
                    y_gap=float(np.max(np.abs(cand["y"] - f64) / np.maximum(np.abs(f64), 1.0))),
                    mle_gap=abs(cand["theta"] - ells[-1]) / ells[-1],
                    posterior_gap=common.rel_gap(cand["c"], c_ref.numpy()),
                    box_excess=common.worst(common.box_excess(x, self.lbs, self.ubs)
                                            for x in X[n0:]))
            for name, value in judged[key].items():
                out[name].append(value)
            if not mine:
                continue
            ells = self.chain(X, y, torch.float64)
            winners = ({b: X[n0 + b] for b in mine} if candidate is None
                       else candidate(a, mine)["winners"])
            for b in mine:
                gp, fmini, _, vbest = self.solve(X[:n0 + b], y[:n0 + b], ells[b], torch.float64)
                xw = torch.tensor(winners[b], dtype=torch.float64)[None]
                v = float(RG.ei(*RG.posterior_value(gp, xw, 0), fmini)[0])
                out["ei_shortfall"].append(max(0.0, vbest - v) / max(abs(vbest), 1e-300))
                self.log(f"replay trial {i} iteration {b}: the reference's winner {vbest!r}, "
                         f"at the observed point {v!r}")
        # the name `benchmark/control.py` reads the replays' shortfalls under
        out["winner_shortfall"] = out["ei_shortfall"]
        self.read = out
        return {k: common.worst(v) for k, v in out.items() if k != "winner_shortfall"}

    def control(self, dtype):
        """`candidate` for `readings`: the reference in the program's place
        at `dtype`, at the program's points."""
        tr, cfg = self.cell.traffic, self.cell.config
        n0 = tr["n_init"]

        def candidate(a, mine):
            X, y = a["X"], a["y"]
            ells = self.chain(X, y, dtype)
            yc = self.f(torch.tensor(X, dtype=dtype)).double().numpy()
            c = RG.fit(torch.tensor(X, dtype=dtype), torch.tensor(y, dtype=dtype), ells[-1],
                       cfg["noise"]).c.double().numpy()
            winners = {b: self.solve(X[:n0 + b], y[:n0 + b], ells[b], dtype)[2].double().numpy()
                       for b in mine}
            return dict(y=yc, theta=ells[-1], c=c, winners=winners)

        return candidate

    def check(self, run) -> list:
        limits = self.cell.figures["limits"]
        got = self.readings(run.answers)
        return [(name, got[name], float(limits[name])) for name in limits]
