"""Faults planted under the timed path, and their readings on the card.

    python3 benchmark/faults.py --workload <cell> --fault <name> --seeds 51 52 53 \
        [--seconds 1]

Each fault breaks the program where its name says, for the whole process;
the cell is then set up and run for a short window at its own load, and
the numbers `correct` compares are printed per seed as JSON. The tests
plant the same faults at tiny sizes (`tests/test_bench_faults.py`):

- `step_returns_its_state`: each outer SGA step hands its carry back;
- `observe_returns_its_state`: each observation leaves the surrogate as
  it was;
- `half_the_batch`: the estimate's statistics over the first half of the
  trajectories;
- `value_altered`: the winner's value one part in a thousand off where it
  is chosen;
- `observation_altered`: the true function one part in a million off
  where it is evaluated;
- `observes_the_wrong_point`: each observation is taken a thousandth of
  the way from the acquisition's answer to the box's centre.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def step_returns_its_state(patch):
    from rollout_bo_tpu_torch.rollout import outer

    patch(outer, "_sga_step", lambda simulate, carry, *a, **k: carry)


def observe_returns_its_state(patch):
    from rollout_bo_tpu_torch.models import surrogate as sg

    patch(sg, "condition", lambda state, x, y: state)


def half_the_batch(patch):
    from rollout_bo_tpu_torch.rollout import mc

    stats = mc._stats
    patch(mc, "_stats", lambda v, dim: stats(v.narrow(dim, 0, v.shape[dim] // 2), dim))


def value_altered(patch):
    from rollout_bo_tpu_torch.rollout import outer

    best = outer._best

    def altered(xs, vals):
        x, v = best(xs, vals)
        return x, v * 1.001

    patch(outer, "_best", altered)


def observation_altered(patch):
    from rollout_bo_tpu_torch.models import testfns

    get = testfns.get_function

    def altered(name):
        fn = get(name)
        return dataclasses.replace(fn, f=lambda x: fn.f(x) * (1 + 1e-6))

    patch(testfns, "get_function", altered)


def observes_the_wrong_point(patch):
    from rollout_bo_tpu_torch.rollout import bo

    observe = bo._Trial.observe

    def elsewhere(trial, b, program, xnext):
        centre = 0.5 * (trial.lbs + trial.ubs)
        return observe(trial, b, program, xnext + 1e-3 * (centre - xnext))

    patch(bo._Trial, "observe", elsewhere)


FAULTS = {f.__name__: f for f in (step_returns_its_state, observe_returns_its_state,
                                  half_the_batch, value_altered, observation_altered,
                                  observes_the_wrong_point)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core

    FAULTS[args.fault](setattr)
    cell = core.Cell(args.workload, spec_path=ROOT / "BENCHMARK.json", data_root=ROOT)
    dev = torch.device("cuda", 0)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    for seed in args.seeds:
        loop = core.loop_module(cell.traffic["loop"]).Loop(cell, seed, dev, log=log)
        loop.setup()
        run = loop.window(args.seconds, trace=False)
        loop.release()
        gc.collect()
        torch.cuda.empty_cache()
        checks = loop.check(run)
        print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                          "correct": core.judge(checks, run.attempted - run.failed),
                          "readings": {n: v for n, v, _ in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
