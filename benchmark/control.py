"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \
        [--control-seeds 11] [--replay-all] [--witness] [--seconds 1]

For each seed, one process: the cell's set-up and a short window at the
cell's own load (`--seconds`; a BO cell runs one whole trial at the
least), the program's state released, then the numbers `correct` compares
for the program's answers (the lower readings) and, for the seeds of
`--control-seeds`, for the control's: the reference put in the program's
place in the precision just below the configuration's (float32 for
float64), judged by the float64 reference at the same points.
`--replay-all` replays every acquisition of the program's window, not the
seed's sample, and prints each one's winner shortfall; `--witness` solves again,
from restarts moved by one part in 2**52, the replayed acquisitions whose
shortfall is over 1e-6 (at most WITNESSES of them, the largest) and prints
how far the reference's own winner moves. One JSON line per seed."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL_DTYPE = {"float64": "float32"}
WITNESSES = 4


def readings(loop, run, control: bool, picks=None):
    """(the program's readings, the control's or None, the program's winner
    shortfall at each replayed acquisition). `picks` replaces the
    program's replayed acquisitions; the control replays the seed's."""
    import torch

    mine = loop.readings(run.answers, picks=picks)
    shortfalls = list(loop.read["winner_shortfall"])
    if not control:
        return mine, None, shortfalls
    dtype = getattr(torch, CONTROL_DTYPE[loop.cell.config["dtype"]])
    return mine, loop.readings(run.answers, candidate=loop.control(dtype)), shortfalls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--replay-all", action="store_true")
    p.add_argument("--witness", action="store_true")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core

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
        t0 = time.perf_counter()
        picks = ([(i, b) for i, a in enumerate(run.answers) for b in range(len(a["acq"]))]
                 if args.replay_all else loop.replay_picks(run.answers))
        mine, ctrl, shortfalls = readings(loop, run, seed in args.control_seeds, picks)
        line = {"workload": cell.name, "seed": seed, "answers": run.attempted,
                "program": mine, "control": ctrl,
                "sga_iterations": [a.iterations for a in run.acquisitions][:64],
                "reference_s": time.perf_counter() - t0}
        if args.replay_all:
            line["shortfalls"] = dict(zip(map(str, picks), shortfalls))
        if args.witness:
            parted = sorted((v, pick) for pick, v in zip(picks, shortfalls) if v > 1e-6)
            line["witness"] = loop.witness(run.answers, [pk for _, pk in parted[-WITNESSES:]])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
