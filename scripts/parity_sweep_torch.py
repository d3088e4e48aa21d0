"""Regret-parity sweep of the PyTorch port: the experiment CLIs at the
paper's protocol, one cell at a time.

The counterpart of `scripts/run_parity_sweep.sh`, `run_myopic.sh` and
`run_nonmyopic.sh`, with the module swapped to
`rollout_bo_tpu_torch.experiments.*`. A cell is one (function, rule) of
the myopic CLI or one (function, horizon) of the non-myopic CLI. Plans:

- `parity` (`run_parity_sweep.sh`): the non-myopic horizon ladder on
  gramacylee and ackley2d, h 0-3 (budget 15, 200 QMC trajectories, 8
  starts, batch 8, 50 SGA iterations, MLE, 1 initial observation, seed
  1906, float32; 10 trials), then the myopic suite on seven functions x
  EI / POI / LCB / Random (budget 100, 64 starts, seed 1906, float64; 5
  trials) under `<out>/nonmyopic` and `<out>/myopic`;
- `myopic` (`run_myopic.sh`): the myopic suite at 60 trials;
- `nonmyopic` (`run_nonmyopic.sh`): the rollout CLI on the myopic suite's
  functions (budget 100, 64 starts, 5 MC samples, QMC; 60 trials) at
  `--horizon` (default 1, the script's second argument).

Each cell runs in a process of its own (spawned), as each line of the
shell scripts does, so no cell's CUDA-graph programs outlive it; the
process calls the CLI's `main(argv)` and returns the seconds `main` took
(its first captures included) and the lane-kernel launches it ran
(`newton_lanes.LAUNCHES` less `graphs.WARMUP_LAUNCHES`). Each run of a
cell appends them to `<cell>_sweep.json` beside the cell's CSVs.

A cell whose `*_gaps.csv` already holds the asked trials is skipped; a
cell with fewer resumes after its last complete trial (the CLI's
`--checkpoint-every` at the budget: trial-level resume, the same initial
designs and seeds), so a cut run or a call for more trials runs only what
is missing. A cell that fails writes `<cell>_failed.txt`, is reported, and
the sweep goes on; the exit status is then 1.

Usage (on the card; `--device cpu` runs the plain PyTorch route; `--dtype
float32` runs the myopic cells in the dtype the JAX record's were run in):
    python scripts/parity_sweep_torch.py --plan parity --trials 10
    python scripts/parity_sweep_torch.py --plan parity --trials 20 --functions sixhump:poi
    python scripts/parity_sweep_torch.py --trials 10 --functions levy10d:ei --dtype float32
    python scripts/parity_report_torch.py
`--functions` takes function names, or `name:rule` / `name:h<k>` for one
cell.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MYOPIC_FUNCTIONS = ("sixhump", "braninhoo", "goldsteinprice", "griewank3d", "ackley5d",
                    "hartmann6d", "levy10d")
RULES = ("ei", "poi", "lcb", "random")
LADDER_FUNCTIONS = ("gramacylee", "ackley2d")
HORIZONS = (0, 1, 2, 3)
# run_parity_sweep.sh: the reference's nonmyopic-shortrun-timing protocol
LADDER_FLAGS = ("--budget", "15", "--mc-samples", "200", "--starts", "8", "--batch-size", "8",
                "--sgd-iterations", "50", "--optimize", "--variance-reduction",
                "--initial-observations", "1", "--seed", "1906", "--dtype", "float32")
# run_myopic.sh and run_nonmyopic.sh list the functions in this order
SCRIPT_FUNCTIONS = ("ackley5d", "braninhoo", "hartmann6d", "sixhump", "levy10d",
                    "goldsteinprice", "griewank3d")
PLANS = ("parity", "myopic", "nonmyopic")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One CLI run: `cli` ("myopic" or "nonmyopic") with `flags` and
    `--trials trials`, writing `<out>/<cli>/<function>/<prefix>_*.csv`."""
    cli: str
    function: str
    label: str          # the rule ("ei") or the horizon ("h1")
    flags: tuple
    trials: int
    budget: int

    @property
    def prefix(self) -> str:
        """The CSVs' prefix, as the CLI names them: "ei", "rollout_h1"."""
        return self.label if self.cli == "myopic" else f"rollout_{self.label}"

    def argv(self, out: str | None = None, device: str | None = None) -> list[str]:
        """The CLI's argv; `out` adds `--output-dir`, `device` `--device`."""
        argv = ["--function-name", self.function, *self.flags, "--trials", str(self.trials)]
        if out is not None:
            argv += ["--output-dir", os.path.join(out, self.cli)]
        if device is not None:
            argv += ["--device", device]
        return argv

    def directory(self, out: str) -> str:
        return os.path.join(out, self.cli, self.function)


def _myopic(fn, rule, trials, budget=100):
    return Cell("myopic", fn, rule, ("--budget", str(budget), "--starts", "64",
                                     "--acquisitions", rule, "--seed", "1906"), trials, budget)


def _rollout(fn, h, trials, flags, budget):
    return Cell("nonmyopic", fn, f"h{h}", ("--horizon", str(h), *flags), trials, budget)


def plan_cells(plan: str, trials: int | None = None, horizon: int = 1) -> list[Cell]:
    """The cells of `plan` in the shell script's order; `trials` replaces
    the script's trial counts."""
    if plan == "parity":
        ladder = [_rollout(fn, h, trials or 10, LADDER_FLAGS, 15)
                  for fn in LADDER_FUNCTIONS for h in HORIZONS]
        return ladder + [_myopic(fn, rule, trials or 5)
                         for fn in MYOPIC_FUNCTIONS for rule in RULES]
    if plan == "myopic":
        return [_myopic(fn, rule, trials or 60) for fn in SCRIPT_FUNCTIONS for rule in RULES]
    if plan == "nonmyopic":
        flags = ("--budget", "100", "--starts", "64", "--mc-samples", "5",
                 "--variance-reduction")
        return [_rollout(fn, horizon, trials or 60, flags, 100) for fn in SCRIPT_FUNCTIONS]
    raise ValueError(f"unknown plan {plan!r}; one of {PLANS}")


def select(cells: list[Cell], names) -> list[Cell]:
    """The cells named by `names` (function names, or `fn:label` for one
    cell), in plan order; raises on a name that matches no cell."""
    if not names:
        return list(cells)
    picked = [c for c in cells if c.function in names or f"{c.function}:{c.label}" in names]
    known = {c.function for c in cells} | {f"{c.function}:{c.label}" for c in cells}
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(f"--functions {unknown}: not in this plan")
    return picked


def _csvs(cell: Cell, out: str) -> list[str]:
    return sorted(glob.glob(os.path.join(cell.directory(out), f"{cell.prefix}_*.csv")))


def trials_on_disk(cell: Cell, out: str) -> int:
    """Complete trials of `cell`: the fewest rows over its CSVs (0 if none)."""
    paths = _csvs(cell, out)
    if not paths:
        return 0
    counts = []
    for p in paths:
        with open(p) as fh:
            counts.append(max(sum(1 for _ in csv.reader(fh)) - 2, 0))
    return min(counts)


def _trim(cell: Cell, out: str, rows: int) -> None:
    """Cut every CSV of `cell` to header, sentinel and `rows` rows (a run
    cut between two of its writes leaves one CSV a row ahead)."""
    for p in _csvs(cell, out):
        with open(p) as fh:
            lines = fh.readlines()
        if len(lines) > rows + 2:
            with open(p, "w") as fh:
                fh.writelines(lines[:rows + 2])


def _cell_process(conn, cli: str, argv: list[str], threads: int) -> None:
    """In the cell's own process: run the CLI and send back its seconds and
    kernel launches, or the traceback."""
    try:
        import importlib

        import torch
        torch.set_num_threads(threads)
        from rollout_bo_tpu_torch.ops import newton_lanes
        from rollout_bo_tpu_torch.utils import graphs
        main = importlib.import_module(f"rollout_bo_tpu_torch.experiments.{cli}").main
        t0 = time.perf_counter()
        main(argv)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        conn.send(dict(ok=True, seconds=time.perf_counter() - t0,
                       launches=newton_lanes.LAUNCHES - graphs.WARMUP_LAUNCHES,
                       device=(torch.cuda.get_device_name() if torch.cuda.is_initialized()
                               else "cpu")))
    except BaseException:
        conn.send(dict(ok=False, error=traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_in_process(cli: str, argv: list[str], threads: int) -> dict:
    """`_cell_process` in a spawned process; a process that dies without a
    word is a failure too."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_cell_process, args=(send, cli, argv, threads))
    proc.start()
    send.close()
    try:
        msg = recv.recv()
    except EOFError:
        msg = dict(ok=False, error="the cell's process ended without a result")
    proc.join()
    if msg["ok"] and proc.exitcode != 0:
        msg = dict(ok=False, error=f"the cell's process exited with {proc.exitcode}")
    return msg


def card_line() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.splitlines()[0].strip() if out.returncode == 0 and out.stdout else None


def run(cells: list[Cell], out: str, device: str = "cuda") -> int:
    """Run every cell not yet complete under `out`, each process with this
    one's intra-op threads; returns the number that failed. Each run
    appends {trials, iterations, seconds, launches, ...} to
    `<prefix>_sweep.json` in the cell's directory."""
    import torch
    threads = torch.get_num_threads()
    card = card_line() if device.startswith("cuda") else None
    failed = 0
    for cell in cells:
        name = f"{cell.cli} {cell.function} {cell.label}"
        done = trials_on_disk(cell, out)
        if done >= cell.trials:
            print(f"=== {name}: {done} trials on disk, skipped ===", flush=True)
            continue
        argv = cell.argv(out, device)
        if done:
            _trim(cell, out, done)
            argv += ["--checkpoint-every", str(cell.budget)]
        print(f"=== {name}: trials {done + 1}-{cell.trials} ===", flush=True)
        msg = run_in_process(cell.cli, argv, threads)
        failure = os.path.join(cell.directory(out), f"{cell.prefix}_failed.txt")
        if not msg["ok"]:
            failed += 1
            os.makedirs(cell.directory(out), exist_ok=True)
            with open(failure, "w") as fh:
                fh.write(msg["error"])
            print(f"{name} FAILED (continuing):\n{msg['error']}", flush=True)
            continue
        if os.path.exists(failure):
            os.remove(failure)
        ran = trials_on_disk(cell, out) - done
        record = dict(trials=ran, iterations=ran * cell.budget, seconds=msg["seconds"],
                      launches=msg["launches"], device=msg["device"], card=card,
                      argv=cell.argv() + argv[len(cell.argv(out, device)):])
        path = os.path.join(cell.directory(out), f"{cell.prefix}_sweep.json")
        runs = json.load(open(path))["runs"] if os.path.exists(path) else []
        with open(path, "w") as fh:
            json.dump(dict(runs=runs + [record]), fh, indent=1)
        per_it = record["iterations"] or 1
        print(f"{name}: {ran} trials in {msg['seconds']:.1f} s, "
              f"{msg['seconds'] / per_it:.4f} s and {msg['launches'] / per_it:.2f} "
              f"launches per BO iteration", flush=True)
    return failed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--plan", choices=PLANS, default="parity")
    p.add_argument("--trials", type=int, default=None,
                   help="trials per cell (default: the shell script's: parity 10 per "
                        "ladder cell and 5 per myopic cell, myopic 60, nonmyopic 60)")
    p.add_argument("--functions", nargs="+", default=None,
                   help="function names, or name:rule / name:h<k> for one cell "
                        "(default: the plan's every cell)")
    p.add_argument("--horizon", type=int, default=1,
                   help="the horizon of --plan nonmyopic (run_nonmyopic.sh's second "
                        "argument)")
    p.add_argument("--out", default=os.path.join(REPO, "results_torch"))
    p.add_argument("--device", default="cuda",
                   help="the CLIs' --device (cpu runs the plain PyTorch route)")
    p.add_argument("--dtype", choices=("float32", "float64"), default=None,
                   help="the myopic cells' --dtype (default: the CLI's, float64; the "
                        "ladder runs float32 by run_parity_sweep.sh)")
    return p.parse_args(argv)


def with_dtype(cells: list[Cell], dtype: str | None) -> list[Cell]:
    """The cells with `--dtype dtype` added to each myopic cell's flags."""
    if dtype is None:
        return cells
    return [dataclasses.replace(c, flags=c.flags + ("--dtype", dtype)) if c.cli == "myopic"
            else c for c in cells]


def main(argv=None) -> int:
    args = parse_args(argv)
    cells = with_dtype(select(plan_cells(args.plan, args.trials, args.horizon),
                              args.functions), args.dtype)
    failed = run(cells, args.out, args.device)
    print(f"sweep done: {len(cells)} cells, {failed} failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
