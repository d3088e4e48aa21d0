"""Regret-parity report of the PyTorch port: its sweep's CSVs against the
JAX package's record in `results/`.

The counterpart of `scripts/parity_report.py` and
`scripts/cost_aware_summary.py` for the port's sweep
(`scripts/parity_sweep_torch.py`). For each cell it prints the final gap:
the port's mean and n, the JAX record's mean and n, and the two-sample
|z| (ddof=1 standard errors). A cell agrees when |z| <= 3, or when both
means lie within 0.01 (parity_report.py's rule where the variance is ~0).
The cells and the record each is held to:
- the myopic suite, `<dir>/myopic/<fn>/<acq>_gaps.csv` against
  `results/myopic/<fn>/<acq>_gaps.csv`;
- the non-myopic ladder, `<dir>/nonmyopic/<fn>/rollout_h<h>_gaps.csv`
  against `results/nonmyopic_noflag/<fn>/rollout_h<h>_gaps.csv` (the
  record without `--log10-parity`, the port's default; 30 trials a cell).

Beside them, per cell, the port's steady-state median seconds per BO
iteration (each trial's first iteration dropped: it holds the captures)
and the lane-kernel launches per BO iteration that the sweep recorded
(`<cell>_sweep.json`); on a ladder cell with h > 0 the launches give the
SGA iterations per acquisition, launches / h - 1 (fallbacks, one launch
each, included). No time of the JAX record is printed: it was taken on a
TPU. Then the cost-aware summary (cost_aware_summary.py's table) over any
directory in the cost-aware CLI's schema.

The report is printed and written to `<dir>/parity_report.txt`; the exit
status is 1 when a cell disagrees.

    python scripts/parity_report_torch.py [--dir results_torch] [--ref results]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

from parity_sweep_torch import HORIZONS, LADDER_FUNCTIONS, MYOPIC_FUNCTIONS, REPO, RULES

Z_LIMIT = 3.0
SAME_MEANS = 0.01


# -- a copy of scripts/parity_report.py:112-165 (the CSV loader and z), less
#    the reference archive's trial-number column, which no CSV here has --

def load_rows(path):
    """Numeric rows (sentinel dropped)."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        rows = list(csv.reader(fh))
    out = []
    for r in rows[1:]:
        try:
            v = [float(x) for x in r if x != ""]
        except ValueError:
            continue
        if not v or v[0] < 0:  # -1 sentinel row
            continue
        out.append(v)
    return out or None


def final_gaps(path):
    rows = load_rows(path)
    if rows is None:
        return None
    return np.asarray([r[-1] for r in rows])


def iter_times(path):
    """Flat per-iteration times, each trial's first iteration (the one that
    captures the programs) dropped."""
    rows = load_rows(path)
    if rows is None:
        return None
    return [t for v in rows for t in v[1:]] or None


def z_distance(a, b):
    """Two-sample z statistic of the mean difference (0 = identical)."""
    va = np.var(a, ddof=1) / len(a) if len(a) > 1 else 0.0
    vb = np.var(b, ddof=1) / len(b) if len(b) > 1 else 0.0
    denom = np.sqrt(va + vb)
    diff = abs(a.mean() - b.mean())
    if denom == 0:
        # both samples degenerate (zero variance): identical means are
        # exact agreement, not an infinite z
        return 0.0 if diff == 0 else float("inf")
    return diff / denom


# -- the port's verdict --

def verdict(ours, ref) -> tuple[float, str, bool]:
    """(|z|, note, agrees) of two final-gap samples."""
    z = z_distance(ours, ref)
    if z <= Z_LIMIT:
        return z, "", True
    if abs(ours.mean() - ref.mean()) < SAME_MEANS:
        return z, "means within 0.01", True
    return z, "OUTSIDE |z| <= 3", False


def cells(port: str, ref: str):
    """(block, function, label, port prefix path, ref gaps path, horizon)."""
    for fn in MYOPIC_FUNCTIONS:
        for acq in RULES:
            yield ("myopic", fn, acq, os.path.join(port, "myopic", fn, acq),
                   os.path.join(ref, "myopic", fn, f"{acq}_gaps.csv"), None)
    for fn in LADDER_FUNCTIONS:
        for h in HORIZONS:
            yield ("ladder", fn, f"h{h}", os.path.join(port, "nonmyopic", fn, f"rollout_h{h}"),
                   os.path.join(ref, "nonmyopic_noflag", fn, f"rollout_h{h}_gaps.csv"), h)


def sweep_runs(prefix: str) -> list[dict]:
    path = prefix + "_sweep.json"
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return json.load(fh)["runs"]


def gap_table(port: str, ref: str) -> tuple[list[dict], list[str]]:
    """One row per cell that both sides hold, and the table's lines."""
    rows, lines = [], []
    for block in ("myopic", "ladder"):
        where = os.path.relpath(ref, REPO)
        head = (f"== myopic final gap: port vs {where}/myopic ==" if block == "myopic" else
                f"== non-myopic ladder final gap: port vs {where}/nonmyopic_noflag ==")
        lines += ["", head, f"{'function':<16} {'cell':<7} {'port':>7} {'n':>3} {'jax':>7} "
                            f"{'n':>3} {'|z|':>6}"]
        for b, fn, label, prefix, refpath, _ in cells(port, ref):
            if b != block:
                continue
            ours, theirs = final_gaps(prefix + "_gaps.csv"), final_gaps(refpath)
            if ours is None or theirs is None:
                continue
            z, note, agrees = verdict(ours, theirs)
            rows.append(dict(block=b, function=fn, cell=label, port=float(ours.mean()),
                             n=len(ours), jax=float(theirs.mean()), n_jax=len(theirs),
                             z=z, agrees=agrees))
            zt = "   inf" if np.isinf(z) else f"{z:6.2f}"
            lines.append(f"{fn:<16} {label:<7} {ours.mean():>7.3f} {len(ours):>3} "
                         f"{theirs.mean():>7.3f} {len(theirs):>3} {zt}"
                         + (f"  ({note})" if note else ""))
    return rows, lines


def timing_table(port: str) -> tuple[list[dict], list[str]]:
    """Per cell: the steady-state median s per BO iteration, the launches
    per BO iteration, and on ladder cells with h > 0 the SGA iterations per
    acquisition they give."""
    rows = []
    lines = ["", "== port: seconds and lane-kernel launches per BO iteration (median "
                 "over iterations 2.. of each trial; launches from the sweep) =="]
    cards = sorted({r["card"] or r["device"] for _, _, _, prefix, _, _ in cells(port, "")
                    for r in sweep_runs(prefix)})
    lines.append("card: " + ("; ".join(cards) if cards else "no sweep record"))
    lines.append(f"{'function':<16} {'cell':<7} {'s/iter':>8} {'launch/iter':>11} "
                 f"{'SGA/acq':>8} {'cell s':>8}")
    for block, fn, label, prefix, _, h in cells(port, ""):
        t = iter_times(prefix + "_times.csv")
        if t is None:
            continue
        runs = sweep_runs(prefix)
        iters = sum(r["iterations"] for r in runs)
        launches = sum(r["launches"] for r in runs) / iters if iters else float("nan")
        sga = launches / h - 1 if h else float("nan")
        seconds = sum(r["seconds"] for r in runs) if runs else float("nan")
        rows.append(dict(block=block, function=fn, cell=label, s_per_iter=float(np.median(t)),
                         launches_per_iter=launches, sga_per_acq=sga, cell_seconds=seconds))
        sga_t = f"{sga:8.2f}" if h else "       -"
        lines.append(f"{fn:<16} {label:<7} {np.median(t):>8.4f} {launches:>11.2f} {sga_t} "
                     f"{seconds:>8.1f}")
    return rows, lines


def cost_aware_lines(directory: str, function: str = "braninhoo", horizon: int = 1):
    """cost_aware_summary.py's table: per mode the mean final gap and
    cumulative evaluation cost with ddof=1 standard errors."""
    base = os.path.join(directory, function)
    lines = ["", f"== cost-aware summary: {directory} ({function}, h {horizon}) ==",
             f"{'mode':<12} {'final gap':>14} {'cum cost':>14} {'n':>3}"]
    found = []
    for mode in ("uniform", "nonuniform", "gp"):
        gaps = load_rows(os.path.join(base, f"{mode}_rollout_h{horizon}_gaps.csv"))
        costs = load_rows(os.path.join(base, f"{mode}_costs.csv"))
        if gaps is None or costs is None:
            continue
        fg = np.asarray([r[-1] for r in gaps])
        cc = np.asarray([sum(r) for r in costs])
        n = len(fg)
        se = (lambda a: a.std(ddof=1) / np.sqrt(n) if n > 1 else 0.0)
        lines.append(f"{mode:<12} {fg.mean():>7.3f}±{se(fg):<5.3f}"
                     f" {cc.mean():>8.2f}±{se(cc):<4.2f} {n:>3}")
        found.append((mode, fg.mean(), cc.mean()))
    costs = dict((m, c) for m, _, c in found)
    if "uniform" in costs:
        for mode, _, c in found:
            if mode != "uniform":
                lines.append(f"{mode}: {100 * (costs['uniform'] - c) / costs['uniform']:+.1f}% "
                             "cumulative-cost savings vs the cost-blind uniform baseline")
    return found, lines


def report(port: str, ref: str, cost_aware: str | None = None) -> tuple[list[dict], str]:
    """(the gap rows, the report's text)."""
    rows, lines = gap_table(port, ref)
    lines += timing_table(port)[1]
    if cost_aware and os.path.isdir(cost_aware):
        lines += cost_aware_lines(cost_aware)[1]
    outside = [f"{r['function']}:{r['cell']}" for r in rows if not r["agrees"]]
    lines += ["", f"{len(rows)} cells, {len(outside)} outside |z| <= {Z_LIMIT:g}"
                  + (f": {' '.join(outside)}" if outside else "")]
    return rows, "\n".join(lines[1:]) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", default=os.path.join(REPO, "results_torch"),
                   help="the port's sweep output")
    p.add_argument("--ref", default=os.path.join(REPO, "results"),
                   help="the JAX package's record")
    p.add_argument("--cost-aware", default=None,
                   help="a directory in the cost-aware CLI's schema (default "
                        "<dir>/cost_aware, where it exists)")
    args = p.parse_args(argv)
    rows, text = report(args.dir, args.ref,
                        args.cost_aware or os.path.join(args.dir, "cost_aware"))
    sys.stdout.write(text)
    with open(os.path.join(args.dir, "parity_report.txt"), "w") as fh:
        fh.write(text)
    return 0 if all(r["agrees"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
