"""CSV + metadata experiment logging in the reference's schema.

Copy of `rollout_bo_tpu/utils/logging.py` (csv + numpy only).

reference: create_csv / write_to_csv (utils.jl:155-172) — header row
`trial,1..budget` followed by a sentinel row of -1s, then one appended row
per completed trial; metadata.txt dumps the run configuration
(myopic_bayesopt.jl:73-91).
"""

from __future__ import annotations

import csv
import os

import numpy as np

__all__ = ["create_csv", "write_to_csv", "write_metadata", "read_rows"]


def create_csv(path: str, budget: int, *, keep_existing: bool = True) -> None:
    """Create `<path>.csv` with the reference header + -1 sentinel row.

    With keep_existing (default) an existing file is left untouched, so a
    resumed sweep keeps the rows of already-completed trials (the
    reference always truncates, losing them — utils.jl:155-164).
    """
    if keep_existing and os.path.exists(path + ".csv"):
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["trial"] + [str(i) for i in range(1, budget + 1)])
        w.writerow([-1.0] * (budget + 1))


def write_to_csv(path: str, data) -> None:
    """Append one trial row (reference prepends no trial id; neither do we)."""
    with open(path + ".csv", "a", newline="") as fh:
        csv.writer(fh).writerow([float(v) for v in np.asarray(data).ravel()])


def read_rows(path: str) -> np.ndarray:
    """Read appended trial rows (skipping header + sentinel)."""
    with open(path + ".csv") as fh:
        rows = list(csv.reader(fh))
    return np.asarray([[float(v) for v in r] for r in rows[2:]])


def write_metadata(directory: str, **config) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "metadata.txt"), "w") as fh:
        for k, v in config.items():
            fh.write(f"{k.replace('_', ' ').title()}: {v}\n")
