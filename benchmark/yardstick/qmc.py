"""Input streams the benchmark makes: copies of the program's QMC designs
(`rollout_bo_tpu_torch/ops/qmc.py`), so that the inputs and the
reference's copy of the program's own streams cannot move with a change to
the program. NumPy and SciPy only.

- `normals(samples, d, horizon)`: the (samples, d + 1, horizon) normal
  stream of one acquisition: unscrambled Sobol points without the zero
  point, Box-Muller over column pairs, laid out column-major;
- `starts(n, lbs, ubs, eps)`: n Sobol points in the box and the two
  eps-interior corners, (n + 2, d);
- `uniform(rng, n, lbs, ubs)`: n uniform points in the box.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import qmc as _qmc


def sobol(n: int, dim: int, start: int = 0) -> np.ndarray:
    s = _qmc.Sobol(d=dim, scramble=False)
    s.fast_forward(1 + start)
    return s.random(n)


def box_muller(S: np.ndarray) -> np.ndarray:
    n, dim = S.shape
    N = np.empty_like(S)
    for i in range(dim):
        if i % 2 == 0:
            N[:, i] = np.sqrt(-2.0 * np.log(S[:, i])) * np.cos(2.0 * np.pi * S[:, i + 1])
        else:
            N[:, i] = np.sqrt(-2.0 * np.log(S[:, i - 1])) * np.sin(2.0 * np.pi * S[:, i])
    return N


def normals(samples: int, dim: int, horizon: int) -> np.ndarray:
    width = dim + 1
    offset = 1 if width % 2 == 1 else 0
    N = box_muller(sobol(samples * horizon, width + offset))
    N = np.reshape(N, (samples, horizon, width + offset), order="F").transpose(0, 2, 1)
    return N[:, :width, :]


def starts(n: int, lbs, ubs, eps: float) -> np.ndarray:
    lbs, ubs = np.asarray(lbs, dtype=float), np.asarray(ubs, dtype=float)
    pts = lbs + (ubs - lbs) * sobol(n, len(lbs))
    return np.concatenate([pts, (lbs + eps)[None, :], (ubs - eps)[None, :]], axis=0)


def uniform(rng: np.random.Generator, n: int, lbs, ubs) -> np.ndarray:
    lbs, ubs = np.asarray(lbs, dtype=float), np.asarray(ubs, dtype=float)
    return lbs + (ubs - lbs) * rng.uniform(size=(n, len(lbs)))
