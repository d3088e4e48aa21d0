"""Quasi-Monte-Carlo streams: Sobol / Kronecker sequences + Box-Muller.

Copy of `rollout_bo_tpu/ops/qmc.py` (numpy + scipy only; the JAX package
cannot be imported here because its `__init__` imports jax). Re-design of
the reference's QMC layer (`low_discrepancy.jl`, `utils.jl:1-84`).

Streams are generated host-side with numpy (they are *inputs* to the
rollout computation, fixed per acquisition evaluation for common-random-
number variance reduction) and copied to the device once.

Reference quirk (utils.jl:33-35): the reference's Box-Muller uses `log10`
instead of the natural log, so its "standard normals" have variance
log10(e) ~ 0.434 of a true standard normal. We implement the correct
transform by default and keep `log10_parity=True` to reproduce reference
streams bit-for-bit in comparison runs.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import qmc as _scipy_qmc

__all__ = [
    "kronecker_quasirand",
    "bkronecker_quasirand",
    "sobol_uniform",
    "box_muller",
    "gen_low_discrepancy_sequence",
    "randsample",
    "generate_initial_guesses",
    "generate_batch",
]


def kronecker_quasirand(d: int, n: int, start: int = 0) -> np.ndarray:
    """Additive Kronecker sequence in [0,1]^d, shape (n, d).

    Generalized-golden-ratio construction; reference:
    low_discrepancy.jl:7-28 (which returns the (d, n) transpose).
    """
    phi = 1.0 + 1.0 / d
    for _ in range(10):
        g = phi ** (d + 1) - phi - 1.0
        dg = (d + 1) * phi**d - 1.0
        phi -= g / dg
    alphas = np.array([np.mod(1.0 / phi ** (j + 1), 1.0) for j in range(d)])
    idx = np.arange(1, n + 1)[:, None] + start
    return np.mod(0.5 + idx * alphas[None, :], 1.0)


def bkronecker_quasirand(d: int, n: int, lbs, ubs, start: int = 0) -> np.ndarray:
    """Kronecker sequence scaled into the box [lbs, ubs], shape (n, d).

    reference: bkronecker_quasirand (low_discrepancy.jl:31-43).
    """
    lbs, ubs = np.asarray(lbs, float), np.asarray(ubs, float)
    return lbs + (ubs - lbs) * kronecker_quasirand(d, n, start)


def sobol_uniform(n: int, dim: int = 1, *, skip_zero: bool = True,
                  start: int = 0) -> np.ndarray:
    """Unscrambled Sobol points in [0,1]^dim, shape (n, dim).

    Julia's Sobol.jl `next!` never emits the all-zeros point (reference
    utils.jl:4-13 relies on that — a zero would blow up Box-Muller), so we
    skip it too by default. `start` fast-forwards a further `start` points
    (disjoint stream segments for successive BO iterations).
    """
    s = _scipy_qmc.Sobol(d=dim, scramble=False)
    s.fast_forward((1 if skip_zero else 0) + start)
    return s.random(n)


def box_muller(S: np.ndarray, *, log10_parity: bool = False) -> np.ndarray:
    """Box-Muller transform of uniforms (n, dim) -> normals (n, dim).

    Pairs column i (odd, 1-based) with column i+1 as in the reference
    (utils.jl:23-43). `log10_parity=True` reproduces the reference's
    `log10` quirk (its draws are N(0, log10(e)) rather than N(0,1)).
    """
    S = np.asarray(S)
    n, dim = S.shape
    log = np.log10 if log10_parity else np.log
    N = np.empty_like(S)
    for i in range(dim):
        if i % 2 == 0:  # odd 1-based
            N[:, i] = np.sqrt(-2.0 * log(S[:, i])) * np.cos(2.0 * np.pi * S[:, i + 1])
        else:
            N[:, i] = np.sqrt(-2.0 * log(S[:, i - 1])) * np.sin(2.0 * np.pi * S[:, i])
    return N


def gen_low_discrepancy_sequence(
    samples: int, dim: int, horizon: int, *, log10_parity: bool = False,
    start: int = 0,
) -> np.ndarray:
    """Low-discrepancy normal tensor of shape (samples, dim+1, horizon).

    One (f, grad f) joint draw column per trajectory step; reference:
    utils.jl:65-74 (M x (d+1) x (h+1) rollout sample tensor). `start`
    offsets into the Sobol stream by `start * samples * horizon` points so
    successive BO iterations can consume disjoint QMC segments.
    """
    width = dim + 1
    offset = 1 if width % 2 == 1 else 0
    S = sobol_uniform(samples * horizon, dim=width + offset,
                      start=start * samples * horizon)
    N = box_muller(S, log10_parity=log10_parity)
    # reference reshapes column-major (Julia); replicate that layout
    N = np.reshape(N, (samples, horizon, width + offset), order="F").transpose(0, 2, 1)
    return N[:, :width, :]


def randsample(n: int, d: int, lbs, ubs, rng: np.random.Generator | None = None) -> np.ndarray:
    """Uniform random points in the box, shape (n, d) (reference utils.jl:76-84)."""
    rng = rng or np.random.default_rng()
    lbs, ubs = np.asarray(lbs), np.asarray(ubs)
    return lbs + (ubs - lbs) * rng.uniform(size=(n, d))


def generate_initial_guesses(n: int, lbs, ubs, eps: float = 1e-6) -> np.ndarray:
    """Sobol multistart guesses + epsilon-interior corner points, (n+2, d).

    reference: generate_initial_guesses (utils.jl:145-153).
    """
    lbs, ubs = np.asarray(lbs, dtype=float), np.asarray(ubs, dtype=float)
    pts = lbs + (ubs - lbs) * sobol_uniform(n, dim=len(lbs))
    return np.concatenate([pts, (lbs + eps)[None, :], (ubs - eps)[None, :]], axis=0)


def generate_batch(n: int, lbs, ubs, eps_interior: float = 1e-2) -> np.ndarray:
    """Sobol batch + interior near-bound points, (n+2, d) (reference utils.jl:97-106)."""
    return generate_initial_guesses(n, lbs, ubs, eps=eps_interior)
