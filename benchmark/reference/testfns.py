"""The benchmark's own test functions: the true objectives of the
configurations (hartmann6d) in plain PyTorch, in the dtype of
their input, with their boxes. Nothing here imports the program under test."""

from __future__ import annotations

import numpy as np
import torch

_H6_A = [[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
         [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]]
_H6_P = [[1312, 1696, 5569, 124, 8283, 5886], [2329, 4135, 8307, 3736, 1004, 9991],
         [2348, 1451, 3522, 2883, 3047, 6650], [4047, 8828, 8732, 5743, 1091, 381]]
_H_ALPHA = [1.0, 1.2, 3.0, 3.2]


def hartmann6d(X: torch.Tensor) -> torch.Tensor:
    """-sum_i alpha_i exp(-sum_j A_ij (x_j - P_ij)^2) at the rows of X (..., 6)."""
    t = lambda a: torch.tensor(a, dtype=X.dtype, device=X.device)  # noqa: E731
    A, P, alpha = t(_H6_A), 1e-4 * t(_H6_P), t(_H_ALPHA)
    r = torch.sum(A * (X[..., None, :] - P) ** 2, dim=-1)
    return -torch.sum(alpha * torch.exp(-r), dim=-1)


FUNCTIONS = {
    "hartmann6d": (hartmann6d, 6, 0.0, 1.0),
}


def get(name: str):
    """(f, d, lbs (d,), ubs (d,)) of the function `name`, the box as NumPy."""
    f, d, lo, hi = FUNCTIONS[name]
    return f, d, np.full(d, lo), np.full(d, hi)
