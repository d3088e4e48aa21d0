"""Synthetic test functions (PyTorch, differentiable).

Port of `rollout_bo_tpu/models/testfns.py` (reference `testfns.jl`). Each
function maps a tensor (..., d) to (...); gradients come from
`torch.autograd`. Only the trid family, the benchmark's function, is
ported so far; the registry grows with the rest of the suite.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["TestFunction", "get_function", "FUNCTION_REGISTRY"]


@dataclasses.dataclass(frozen=True)
class TestFunction:
    """dim / bounds / xopt / f container (reference testfns.jl:5-11)."""

    dim: int
    bounds: np.ndarray          # (dim, 2)
    xopt: tuple                 # tuple of optimizer locations
    f: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x):
        return self.f(x)

    def batch(self, X):
        """f over the rows of X (N, d) -> (N,)."""
        return self.f(X)

    def grad(self, x):
        """d f / d x at x (..., d), by autograd."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.f(x).sum(), x)
        return g

    @property
    def lbs(self) -> np.ndarray:
        return self.bounds[:, 0]

    @property
    def ubs(self) -> np.ndarray:
        return self.bounds[:, 1]

    @property
    def fmin(self) -> float:
        return min(float(self.f(torch.as_tensor(x, dtype=torch.float64)))
                   for x in self.xopt)


def _box(d, lo, hi):
    b = np.zeros((d, 2))
    b[:, 0], b[:, 1] = lo, hi
    return b


def trid(d):  # reference testfns.jl:438
    def f(x):
        return (torch.sum((x - 1.0) ** 2, dim=-1)
                - torch.sum(x[..., 1:] * x[..., :-1], dim=-1))
    xo = np.array([(i + 1) * (d - i) for i in range(d)], dtype=float)
    return TestFunction(d, _box(d, -float(d**2), float(d**2)), (xo,), f)


FUNCTION_REGISTRY: dict[str, Callable[[], TestFunction]] = {
    "trid1d": lambda: trid(1),
    "trid2d": lambda: trid(2),
    "trid3d": lambda: trid(3),
    "trid4d": lambda: trid(4),
    "trid10d": lambda: trid(10),
}


def get_function(name: str) -> TestFunction:
    """Look up a test function by experiment name (e.g. 'trid10d')."""
    try:
        return FUNCTION_REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"Unknown test function {name!r}; known: {sorted(FUNCTION_REGISTRY)}"
        ) from None
