"""Synthetic test-function suite (PyTorch, differentiable).

Port of `rollout_bo_tpu/models/testfns.py` (reference `testfns.jl`, ~40
constructors). Each function maps a tensor (..., d) to (...): coordinates
are read as `x[..., i]`, so one call evaluates any batch of points, on the
tensor's own device and dtype. Gradients come from `torch.autograd`, which
also supplies exact gradients for the functions whose reference gradients
are `zeros` stubs (testfns.jl:385-559).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["TestFunction", "get_function", "FUNCTION_REGISTRY", "tplot"]


@dataclasses.dataclass(frozen=True)
class TestFunction:
    """dim / bounds / xopt / f container (reference testfns.jl:5-11)."""

    dim: int
    bounds: np.ndarray          # (dim, 2)
    xopt: tuple                 # tuple of optimizer locations
    f: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x):
        return self.f(torch.as_tensor(x))

    def batch(self, X):
        """f over the rows of X (N, d) -> (N,)."""
        return self.f(torch.as_tensor(X))

    def grad(self, x):
        """d f / d x at x (..., d), by autograd."""
        with torch.enable_grad():
            x = torch.as_tensor(x).detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.f(x).sum(), x)
        return g

    def batch_grad(self, X):
        """Gradients at the rows of X (N, d) -> (N, d): the rows do not
        interact, so one backward pass of the sum gives them all."""
        return self.grad(X)

    @property
    def lbs(self) -> np.ndarray:
        return self.bounds[:, 0]

    @property
    def ubs(self) -> np.ndarray:
        return self.bounds[:, 1]

    @property
    def fmin(self) -> float:
        return min(float(self.f(torch.as_tensor(np.asarray(x), dtype=torch.float64)))
                   for x in self.xopt)

    # -- combinators (testfns.jl:42-94) ------------------------------------
    def __add__(self, other: "TestFunction") -> "TestFunction":
        assert self.dim == other.dim
        return TestFunction(self.dim, _collapse_bounds(self, other), (np.zeros(self.dim),),
                            lambda x: self.f(x) + other.f(x))

    def __mul__(self, other: "TestFunction") -> "TestFunction":
        assert self.dim == other.dim
        return TestFunction(self.dim, _collapse_bounds(self, other), (np.zeros(self.dim),),
                            lambda x: self.f(x) * other.f(x))

    def scalar_scale(self, s: float) -> "TestFunction":
        return TestFunction(self.dim, self.bounds * s,
                            tuple(np.asarray(x) * s for x in self.xopt),
                            lambda x: self.f(x / s))

    def vshift(self, s: float) -> "TestFunction":
        return TestFunction(self.dim, self.bounds, self.xopt, lambda x: self.f(x) + s)

    def hshift(self, s) -> "TestFunction":
        s = np.asarray(s, dtype=float)
        shift = _tables(s)
        return TestFunction(self.dim, self.bounds,
                            tuple(np.asarray(x) + s for x in self.xopt),
                            lambda x: self.f(x + shift(x)[0]))


def tplot(t: TestFunction, *, num_points: int = 200, ax=None, levels: int = 30):
    """Plot a 1-D curve or 2-D contour of a test function.

    reference: tplot (testfns.jl:99-114). matplotlib is imported lazily so
    the package has no hard plotting dependency; raises for dim > 2 like
    the reference.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    lbs, ubs = t.lbs, t.ubs
    if t.dim == 1:
        xs = np.linspace(lbs[0], ubs[0], num_points)
        ax.plot(xs, t.batch(xs[:, None]).numpy())
        ax.set_xlabel("x")
        ax.set_ylabel("f(x)")
    elif t.dim == 2:
        xs = np.linspace(lbs[0], ubs[0], num_points)
        ys = np.linspace(lbs[1], ubs[1], num_points)
        XX, YY = np.meshgrid(xs, ys)
        pts = np.stack([XX.ravel(), YY.ravel()], axis=1)
        cs = ax.contourf(XX, YY, t.batch(pts).numpy().reshape(XX.shape), levels=levels)
        ax.figure.colorbar(cs, ax=ax)
        ax.set_xlabel("x1")
        ax.set_ylabel("x2")
    else:
        raise ValueError("Can only plot 1- or 2-dimensional TestFunctions")
    return ax


def _collapse_bounds(t1: TestFunction, t2: TestFunction) -> np.ndarray:
    """Per-dim bound closest to the origin (testfns.jl:26-39)."""
    lo = np.stack([t1.bounds[:, 0], t2.bounds[:, 0]], 1)
    hi = np.stack([t1.bounds[:, 1], t2.bounds[:, 1]], 1)
    pick = lambda a: a[np.arange(a.shape[0]), np.argmin(np.abs(a), axis=1)]
    return np.stack([pick(lo), pick(hi)], axis=1)


def _box(d, lo, hi):
    b = np.zeros((d, 2))
    b[:, 0], b[:, 1] = lo, hi
    return b


def _tables(*arrays: np.ndarray):
    """tables(x) -> the numpy `arrays` as tensors of x's dtype on x's
    device, made on the first call for that (dtype, device) and kept by the
    function that holds `tables`: a later call copies nothing from the
    host, so that the function evaluates inside a CUDA graph's capture,
    which refuses such a copy."""
    made: dict = {}

    def tables(x):
        key = (x.dtype, x.device)
        if key not in made:
            made[key] = tuple(torch.as_tensor(a, dtype=x.dtype, device=x.device)
                              for a in arrays)
        return made[key]

    return tables


_PI = math.pi

# --------------------------------------------------------------------------
# Families (reference line numbers in comments)
# --------------------------------------------------------------------------


def levy(d):  # testfns.jl:116
    def f(x):
        w = 1.0 + (x - 1.0) / 4.0
        head, last = w[..., :-1], w[..., -1]
        t1 = torch.sin(_PI * w[..., 0]) ** 2
        ts = torch.sum((head - 1.0) ** 2 * (1.0 + 10.0 * torch.sin(_PI * head + 1.0) ** 2),
                       dim=-1)
        t3 = (last - 1.0) ** 2 * (1.0 + torch.sin(2.0 * _PI * last) ** 2)
        return t1 + ts + t3
    return TestFunction(d, _box(d, -10.0, 10.0), (np.ones(d),), f)


def braninhoo(a=1.0, b=5.1 / (4 * np.pi**2), c=5 / np.pi, r=6.0, s=10.0, t=1 / (8 * np.pi)):  # :136
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s
    return TestFunction(2, np.array([[-5.0, 10.0], [0.0, 15.0]]),
                        (np.array([-np.pi, 12.275]), np.array([np.pi, 2.275]),
                         np.array([9.42478, 2.475])), f)


def rosenbrock():  # :155
    f = lambda x: (1 - x[..., 0]) ** 2 + 100.0 * (x[..., 1] - x[..., 0] ** 2) ** 2
    return TestFunction(2, np.array([[-2.0, 2.0], [-1.0, 3.0]]), (np.ones(2),), f)


def rastrigin(d):  # :162
    f = lambda x: 10.0 * d + torch.sum(x**2 - 10.0 * torch.cos(2 * _PI * x), dim=-1)
    return TestFunction(d, _box(d, -5.12, 5.12), (np.zeros(d),), f)


def ackley(d, a=20.0, b=0.2, c=2 * np.pi):  # :173
    def f(x):
        nx = torch.sqrt(torch.sum(x * x, dim=-1) + 1e-300)
        cx = torch.sum(torch.cos(c * x), dim=-1)
        return -a * torch.exp(-b / math.sqrt(d) * nx) - torch.exp(cx / d) + a + math.e
    return TestFunction(d, _box(d, -32.768, 32.768), (np.zeros(d),), f)


def sixhump():  # :202
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return (4.0 - 2.1 * x**2 + x**4 / 3) * x**2 + x * y + (-4.0 + 4.0 * y**2) * y**2
    return TestFunction(2, np.array([[-3.0, 3.0], [-2.0, 2.0]]),
                        (np.array([0.089842, -0.712656]), np.array([-0.089842, 0.712656])), f)


def gramacylee():  # :227
    def f(x):
        x0 = x[..., 0]
        return torch.sin(10 * _PI * x0) / (2 * x0) + (x0 - 1.0) ** 4
    return TestFunction(1, np.array([[0.5, 2.5]]), (np.array([0.548563]),), f)


def goldsteinprice():  # :238
    def f(xy):
        x1, x2 = xy[..., 0], xy[..., 1]
        t1 = 1 + (x1 + x2 + 1) ** 2 * (19 - 14 * x1 + 3 * x1**2 - 14 * x2 + 6 * x1 * x2 + 3 * x2**2)
        t2 = 30 + (2 * x1 - 3 * x2) ** 2 * (18 - 32 * x1 + 12 * x1**2 + 48 * x2 - 36 * x1 * x2 + 27 * x2**2)
        return t1 * t2
    return TestFunction(2, _box(2, -2.0, 2.0), (np.array([0.0, -1.0]),), f)


def beale():  # :280
    def f(xy):
        x1, x2 = xy[..., 0], xy[..., 1]
        return ((1.5 - x1 + x1 * x2) ** 2 + (2.25 - x1 + x1 * x2**2) ** 2
                + (2.625 - x1 + x1 * x2**3) ** 2)
    return TestFunction(2, _box(2, -4.5, 4.5), (np.array([3.0, 0.5]),), f)


def easom():  # :313
    def f(x):
        x0, x1 = x[..., 0], x[..., 1]
        return -torch.cos(x0) * torch.cos(x1) * torch.exp(-((x0 - _PI) ** 2 + (x1 - _PI) ** 2))
    return TestFunction(2, _box(2, -100.0, 100.0), (np.array([np.pi, np.pi]),), f)


def styblinskitang(d):  # :342
    f = lambda x: 0.5 * torch.sum(x**4 - 16.0 * x**2 + 5.0 * x, dim=-1)
    return TestFunction(d, _box(d, -5.0, 5.0), (np.full(d, -2.903534),), f)


def bukinn6():  # :353
    def f(x):
        x0, x1 = x[..., 0], x[..., 1]
        return (100.0 * torch.sqrt(torch.abs(x1 - 0.01 * x0**2) + 1e-300)
                + 0.01 * torch.abs(x0 + 10.0))
    b = np.array([[-15.0, 3.0], [-15.0, 3.0]])
    return TestFunction(2, b, (np.array([-10.0, 1.0]),), f)


def _radius(x):
    return torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + 1e-300)


def crossintray():  # :383
    def f(x):
        t = torch.abs(torch.sin(x[..., 0]) * torch.sin(x[..., 1])
                      * torch.exp(torch.abs(100.0 - _radius(x) / _PI))) + 1.0
        return -0.0001 * t**0.1
    return TestFunction(2, _box(2, -10.0, 10.0), (np.full(2, 1.34941),), f)


def eggholder():  # :394
    def f(x):
        x0, x1 = x[..., 0], x[..., 1]
        return (-(x1 + 47.0) * torch.sin(torch.sqrt(torch.abs(x1 + x0 / 2 + 47.0) + 1e-300))
                - x0 * torch.sin(torch.sqrt(torch.abs(x0 - (x1 + 47.0)) + 1e-300)))
    return TestFunction(2, _box(2, -512.0, 512.0), (np.array([512.0, 404.2319]),), f)


def holdertable():  # :405
    def f(x):
        return -torch.abs(torch.sin(x[..., 0]) * torch.cos(x[..., 1])
                          * torch.exp(torch.abs(1.0 - _radius(x) / _PI)))
    return TestFunction(2, _box(2, -10.0, 10.0), (np.array([8.05502, 9.66459]),), f)


def schwefel(d):  # :416
    f = lambda x: 418.9829 * d - torch.sum(
        x * torch.sin(torch.sqrt(torch.abs(x) + 1e-300)), dim=-1)
    return TestFunction(d, _box(d, -500.0, 500.0), (np.full(d, 420.9687),), f)


def levyn13():  # :427
    def f(x):
        x0, x1 = x[..., 0], x[..., 1]
        return (torch.sin(3 * _PI * x0) ** 2
                + (x0 - 1) ** 2 * (1 + torch.sin(3 * _PI * x1) ** 2)
                + (x1 - 1) ** 2 * (1 + torch.sin(2 * _PI * x1) ** 2))
    return TestFunction(2, _box(2, -10.0, 10.0), (np.ones(2),), f)


def trid(d):  # :438
    def f(x):
        return (torch.sum((x - 1.0) ** 2, dim=-1)
                - torch.sum(x[..., 1:] * x[..., :-1], dim=-1))
    xo = np.array([(i + 1) * (d - i) for i in range(d)], dtype=float)
    return TestFunction(d, _box(d, -float(d**2), float(d**2)), (xo,), f)


def mccormick():  # :449
    def f(x):
        x0, x1 = x[..., 0], x[..., 1]
        return torch.sin(x0 + x1) + (x0 - x1) ** 2 - 1.5 * x0 + 2.5 * x1 + 1.0
    return TestFunction(2, _box(2, -1.5, 4.0), (np.array([-0.54719, -1.54719]),), f)


_H3_A = np.array([[3.0, 10, 30], [0.1, 10, 35], [3.0, 10, 30], [0.1, 10, 35]])
_H3_P = 1e-4 * np.array([[3689, 1170, 2673], [4699, 4387, 7470], [1091, 8732, 5547], [381, 5743, 8828]])
_H6_A = np.array([[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
                  [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
_H6_P = 1e-4 * np.array([[1312, 1696, 5569, 124, 8283, 5886], [2329, 4135, 8307, 3736, 1004, 9991],
                         [2348, 1451, 3522, 2883, 3047, 6650], [4047, 8828, 8732, 5743, 1091, 381]])
_H_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])


def _hartmann(A, P, d, xopt):
    tables = _tables(A, P, _H_ALPHA)

    def f(x):
        a, p, alpha = tables(x)
        t = torch.sum(a * (x[..., None, :] - p) ** 2, dim=-1)
        return -torch.sum(alpha * torch.exp(-t), dim=-1)
    return TestFunction(d, _box(d, 0.0, 1.0), (np.asarray(xopt),), f)


def hartmann3d():  # :460
    return _hartmann(_H3_A, _H3_P, 3, [0.114614, 0.555649, 0.852547])


def hartmann4d():  # :496 (reference's "4D" actually evaluates the 6-D form)
    return _hartmann(_H6_A, _H6_P, 6, [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573])


def hartmann6d():  # :532
    return _hartmann(_H6_A, _H6_P, 6, [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573])


def constant(n=0.0, *, lbs: Sequence[float], ubs: Sequence[float]):  # :568
    d = len(lbs)
    return TestFunction(d, np.stack([np.asarray(lbs, float), np.asarray(ubs, float)], 1),
                        (np.zeros(d),), lambda x: n + 0.0 * x[..., 0])


def quadratic1d(a=1.0, b=0.0, c=0.0, lb=-1.0, ub=1.0):  # :577
    return TestFunction(1, np.array([[lb, ub]]), (np.zeros(1),),
                        lambda x: a * x[..., 0] ** 2 + b * x[..., 0] + c)


def linearcosine1d(a=1.0, b=1.0, lb=-1.0, ub=1.0):  # :588
    return TestFunction(1, np.array([[lb, ub]]), (np.zeros(1),),
                        lambda x: a * x[..., 0] * torch.cos(b * x[..., 0]))


_SHEKEL_C = np.array([[4.0, 1, 8, 6, 3, 2, 5, 8, 6, 7], [4.0, 1, 8, 6, 7, 9, 3, 1, 2, 3],
                      [4.0, 1, 8, 6, 3, 2, 5, 8, 6, 7], [4.0, 1, 8, 6, 7, 9, 3, 1, 2, 3]])
_SHEKEL_B = np.array([0.1, 0.2, 0.2, 0.4, 0.4, 0.6, 0.3, 0.7, 0.5, 0.5])


def shekel():  # :598
    tables = _tables(_SHEKEL_C, _SHEKEL_B)

    def f(x):
        c, b = tables(x)
        t = torch.sum((x[..., :, None] - c) ** 2, dim=-2)
        return -torch.sum(1.0 / (t + b), dim=-1)
    return TestFunction(4, _box(4, 0.0, 10.0), (np.full(4, 4.0),), f)


def dropwave():  # :638
    def f(x):
        s = torch.sum(x * x, dim=-1)
        return -(1.0 + torch.cos(12.0 * torch.sqrt(s + 1e-300))) / (0.5 * s + 2.0)
    return TestFunction(2, _box(2, -5.12, 5.12), (np.zeros(2),), f)


def griewank(d):  # :695 (last definition wins in the reference)
    idx = _tables(np.sqrt(np.arange(1, d + 1, dtype=float)))
    f = lambda x: (1.0 + torch.sum(x * x, dim=-1) / 4000.0
                   - torch.prod(torch.cos(x / idx(x)[0]), dim=-1))
    return TestFunction(d, _box(d, -600.0, 600.0), (np.zeros(d),), f)


def bohachevsky():  # :677
    def f(x):
        x0, x1 = x[..., 0], x[..., 1]
        return (x0**2 + 2 * x1**2 - 0.3 * torch.cos(3 * _PI * x0)
                - 0.4 * torch.cos(4 * _PI * x1) + 0.7)
    return TestFunction(2, _box(2, -100.0, 100.0), (np.zeros(2),), f)


# --------------------------------------------------------------------------
# Registry: names match the experiment CLIs' --function-name payloads
# --------------------------------------------------------------------------

FUNCTION_REGISTRY: dict[str, Callable[[], TestFunction]] = {
    "gramacylee": gramacylee,
    "rastrigin1d": lambda: rastrigin(1),
    "rastrigin4d": lambda: rastrigin(4),
    "ackley1d": lambda: ackley(1),
    "ackley2d": lambda: ackley(2),
    "ackley3d": lambda: ackley(3),
    "ackley4d": lambda: ackley(4),
    "ackley5d": lambda: ackley(5),
    "ackley8d": lambda: ackley(8),
    "ackley10d": lambda: ackley(10),
    "ackley16d": lambda: ackley(16),
    "rosenbrock": rosenbrock,
    "sixhump": sixhump,
    "braninhoo": braninhoo,
    "hartmann3d": hartmann3d,
    "goldsteinprice": goldsteinprice,
    "beale": beale,
    "easom": easom,
    "styblinskitang1d": lambda: styblinskitang(1),
    "styblinskitang2d": lambda: styblinskitang(2),
    "styblinskitang3d": lambda: styblinskitang(3),
    "styblinskitang4d": lambda: styblinskitang(4),
    "styblinskitang10d": lambda: styblinskitang(10),
    "bukinn6": bukinn6,
    "crossintray": crossintray,
    "eggholder": eggholder,
    "holdertable": holdertable,
    "schwefel1d": lambda: schwefel(1),
    "schwefel2d": lambda: schwefel(2),
    "schwefel3d": lambda: schwefel(3),
    "schwefel4d": lambda: schwefel(4),
    "schwefel10d": lambda: schwefel(10),
    "levyn13": levyn13,
    "trid1d": lambda: trid(1),
    "trid2d": lambda: trid(2),
    "trid3d": lambda: trid(3),
    "trid4d": lambda: trid(4),
    "trid10d": lambda: trid(10),
    "mccormick": mccormick,
    "hartmann6d": hartmann6d,
    "hartmann4d": hartmann4d,
    "rastrigin2d": lambda: rastrigin(2),
    "levy2d": lambda: levy(2),
    "levy3d": lambda: levy(3),
    "levy5d": lambda: levy(5),
    "levy10d": lambda: levy(10),
    "griewank1d": lambda: griewank(1),
    "griewank2d": lambda: griewank(2),
    "griewank3d": lambda: griewank(3),
    "shekel": shekel,
    "shekel4d": shekel,  # reference payload name (adaptive_bayesopt.jl:375)
    "dropwave": dropwave,
    "bohachevsky": bohachevsky,
}


def get_function(name: str) -> TestFunction:
    """Look up a test function by experiment name (e.g. 'ackley5d')."""
    try:
        return FUNCTION_REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"Unknown test function {name!r}; known: {sorted(FUNCTION_REGISTRY)}"
        ) from None
