"""The hyperparameter MLE of a GP: every projected-Adam step in one launch.

`models/surrogate.py::optimize_hypers` fits the kernel hyperparameters by
`iterations` projected Adam steps on log theta (0.9, 0.999, 1e-8, step
`lr`, each step clamped to [log lb, log ub]) with the closed-form gradient
of the log marginal likelihood of the active n x n block (reference
radial_basis_surrogates.jl:778-799):

    d log p / d log theta_k = sum_{i > j} (alpha_i alpha_j - Kinv_ij) dK_ij,

alpha = K^{-1} y, dK = d K / d log theta_k (`ops.kernels.profile_dlog_theta`,
0 on the diagonal). A step at which K(theta) is not positive definite has
gradient 0, and a non-finite component is zeroed, so that step only decays
the moments: the NaN contract of the JAX package's `jax.grad` loop.

- `gp_mle` is the entry point. For CUDA tensors it launches the
  hand-written kernel `csrc/gp_mle.cu` (one block per GP, the whole loop
  inside it, n read on the device); it raises rather than fall back. For
  CPU tensors it runs the plain version.
- `gp_mle_ref` is the plain PyTorch version: the same iteration, batch-first
  over the lane axes, with the gradient from `log_likelihood_grad_log`. The
  CPU tests hold it against autograd and the JAX package; the emulation test
  and `chip_smoke.py` hold the kernel against it.

Every field may carry leading lane axes (one GP per lane; the kernel's grid
runs over them); theta comes back with them: (..., P), P = 2 for
"periodic" (lengthscale, period), else 1.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as kern

__all__ = [
    "KINDS",
    "LAUNCHES",
    "RECORDED",
    "hypers",
    "log_likelihood_grad_log",
    "gp_mle",
    "gp_mle_ref",
    "mle_work",
]

# the kernel's kind ids: the order of csrc/gp_mle.cu
KINDS = ("matern52", "matern32", "matern12", "squared_exponential", "periodic")
_BETAS = (0.9, 0.999)
_ADAM_EPS = 1e-8
_THREADS = 1024                # per block on the card
_SMEM_LIMIT = 227 * 1024       # Hopper: dynamic shared memory per block
_ENTRY = {torch.float32: "gp_mle_f32", torch.float64: "gp_mle_f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 5 + [ctypes.c_double] + [_I] * 3 + [_P]

# Kernel launches since the counter was last reset (set it to 0 to count);
# a CUDA graph's replay adds the launches it holds (`utils.graphs`).
LAUNCHES = 0
# Launches recorded into a CUDA graph under capture: they run nothing then,
# and run at each replay of the graph, which adds them to LAUNCHES.
RECORDED = 0


def hypers(kind: str) -> int:
    """The kind's number of hyperparameters."""
    return 2 if kind == "periodic" else 1


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------


def log_likelihood_grad_log(kind: str, X, y, n, noise, theta):
    """d log p / d log theta (..., P) of the active block, in closed form;
    NaN where K(theta) is not positive definite. X (..., cap, d), y (...,
    cap), n (...) int64, noise a scalar tensor, theta (..., P) or (P,)."""
    dt, dev = X.dtype, X.device
    cap = X.shape[-2]
    th = theta.movedim(-1, 0)[..., None, None]          # th[k]: (..., 1, 1)
    rho = kern._safe_norm(X[..., :, None, :] - X[..., None, :, :])
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    K = torch.where(eye, 1.0 + noise, kern._profile(kind, rho, th, 0))   # psi(0) = 1
    m = chol_ops.active_mask(cap, n, dtype=torch.bool, device=dev)
    both = m[..., :, None] & m[..., None, :]
    L, info = torch.linalg.cholesky_ex(torch.where(both, K, eye.to(dt)))
    Li = chol_ops.tri_inv_padded(L)
    alpha = chol_ops.psd_apply(Li, y * m.to(dt))
    W = alpha[..., :, None] * alpha[..., None, :] - Li.transpose(-1, -2) @ Li
    below = both & torch.ones((cap, cap), dtype=torch.bool, device=dev).tril(-1)
    G = torch.stack([torch.sum(torch.where(below, W * dk, 0.0), dim=(-2, -1))
                     for dk in kern.profile_dlog_theta(kind, rho, th)], dim=-1)
    return torch.where((info != 0)[..., None], torch.nan, G)


def gp_mle_ref(kind: str, X, y, n, noise, theta, lb, ub, *, iterations: int = 60,
               lr: float = 0.1):
    """The plain version of `gp_mle`: theta (..., P)."""
    b1, b2 = _BETAS
    log_lb, log_ub = torch.log(lb), torch.log(ub)
    lt = torch.clamp(torch.log(theta), log_lb, log_ub).expand(
        X.shape[:-2] + (hypers(kind),))
    m, v = torch.zeros_like(lt), torch.zeros_like(lt)
    for i in range(iterations):
        g = -log_likelihood_grad_log(kind, X, y, n, noise, torch.exp(lt))
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** (i + 1))
        vhat = v / (1 - b2 ** (i + 1))
        lt = torch.clamp(lt - lr * mhat / (torch.sqrt(vhat) + _ADAM_EPS), log_lb, log_ub)
    return torch.exp(lt)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------


class Layout(NamedTuple):
    """Where a launch keeps its matrices (`_layout`)."""
    staged: bool            # S, the distances and X in shared memory
    smem: int               # dynamic shared bytes per block
    scratch: int            # elements per GP in device memory (0 where staged)


def _layout(cap: int, d: int, itemsize: int, iterations: int, threads: int = _THREADS,
            smem_limit: int = _SMEM_LIMIT) -> Layout:
    """The shape's layout; must match gp_mle_kernel's carve-up: S (cap x
    (cap | 1)), the packed distances and X, then five cap-vectors, two
    gradient parts per warp, theta, Adam's state and the log bounds (2
    each) and the bias corrections (2 x iterations)."""
    big = cap * (cap | 1) + cap * (cap - 1) // 2 + cap * d
    small = 5 * cap + 2 * (threads // 32) + 12 + 2 * iterations
    if (big + small) * itemsize <= smem_limit:
        return Layout(True, (big + small) * itemsize, 0)
    if small * itemsize > smem_limit:
        raise ValueError(f"gp_mle: capacity {cap} leaves no room for the block's vectors")
    return Layout(False, small * itemsize, big)


def _library():
    from rollout_bo_tpu_torch.ops import _build

    lib = _build.load("gp_mle")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def mle_work(n: int, d: int, num_hypers: int, iterations: int, itemsize: int):
    """(operations, bytes) one GP's MLE needs at n observations: per step the
    elimination's and the three products' multiply-adds (2 operations each),
    the scaling of Li, and per pair of points a profile and its derivative
    (counted 20 operations, an exp among them) and the gradient's sum; X and
    y read once, theta written once. For a roofline of the kernel (PERF.md)."""
    pairs = n * (n - 1) // 2
    elim = sum((n - j - 1) * (j + 1) + (n - j - 1) * (n - j) // 2 for j in range(n))
    gram = sum(i * (n - i - 1) + i for i in range(n))
    per_step = 2 * (elim + 2 * pairs + gram) + pairs + pairs * (20 * 2 + 3 * num_hypers)
    return float(iterations * per_step), (n * d + n) * itemsize + num_hypers * itemsize


def _as(t, dt, dev):
    return t.to(device=dev, dtype=dt) if isinstance(t, torch.Tensor) else \
        torch.as_tensor(t, dtype=dt, device=dev)


def _check(kind, X, y, n, noise, theta, lb, ub):
    """Validate the arguments (both routes); returns noise, theta, lb and ub
    as tensors of X's dtype on its device, lb and ub of shape (P,)."""
    if kind not in KINDS:
        raise ValueError(f"gp_mle: unsupported kernel kind {kind!r}")
    dt, dev = X.dtype, X.device
    if dt not in _ENTRY:
        raise TypeError(f"gp_mle: dtype {dt} (need float32/float64)")
    if X.dim() < 2:
        raise ValueError(f"gp_mle: X must be (..., cap, d), got {tuple(X.shape)}")
    lead, (cap, _) = X.shape[:-2], X.shape[-2:]
    P = hypers(kind)
    noise, theta, lb, ub = (_as(a, dt, dev) for a in (noise, theta, lb, ub))
    lb, ub = (torch.broadcast_to(b.reshape(-1), (P,)) for b in (lb, ub))
    for name, t, shape, tdt in (("y", y, lead + (cap,), dt), ("n", n, lead, torch.int64),
                                ("noise", noise, (), dt)):
        if t.device != dev or t.dtype != tdt or tuple(t.shape) != shape:
            raise ValueError(f"gp_mle: {name} must be {tdt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if theta.shape[-1:] != (P,):
        raise ValueError(f"gp_mle: theta must end in ({P},) for {kind!r}, got "
                         f"{tuple(theta.shape)}")
    return noise, theta, lb, ub


def _launch(kind, X, y, n, noise, theta, lb, ub, *, iterations, lr, threads=_THREADS,
            smem_limit=_SMEM_LIMIT):
    """One launch on the current stream, counted in LAUNCHES or (under a
    CUDA-graph capture) RECORDED. It copies nothing from the host and does
    not synchronize, so a graph can capture it: the launcher runs
    `cudaFuncSetAttribute`, the launch and `cudaGetLastError`."""
    global LAUNCHES, RECORDED
    dt, dev = X.dtype, X.device
    lead, (cap, d) = X.shape[:-2], X.shape[-2:]
    P = hypers(kind)
    B = math.prod(lead)
    out = torch.empty((B, P), dtype=dt, device=dev)
    if B == 0:
        return out.reshape(lead + (P,))
    layout = _layout(cap, d, X.element_size(), iterations, threads, smem_limit)
    Xc = X.reshape(B, cap, d).contiguous()
    yc = y.reshape(B, cap).contiguous()
    nc = n.reshape(B).contiguous()
    theta0 = theta.expand(lead + (P,)).reshape(B, P).contiguous()
    lbc, ubc = lb.contiguous(), ub.contiguous()
    scratch = (None if layout.staged
               else torch.empty((B * layout.scratch,), dtype=dt, device=dev))
    fn = getattr(_library(), _ENTRY[dt])
    err = fn(Xc.data_ptr(), yc.data_ptr(), nc.data_ptr(), noise.data_ptr(),
             theta0.data_ptr(), lbc.data_ptr(), ubc.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), B, cap, d, KINDS.index(kind),
             iterations, float(lr), int(layout.staged), threads, layout.smem,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gp_mle kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        RECORDED += 1
    else:
        LAUNCHES += 1
    return out.reshape(lead + (P,))


def gp_mle(kind: str, X, y, n, noise, theta, lb, ub, *, iterations: int = 60,
           lr: float = 0.1):
    """The kernel hyperparameters that `iterations` projected Adam steps
    reach from theta, in [lb, ub]: (..., P).

    X (..., cap, d) and y (..., cap) zero-padded, n (...) int64 active
    counts, noise the observation noise (a scalar), theta (P,) or (..., P),
    lb and ub (P,) or (1,). CUDA tensors run the kernel, CPU tensors the
    plain version; any other device raises."""
    noise, theta, lb, ub = _check(kind, X, y, n, noise, theta, lb, ub)
    kw = dict(iterations=iterations, lr=lr)
    if X.device.type == "cuda":
        return _launch(kind, X, y, n, noise, theta, lb, ub, **kw)
    if X.device.type == "cpu":
        return gp_mle_ref(kind, X, y, n, noise, theta, lb, ub, **kw)
    raise ValueError(f"gp_mle: no route for device {X.device}")
