"""Small batched Cholesky factorizations and SPD solves with a NaN contract.

Port of `rollout_bo_tpu/ops/small_chol.py`. The JAX package unrolls these
over the (static, small) dimension to keep them out of the TPU's Cholesky
custom call. Here they are column loops over the last axis, batched over
every leading lane axis. The contract the callers rely on is kept: a matrix
that is not positive definite yields NaN entries (sqrt of a negative
pivot), never an exception, so finiteness guards such as the IFT's
(`rollout/trajectory.py`) work unchanged. `torch.linalg.cholesky` raises
instead, so it is not used here.

Every function is differentiable in its right-hand side.
"""

from __future__ import annotations

import torch

__all__ = [
    "chol_small",
    "solve_lower_small",
    "solve_upper_small",
    "spd_solve_small",
]


def chol_small(A):
    """Lower Cholesky factor of A (..., d, d); NaN where A is not PD."""
    d = A.shape[-1]
    rows = torch.arange(d, device=A.device)
    cols = []
    for j in range(d):
        s = A[..., :, j]
        if j:
            Lp = torch.stack(cols, dim=-1)                 # (..., d, j)
            s = s - (Lp @ Lp[..., j, :, None])[..., 0]
        ljj = torch.sqrt(s[..., j])
        col = torch.where(rows > j, s / ljj[..., None],
                          torch.where(rows == j, ljj[..., None], 0.0))
        cols.append(col)
    return torch.stack(cols, dim=-1)


def solve_lower_small(L, b):
    """L z = b by forward substitution; L (..., d, d) lower, b (..., d)."""
    d = L.shape[-1]
    z = []
    for i in range(d):
        acc = b[..., i]
        if i:
            acc = acc - torch.sum(L[..., i, :i] * torch.stack(z, dim=-1), dim=-1)
        z.append(acc / L[..., i, i])
    return torch.stack(z, dim=-1)


def solve_upper_small(L, b):
    """L^T z = b by back substitution; L (..., d, d) lower, b (..., d)."""
    d = L.shape[-1]
    z = [None] * d
    for i in reversed(range(d)):
        acc = b[..., i]
        if i < d - 1:
            acc = acc - torch.sum(L[..., i + 1:, i] * torch.stack(z[i + 1:], dim=-1),
                                  dim=-1)
        z[i] = acc / L[..., i, i]
    return torch.stack(z, dim=-1)


def spd_solve_small(A, b):
    """A^{-1} b for small SPD A via Cholesky; NaN if A is not PD."""
    L = chol_small(A)
    return solve_upper_small(L, solve_lower_small(L, b))
