"""Masked fixed-capacity Cholesky factorizations and rank-1 row appends.

Port of `rollout_bo_tpu/ops/chol.py`. Buffers are (capacity, capacity)
with an active count n and an **identity-padding invariant**

    L[i, j] = delta_ij  for i >= n  (inactive rows/cols),

so products with the padded explicit inverse Li = L^{-1} and zero-padded
right-hand sides return exactly the active-block solution, zero-padded.
Every function takes leading lane axes; `n` is an integer tensor of the
lane shape (or a Python int).
"""

from __future__ import annotations

import torch

__all__ = [
    "active_mask",
    "masked_cholesky",
    "solve_lower",
    "solve_upper",
    "cho_solve_padded",
    "chol_append_row",
    "tri_inv_padded",
    "psd_apply",
    "chol_append_row_with_inv",
]


def active_mask(capacity: int, n, *, dtype, device):
    """(..., capacity) mask with the first n entries 1 (n of lane shape)."""
    n = torch.as_tensor(n, device=device)
    rows = torch.arange(capacity, device=device)
    return (rows < n[..., None]).to(dtype)


def masked_cholesky(K, n, *, nan_if_not_pd: bool = False):
    """Cholesky of the active n x n block of K (..., cap, cap), identity in
    the padding (reference radial_basis_surrogates.jl:93-98).

    A block that is not positive definite raises, unless `nan_if_not_pd`:
    then its whole factor is NaN, with no exception and no host
    synchronization. The hyperparameter MLE relies on that contract, which
    is the JAX Cholesky's: a trial theta outside the PD cone gives a NaN
    likelihood whose gradient the optimizer zeroes."""
    cap = K.shape[-1]
    m = active_mask(cap, n, dtype=torch.bool, device=K.device)
    both = m[..., :, None] & m[..., None, :]
    eye = torch.eye(cap, dtype=K.dtype, device=K.device)
    A = torch.where(both, K, eye)
    if not nan_if_not_pd:
        return torch.linalg.cholesky(A)
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def solve_lower(L, b):
    """z with L z = b, for identity-padded L (..., cap, cap) and a
    zero-padded vector b (..., cap); z is zero-padded too."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def solve_upper(L, b):
    """z with L^T z = b, for identity-padded L and a zero-padded vector b."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), b[..., None], upper=True)[..., 0]


def cho_solve_padded(L, b):
    """(L L^T)^{-1} b for identity-padded L and a zero-padded vector b."""
    return solve_upper(L, solve_lower(L, b))


def _schur_row(l21, kdiag):
    """l22 = sqrt(kdiag - ||l21||^2), floored at 1e-6 (1e-12 under the root)."""
    return torch.sqrt(torch.clamp(kdiag - torch.sum(l21 * l21, dim=-1), min=1e-12))


def _set_row(M, head, diag, n):
    """M with row n replaced by [head[:n], diag, 0 ...] (per lane)."""
    cols = torch.arange(M.shape[-1], device=M.device)
    nn = n[..., None]
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    row = torch.where(cols < nn, head, torch.where(cols == nn, diag[..., None], zero))
    return torch.where(cols[:, None] == nn[..., None], row[..., None, :], M)


def chol_append_row(L, kvec, kdiag, n):
    """Append one observation at row n of an identity-padded factor L, by a
    triangular solve (reference radial_basis_surrogates.jl:186-204):

        l21 = L^{-1} kvec_active,   l22 = sqrt(kdiag - ||l21||^2).

    kvec (..., cap) is the new covariance column (entries from n on are
    ignored), kdiag the new diagonal entry (psi(0) + noise)."""
    n = torch.as_tensor(n, device=L.device)
    cols = torch.arange(L.shape[-1], device=L.device)
    l21 = solve_lower(L, kvec * (cols < n[..., None]).to(L.dtype))
    return _set_row(L, l21, _schur_row(l21, kdiag), n)


def tri_inv_padded(L):
    """Inverse of an identity-padded lower-triangular factor; the padding
    is preserved (blockdiag(L_a, I)^{-1} = blockdiag(L_a^{-1}, I))."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def psd_apply(Li, b):
    """(L L^T)^{-1} b = Li^T (Li b) for a zero-padded vector b (..., cap)."""
    v = (Li @ b[..., None])
    return (Li.transpose(-1, -2) @ v)[..., 0]


def chol_append_row_with_inv(L, Li, kvec, kdiag, n):
    """Append one observation at row n of (L, Li); returns (L_new, Li_new).

    l21 = Li kvec_active, l22 = sqrt(kdiag - ||l21||^2) is the Schur
    update of the reference (radial_basis_surrogates.jl:186-204); only row
    n of each factor changes:

        Li_new[n, :n] = -(l21^T Li)/l22,  Li_new[n, n] = 1/l22.
    """
    n = torch.as_tensor(n, device=L.device)
    cols = torch.arange(L.shape[-1], device=L.device)
    b = kvec * (cols < n[..., None]).to(L.dtype)
    l21 = (Li @ b[..., None])[..., 0]
    l22 = _schur_row(l21, kdiag)
    il22 = 1.0 / l22
    li_row = -(l21[..., None, :] @ Li)[..., 0, :] * il22[..., None]
    return _set_row(L, l21, l22, n), _set_row(Li, li_row, il22, n)
