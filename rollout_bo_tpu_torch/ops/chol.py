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
    cap = L.shape[-1]
    n = torch.as_tensor(n, device=L.device)
    cols = torch.arange(cap, device=L.device)
    nn = n[..., None]
    b = kvec * (cols < nn).to(L.dtype)
    l21 = (Li @ b[..., None])[..., 0]
    l22 = torch.sqrt(torch.clamp(kdiag - torch.sum(l21 * l21, dim=-1),
                                 min=1e-12))
    il22 = 1.0 / l22
    zero = torch.zeros((), dtype=L.dtype, device=L.device)

    at_row = (cols[:, None] == nn[..., None])          # (..., cap, 1)
    new_row_L = torch.where(cols < nn, l21,
                            torch.where(cols == nn, l22[..., None], zero))
    L_new = torch.where(at_row, new_row_L[..., None, :], L)

    li_row = -(l21[..., None, :] @ Li)[..., 0, :] * il22[..., None]
    new_row_Li = torch.where(cols < nn, li_row,
                             torch.where(cols == nn, il22[..., None], zero))
    Li_new = torch.where(at_row, new_row_Li[..., None, :], Li)
    return L_new, Li_new
