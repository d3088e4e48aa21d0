"""Fantasy surrogate: h-step lookahead conditioning with coefficient history.

Port of `rollout_bo_tpu/models/fantasy.py` (reference `FantasySurrogate`,
`radial_basis_surrogates.jl:320-585`). Buffers are sized capacity +
horizon + 1; the coefficient history is a stacked (horizon+2, capF)
tensor so any intermediate posterior along a trajectory can be viewed
again. Every lane of a rollout steps in lock-step, so the fantasy count
`m` is a Python int; `n_base`, `y` and the factors are per-lane tensors
(leading lane axes, broadcast from the unbatched base state on the first
conditioning).

fantasy_index convention (reference constants.jl:7): -1 = ground-truth
(base) posterior; i >= 0 = conditioned on fantasies 0..i.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import chol as chol_ops
from rollout_bo_tpu_torch.ops import kernels as kern
from rollout_bo_tpu_torch.ops.kernels import RBFKernel

__all__ = ["FantasyState", "make_fantasy", "view", "fantasy_condition", "fantasy_reset"]


class FantasyState(NamedTuple):
    kernel: RBFKernel
    X: torch.Tensor         # (..., capF, d)
    y: torch.Tensor         # (..., capF)
    L: torch.Tensor         # (..., capF, capF), identity-padded
    cs: torch.Tensor        # (..., h+2, capF) coefficient history; cs[0] = base
    n_base: torch.Tensor    # (...) int64 real observations
    m: int                  # fantasies observed (0..h+1)
    noise: torch.Tensor
    Li: torch.Tensor        # (..., capF, capF) explicit L^{-1}, identity-padded

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def horizon(self) -> int:
        return self.cs.shape[-2] - 2


def _identity_rows_from(M, n):
    """M with rows >= n (per lane) replaced by identity rows."""
    cap = M.shape[-1]
    rows = torch.arange(cap, device=M.device)[:, None]
    eye = torch.eye(cap, dtype=M.dtype, device=M.device)
    return torch.where(rows >= n[..., None, None], eye, M)


def make_fantasy(state: sg.SurrogateState, horizon: int) -> FantasyState:
    """Embed a base surrogate into fantasy buffers (rbs.jl:345-381)."""
    extra = horizon + 1
    cap = state.capacity
    capF = cap + extra
    dt, dev = state.X.dtype, state.X.device
    pad_eye = torch.diag((torch.arange(capF, device=dev) >= cap).to(dt))
    c0 = F.pad(state.c, (0, extra))[..., None, :]
    rest = torch.zeros(c0.shape[:-2] + (horizon + 1, capF), dtype=dt, device=dev)
    return FantasyState(
        kernel=state.kernel,
        X=F.pad(state.X, (0, 0, 0, extra)),
        y=F.pad(state.y, (0, extra)),
        L=F.pad(state.L, (0, extra, 0, extra)) + pad_eye,
        cs=torch.cat([c0, rest], dim=-2),
        n_base=state.n,
        m=0,
        noise=state.noise,
        Li=F.pad(state.Li, (0, extra, 0, extra)) + pad_eye,
    )


def view(fs: FantasyState, fantasy_index: int) -> sg.SurrogateState:
    """Posterior view at a fantasy index (-1 = base), reference rbs.jl:482-505.

    Active count n_base + fantasy_index + 1, coefficients
    cs[fantasy_index + 1]. Rows >= n of both L and Li are reset to the
    identity: for a lower-triangular factor the leading n x n block of
    L^{-1} is (L[:n, :n])^{-1}, so views at ANY past index are exact and
    rows appended later do not leak into them.
    """
    n = fs.n_base + fantasy_index + 1
    c = fs.cs[..., fantasy_index + 1, :]
    return sg.SurrogateState(fs.kernel, fs.X, fs.y,
                             _identity_rows_from(fs.L, n), c, n, fs.noise,
                             _identity_rows_from(fs.Li, n))


def fantasy_condition(fs: FantasyState, xnew, ynew) -> FantasyState:
    """Append one fantasy observation per lane (reference rbs.jl:431-441):
    rank-1 row append at slot n_base + m; the new coefficients go to
    history slot m + 1."""
    dt = fs.X.dtype
    n = fs.n_base + fs.m
    kvec = kern.eval_KxX(fs.kernel, xnew, fs.X)
    k0 = fs.kernel.psi(torch.zeros((), dtype=dt, device=fs.X.device)) + fs.noise
    L, Li = chol_ops.chol_append_row_with_inv(fs.L, fs.Li, kvec, k0, n)

    rows = torch.arange(fs.capacity, device=fs.X.device)
    at = rows == n[..., None]
    X = torch.where(at[..., None], xnew[..., None, :], fs.X)
    y = torch.where(at, ynew[..., None], fs.y)
    c_new = chol_ops.psd_apply(Li, y * (rows < n[..., None] + 1).to(dt))
    cs = fs.cs.expand(c_new.shape[:-1] + fs.cs.shape[-2:])
    cs = torch.cat([cs[..., :fs.m + 1, :], c_new[..., None, :],
                    cs[..., fs.m + 2:, :]], dim=-2)
    return fs._replace(X=X, y=y, L=L, Li=Li, cs=cs, m=fs.m + 1)


def fantasy_reset(fs: FantasyState) -> FantasyState:
    """Drop every fantasy (reference reset!, rbs.jl:476-480): the rows of L
    and Li that fantasies wrote go back to the identity (the padding
    invariant); the stale X, y and cs rows are masked by the active count."""
    return fs._replace(L=_identity_rows_from(fs.L, fs.n_base),
                       Li=_identity_rows_from(fs.Li, fs.n_base), m=0)
