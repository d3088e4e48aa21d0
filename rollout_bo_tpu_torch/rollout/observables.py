"""Observable mechanisms for trajectories: draw-function factories.

Port of `rollout_bo_tpu/rollout/observables.py` (reference
`observables.jl`), "reparam" stochastic draws only; the Gauss-Hermite and
deterministic observables and the "sample_path" mode come later.
"""

from __future__ import annotations

from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import small_chol

__all__ = ["stochastic_observable"]


def stochastic_observable(zstream):
    """Joint (f, grad f) posterior draws with fixed normals ("reparam").

    zstream: (..., d+1, h+1) standard normals, one column per step,
    broadcast against the lane axes (the rollout passes the whole
    (M, d+1, h+1) stream, whose M axis is the lanes' last).

    The draw y = [dmu(x) + chol(S(x)) z]_0 is differentiated exactly with
    the z's held fixed. Its value only involves row 0 of chol(S), which is
    sqrt(S[0, 0]), so only that scalar is differentiated; the full factor
    (needed only for the reported gradient rows) stays detached, avoiding
    the fragile Cholesky backward on marginally-PD covariances in float32.
    """

    def draw(st: sg.SurrogateState, x, j: int):
        z = zstream[..., j]
        dmu, S = sg.joint_posterior_cov(st, x)
        y = dmu[..., 0] + S[..., 0, 0].sqrt() * z[..., 0]
        Ld = small_chol.chol_small(S.detach())
        gy = (dmu.detach() + (Ld @ z[..., None])[..., 0])[..., 1:]
        return y, gy

    return draw
