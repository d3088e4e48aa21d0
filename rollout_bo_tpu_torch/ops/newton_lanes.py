"""Batched multistart projected-Newton acquisition solve, one GP per lane.

Port of the TPU kernel `rollout_bo_tpu/ops/pallas_newton.py::
newton_solve_lanes`. The rollout solves, at every fantasy step of every
Monte-Carlo trajectory of every outer restart, a multistart Newton
maximization of the acquisition on that lane's own tiny GP (capacity ~24,
d ~10). A lane is one (restart, trajectory) pair; the bench configuration
has 8 x 200 = 1600 lanes per call.

- `newton_solve_lanes` is the entry point. For CUDA tensors it launches the
  hand-written kernel `csrc/newton_lanes.cu` (a warp per (lane, start), the
  lane's GP staged in shared memory; a lane's starts spread over several
  blocks when the lanes alone would leave SMs idle); it raises rather than
  fall back. For CPU tensors it runs the plain version.
- `newton_solve_lanes_ref` is the plain PyTorch version: the same math,
  batch-first over (lane, start). The CPU tests hold it against the JAX
  package, and `chip_smoke.py` holds the CUDA kernel against it on the card.

Both take each lane's Li = L^{-1}, the explicit inverse of its Cholesky
factor that the surrogate state maintains, and compute the posterior
variance in the form the JAX package gives that dtype (`_lane_matrix`):
float32 lanes in the TPU kernel's W = K^{-1} = Li^T Li form, k0 - k^T W k;
float64 lanes in its XLA solver's Li form, k0 - |Li k|^2. The W form's
rounding grows with cond(K), the Li form's with its square root; the
solver accepts a step only when the value rises in floating point, so that
rounding sets the floor at which each argmax stops.

Only the forward solve exists: `rollout/trajectory.py::argmax_with_ift`
differentiates through the implicit-function-theorem linearization and
never through the solver.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from rollout_bo_tpu_torch.models.decision_rules import rule_partials, rule_value
from rollout_bo_tpu_torch.ops import small_chol

__all__ = [
    "SUPPORTED_KINDS",
    "SUPPORTED_RULES",
    "MAX_D",
    "LAUNCHES",
    "RECORDED",
    "supported",
    "lane_solve_work",
    "newton_solve_lanes",
    "newton_solve_lanes_ref",
]

SUPPORTED_KINDS = ("matern52", "matern32", "matern12",
                   "squared_exponential", "periodic")
SUPPORTED_RULES = ("EI", "POI", "LCB", "LogEI", "LogPOI")
MAX_D = 16                     # must match csrc/newton_lanes.cu
MAX_STARTS = 1024
_GROUP = 32                    # threads per (lane, start): kG in csrc/newton_lanes.cu
_MAX_THREADS = 512             # per block: kMaxThreads (kLiMaxThreads) in the .cu
_SMEM_LIMIT = 227 * 1024       # Hopper: dynamic shared memory per block
_GROUPS_TARGET = 8             # groups per block when one lane has fewer starts
_SMS = 132                     # H100 SXM: streaming multiprocessors
_BACKTRACK_STEPS = 9
_CANDIDATES = 2 * _BACKTRACK_STEPS
_EPS = 1e-14                   # must match kEps in csrc/newton_lanes.cu

# Kernel launches since the counter was last reset (set it to 0 to count);
# a CUDA graph's replay adds the launches it holds (`utils.graphs`).
LAUNCHES = 0
# Launches recorded into a CUDA graph under capture: they run nothing then,
# and run at each replay of the graph, which adds them to LAUNCHES.
RECORDED = 0


def supported(kind: str, rule_name: str) -> bool:
    return kind in SUPPORTED_KINDS and rule_name in SUPPORTED_RULES


# --------------------------------------------------------------------------
# Radial profiles: psi(rho), a = psi'/rho, b = (psi'' - a)/rho^2 and iso
# (a at rho > 0, psi''(0) at rho = 0) — the factored stationary-Hessian
# coefficients of ops.kernels.hess_contraction, simplified per family so
# no cancellation is left (pallas_newton.py:76-132).
# --------------------------------------------------------------------------


def _profile_terms(kind: str, rho, sq, ell, period):
    pos = rho > _EPS
    if kind == "periodic":
        c1 = 2.0 / (ell * ell)
        w = math.pi / period
        u = w * rho
        psi = torch.exp(-c1 * torch.sin(u) ** 2)
        s2u = torch.sin(2.0 * u)
        dpsi = -c1 * w * s2u * psi
        d2psi = (-2.0 * c1 * w * w * torch.cos(2.0 * u)
                 + c1 * c1 * w * w * s2u * s2u) * psi
        safe = torch.where(pos, rho, 1.0)
        a = torch.where(pos, dpsi / safe, 0.0)
        b = torch.where(pos, (d2psi - a) / (safe * safe), 0.0)
        iso = torch.where(pos, a, -2.0 * c1 * w * w)
        return psi, a, b, iso
    if kind == "matern52":
        c = math.sqrt(5.0) / ell
        s = c * rho
        e = torch.exp(-s)
        psi = (1.0 + s * (1.0 + s / 3.0)) * e
        a = -(c * c / 3.0) * (1.0 + s) * e           # smooth through 0
        b = (c ** 4 / 3.0) * e
        return psi, torch.where(pos, a, 0.0), torch.where(pos, b, 0.0), a
    if kind == "matern32":
        c = math.sqrt(3.0) / ell
        s = c * rho
        e = torch.exp(-s)
        psi = (1.0 + s) * e
        a = -c * c * e
        safe = torch.where(pos, s, 1.0)
        b = torch.where(pos, c ** 4 * e / safe, 0.0)
        return psi, torch.where(pos, a, 0.0), b, torch.where(pos, a, -c * c)
    if kind == "matern12":
        c = 1.0 / ell
        e = torch.exp(-c * rho)
        safe = torch.where(pos, rho, 1.0)
        a = torch.where(pos, -c * e / safe, 0.0)
        b = torch.where(pos, (c * c * e - a) / torch.where(pos, sq, 1.0), 0.0)
        return e, a, b, torch.where(pos, a, c * c)
    if kind == "squared_exponential":
        l2 = ell * ell
        psi = torch.exp(-sq / (2.0 * l2))
        a = -psi / l2
        return psi, a, psi / (l2 * l2), a
    raise ValueError(f"unsupported kernel kind {kind!r}")


# --------------------------------------------------------------------------
# The plain version, batch-first over (lane, start)
# --------------------------------------------------------------------------


def _posterior_value(x, Xl, Ml, li, cl, ml, kind, ell, period, k0, sigma_floor):
    """(mu, sigma) at x (L, S, d); lane arrays carry a singleton start axis.
    Ml is Li when `li`, else W (`_lane_matrix`)."""
    R = x[..., None, :] - Xl                           # (L, S, cap, d)
    sq = torch.sum(R * R, dim=-1)
    rho = torch.sqrt(torch.clamp(sq, min=0.0))
    kx = _profile_terms(kind, rho, sq, ell, period)[0] * ml
    u = (Ml @ kx[..., None])[..., 0]                   # Li k, or W k
    mu = torch.sum(kx * cl, dim=-1)
    quad = torch.sum(u * u, dim=-1) if li else torch.sum(kx * u, dim=-1)
    var = torch.clamp(k0 - quad, min=sigma_floor ** 2)
    return mu, torch.sqrt(var)


def _posterior_full(x, Xl, Ml, li, cl, ml, kind, ell, period, k0, sigma_floor):
    """mu, grad mu, hess mu, sigma, grad sigma, hess sigma at x (L, S, d).
    Li form (`li`, Ml = Li), as models/surrogate.py::posterior: v = Li k,
    the variance k0 - |v|^2, w = Li^T v and G^T K^{-1} G = (Li G)^T (Li G).
    W form (Ml = W = K^{-1}): w = W k, k0 - k^T w and G^T W G."""
    d = x.shape[-1]
    R = x[..., None, :] - Xl                           # (L, S, cap, d)
    sq = torch.sum(R * R, dim=-1)
    rho = torch.sqrt(torch.clamp(sq, min=0.0))
    psi, a, b, iso = _profile_terms(kind, rho, sq, ell, period)
    kx = psi * ml
    gkx = (a * ml)[..., None] * R                      # (L, S, cap, d)
    gkxT = gkx.transpose(-1, -2)
    mu = torch.sum(kx * cl, dim=-1)
    grad_mu = (gkxT @ cl[..., None])[..., 0]
    if li:
        v = (Ml @ kx[..., None])[..., 0]
        w = (Ml.transpose(-1, -2) @ v[..., None])[..., 0]
        quad = torch.sum(v * v, dim=-1)
        P = Ml @ gkx                                   # (L, S, cap, d)
        data = P.transpose(-1, -2) @ P
    else:
        w = (Ml @ kx[..., None])[..., 0]
        quad = torch.sum(kx * w, dim=-1)
        data = gkxT @ (Ml @ gkx)
    var = torch.clamp(k0 - quad, min=sigma_floor ** 2)
    sigma = torch.sqrt(var)
    ssafe = torch.clamp(sigma, min=sigma_floor)
    grad_sigma = -(gkxT @ w[..., None])[..., 0] / ssafe[..., None]

    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    ia = torch.where(rho > _EPS, a, iso)
    cm = cl * ml
    wm = w * ml
    RT = R.transpose(-1, -2)
    hess_mu = (torch.sum(cm * ia, dim=-1)[..., None, None] * eye
               + RT @ (R * (cm * b)[..., None]))
    hess_sigma = (
        -grad_sigma[..., :, None] * grad_sigma[..., None, :]
        - data
        - RT @ (R * (wm * b)[..., None])
        - torch.sum(wm * ia, dim=-1)[..., None, None] * eye
    ) / ssafe[..., None, None]
    return mu, grad_mu, hess_mu, sigma, grad_sigma, hess_sigma


def _lane_matrix(Li):
    """(the matrix the lanes' solve reads, True when that is Li itself).

    The form of the variance follows the dtype, as the JAX package routes
    it (rollout_bo_tpu/rollout/solvers.py:40-64, `pallas_enabled`): float32
    lanes go to the TPU kernel, which takes W = K^{-1} = Li^T Li (formed
    here once per call, as pallas_newton.get_solver.flat_impl does), and
    float64 lanes to the XLA solver, which reads Li. csrc/newton_lanes.cu
    makes the same choice per instantiation: its float code reads W, its
    double code Li (lower triangle only)."""
    if Li.dtype == torch.float64:
        return Li, True
    return Li.transpose(-1, -2) @ Li, False


def _neg_inf_nonfinite(v):
    return torch.where(torch.isfinite(v), v, -math.inf)


def newton_solve_lanes_ref(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts,
                           period=1.0, **kw):
    """Plain PyTorch version of `newton_solve_lanes` (same arguments)."""
    M, li = _lane_matrix(Li)
    return _solve_plain(X, M, li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, period,
                        **kw)


def _solve_plain(X, M, li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, period=1.0, *,
                 kind="matern52", rule="EI", iterations=12, sigma_tol=1e-8,
                 sigma_floor=1e-10, ridge=1e-8, f_tol=0.0, x_tol=0.0):
    """The plain solve on the lane matrix M: Li when `li`, else W."""
    dt, dev = X.dtype, X.device
    nl, cap, d = X.shape
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    lbs, ubs, xstarts = as_t(lbs), as_t(ubs), as_t(xstarts)
    ell, period = as_t(ell), as_t(period)
    S = xstarts.shape[0]
    scale = torch.max(ubs - lbs)
    boundary_tol = 1e-9 * scale
    ml = (torch.arange(cap, device=dev) < n[:, None]).to(dt)[:, None]  # (L,1,cap)
    Xl, Ml, cl = X[:, None], M[:, None], c[:, None]
    fm, th = fmini[:, None], theta0[:, None]                           # (L, 1)
    zero = torch.zeros((), dtype=dt, device=dev)
    k0 = _profile_terms(kind, zero, zero, ell, period)[0]
    lane = (Xl, Ml, li, cl, ml, kind, ell, period, k0, sigma_floor)
    eye = torch.eye(d, dtype=dt, device=dev)
    loose = f_tol > 0.0 or x_tol > 0.0

    def value(x):
        mu, sigma = _posterior_value(x, *lane)
        return rule_value(rule, mu, sigma, th, fm, sigma_tol)

    def one_iteration(x):
        mu, gmu_v, Hmu, sigma, gsig_v, Hsig = _posterior_full(x, *lane)
        a0 = rule_value(rule, mu, sigma, th, fm, sigma_tol)
        gmu, gsig, gmumu, gsigsig, gmusig = (
            t[..., None, None] for t in rule_partials(rule, mu, sigma, th, fm, sigma_tol))
        g = gmu[..., 0] * gmu_v + gsig[..., 0] * gsig_v
        cross = gmu_v[..., :, None] * gsig_v[..., None, :]
        H = (gmumu * gmu_v[..., :, None] * gmu_v[..., None, :] + gmu * Hmu
             + gsigsig * gsig_v[..., :, None] * gsig_v[..., None, :] + gsig * Hsig
             + gmusig * (cross + cross.transpose(-1, -2)))

        # active-set reduction at the box faces
        act_lo = (x <= lbs + boundary_tol) & (g < 0.0)
        act_hi = (x >= ubs - boundary_tol) & (g > 0.0)
        free = (~(act_lo | act_hi)).to(dt)
        gf = g * free
        Hf = H * free[..., :, None] * free[..., None, :] - eye * (1.0 - free)[..., :, None]

        # Gershgorin-damped Newton direction
        A = -Hf
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        s_scale = torch.clamp(torch.amax(torch.abs(diag), dim=-1), min=ridge)
        off = torch.sum(torch.abs(A), dim=-1) - torch.abs(diag)
        tau_g = (torch.clamp(torch.amax(off - diag, dim=-1), min=0.0)
                 + ridge + 1e-6 * s_scale)

        def solve_tau(tau):
            p = small_chol.spd_solve_small(A + tau[..., None, None] * eye, gf)
            ok = torch.all(torch.isfinite(p), dim=-1) & (torch.sum(p * gf, dim=-1) > 0.0)
            return p, ok

        p1, ok1 = solve_tau(torch.full_like(tau_g, ridge))
        p2, ok2 = solve_tau(tau_g)
        p = torch.where(ok1[..., None], p1,
                        torch.where(ok2[..., None], p2, gf / s_scale[..., None]))
        p = p * free
        bad = (~torch.all(torch.isfinite(p), dim=-1)) | (torch.sum(p * gf, dim=-1) <= 0.0)
        gnorm = torch.sqrt(torch.sum(gf * gf, dim=-1))
        gstep = gf / torch.clamp(gnorm, min=1e-12)[..., None] * (0.1 * scale)
        p = torch.where(bad[..., None], gstep, p)
        pnorm = torch.sqrt(torch.sum(p * p, dim=-1))
        p = p * torch.clamp(scale / torch.clamp(pnorm, min=1e-30), max=1.0)[..., None]

        # backtracking over both directions; strictly better only
        a0 = _neg_inf_nonfinite(a0)
        best_v, best_x = a0, x
        improved = torch.zeros_like(a0, dtype=torch.bool)
        for direction in (p, gstep):
            for k in range(_BACKTRACK_STEPS):
                cand = torch.clamp(x + 0.5 ** k * direction, lbs, ubs)
                v = _neg_inf_nonfinite(value(cand))
                upd = v > best_v
                best_v = torch.where(upd, v, best_v)
                best_x = torch.where(upd[..., None], cand, best_x)
                improved = improved | upd
        return torch.where(improved[..., None], best_x, x), a0, best_v

    x = torch.clamp(xstarts, lbs, ubs).expand(nl, S, d)
    frozen = torch.zeros((nl, S), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        xn, a0, vbest = one_iteration(x)
        if loose:
            # IPNewton-style loose acceptance (reference rbf_optim.jl:26-30):
            # a start freezes once its relative improvement or step is small
            improvement = torch.clamp(vbest - a0, min=0.0)
            small_f = improvement <= f_tol * (torch.abs(a0) + f_tol)
            small_x = torch.sqrt(torch.sum((xn - x) ** 2, dim=-1)) <= x_tol
            xn = torch.where(frozen[..., None], x, xn)
            frozen = frozen | small_f | small_x
        x = xn
    vf = _neg_inf_nonfinite(value(x))

    # best start per lane, in start order: first start wins a tie, and a
    # lane whose every start is -inf returns x = 0, v = -inf
    best_v = torch.full((nl,), -math.inf, dtype=dt, device=dev)
    best_x = torch.zeros((nl, d), dtype=dt, device=dev)
    for s in range(S):
        upd = vf[:, s] > best_v
        best_v = torch.where(upd, vf[:, s], best_v)
        best_x = torch.where(upd[:, None], x[:, s], best_x)
    return best_x, best_v


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------

_KIND_IDS = {k: i for i, k in enumerate(SUPPORTED_KINDS)}
_RULE_IDS = {r: i for i, r in enumerate(SUPPORTED_RULES)}
_ENTRY = {torch.float32: "newton_lanes_f32", torch.float64: "newton_lanes_f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = [_P] * 14 + [_I] * 11 + [_D] * 5 + [_I, _P]


def _library():
    from rollout_bo_tpu_torch.ops import _build

    lib = _build.load("newton_lanes")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


class Layout(NamedTuple):
    """A launch's blocks (`_block_shape`)."""
    lanes: int              # lanes per block
    groups: int             # groups per lane in a block
    stage_m: bool           # the lane matrix in shared memory
    smem: int               # dynamic shared bytes per block
    start_blocks: int = 1   # blocks over one lane's starts

    @property
    def threads(self) -> int:
        return self.lanes * self.groups * _GROUP


def _block_shape(cap: int, d: int, S: int, itemsize: int, num_lanes: int | None = None, *,
                 sms: int = _SMS) -> Layout:
    """The blocks of a launch; must match the layout in csrc/newton_lanes.cu.

    A group of 32 threads (a warp) owns one (lane, start); a block holds
    `lanes` lanes x `groups` groups over the starts of one of
    `start_blocks` contiguous ranges, and a group loops over the starts g,
    g + groups, ... of its range. In words of the lane dtype, dp = d | 1:
    - float32 (the W form): per lane X (cap, dp), W (cap, cap | 1) when
      staged (odd strides keep rows on different banks) and c (cap,); per
      block the box (2, dp); per group (`GroupScratch`) 5 cap-long rows, 2
      cap x max(dp, 18) for the Hessian strips and the candidates' columns, A and its factor (d, dp) each, 18
      candidates and 7 vectors of dp, and a (dp + 2)-long result.
    - float64 (the Li form): per lane X, Li's lower triangle packed by rows
      (cap (cap + 1) / 2) when staged, and c; per group (`LiScratch`) cap x
      max(5 + 2 dp, 18) (5 cap-long rows, G and P = Li G; then the
      candidates' k(x_c, X)), A and its factor, 18 candidates, 7 vectors and
      the result.
    With `num_lanes`, a launch whose lanes fill fewer blocks than `sms`
    takes one lane per block and spreads its starts over blocks, as many as
    make `sms` blocks (each start its own block at the most).
    When one lane with one group does not fit, the lane matrix stays in
    device memory. Raises ValueError when even that exceeds the block's
    shared memory."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"newton_lanes kernel: d = {d} outside 1..{MAX_D}")
    if not 1 <= S <= MAX_STARTS:
        raise ValueError(f"newton_lanes kernel: {S} starts outside 1..{MAX_STARTS}")
    li = itemsize == 8
    dp = d | 1
    if li:
        matrix = cap * (cap + 1) // 2
        per_group = (cap * max(5 + 2 * dp, _CANDIDATES) + 2 * d * dp
                     + (_CANDIDATES + 7) * dp + dp + 2)
    else:
        matrix = cap * (cap | 1)
        per_group = (5 * cap + 2 * cap * max(dp, _CANDIDATES) + 2 * d * dp
                     + (_CANDIDATES + 7) * dp + dp + 2)

    def nbytes(lanes, groups, stage_m):
        per_lane = cap * dp + cap + (matrix if stage_m else 0)
        return (lanes * (per_lane + groups * per_group) + 2 * dp) * itemsize

    slots = _MAX_THREADS // _GROUP        # groups per block
    chunks = -(-S // slots)               # starts per group
    groups = -(-S // chunks)
    lanes = max(1, _GROUPS_TARGET // groups)
    start_blocks = 1
    if num_lanes and -(-num_lanes // lanes) < sms:
        lanes = 1
        start_blocks = min(S, max(1, sms // num_lanes))
        chunk = -(-S // start_blocks)     # starts per block
        start_blocks = -(-S // chunk)
        groups = -(-chunk // -(-chunk // slots))

    for stage in (True, False):
        nl, ng = lanes, groups
        while nbytes(nl, ng, stage) > _SMEM_LIMIT and (nl > 1 or ng > 1):
            if nl > 1:
                nl -= 1
            else:
                ng -= 1
        if nbytes(nl, ng, stage) <= _SMEM_LIMIT:
            return Layout(nl, ng, stage, nbytes(nl, ng, stage), start_blocks)
    raise ValueError(f"newton_lanes kernel: capacity {cap} at d = {d} needs "
                     f"{nbytes(1, 1, False)} B of shared memory for one lane, "
                     f"over {_SMEM_LIMIT}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def lane_solve_work(n, cap: int, d: int, S: int, iterations: int, itemsize: int,
                    runs=None):
    """(floating-point operations, bytes) that one `newton_solve_lanes` call needs.

    `n` holds the lanes' active counts: loops over the data run to n, not
    to the capacity; `itemsize` 4 counts the float32 (W) form, 8 the
    float64 (Li) form (`_lane_matrix`). Operations are the fewest the
    function needs, whoever computes it (a multiply-add is two), per (lane,
    start, iteration): the 18 backtracking values (k(x, X), mu, the
    variance as k^T W k or |Li k|^2, the rule); the three passes, with each
    difference x - X_j taken once (w = W k; or v = Li k and w = Li^T v); the
    rule and its partials; the Hessian's data terms, as W G (2 n^2 d) and
    the rows Q_j, the d (d + 1) / 2 symmetric entries summed over the data
    (n d (d + 1)); or as P = Li G, the rows C_j = coef_j r_j and the entries
    of r_j C_j' and P_j P_j' (2 n d (d + 1)); one d x d Cholesky solve; the
    direction's norms. Then one value per (lane, start). A triangular
    matvec over n rows is n (n + 1) operations. `runs` (L, S), where given,
    holds the iterations each start needs: the kernel stops a start at a
    fixed point (an iteration that returns its point unchanged) or at the
    loose freeze, and reports what it ran (`_launch(runs=...)`); else every
    start counts `iterations`. Left out, so that the count stays a
    floor: the second, Gershgorin-damped solve (only where the first
    fails). Bytes count each input once (X, the lane matrix, c, n, fmini,
    theta0 per lane; the box, the starts and the two kernel parameters
    once) and each output once: W whole, Li's lower triangle (its upper
    one is zero and never read)."""
    li = itemsize == 8
    profile, profile_terms, rule, partials = 12, 25, 30, 60
    sym = d * (d + 1) // 2
    flops = 0
    steps = [S * iterations] * len(n) if runs is None else [int(r) for r in
                                                            torch.as_tensor(runs).sum(-1)]
    for ni, its in zip((int(v) for v in n), steps):
        tri = ni * (ni + 1)                                      # Li times an n-vector
        if li:
            value = ni * (3 * d + profile) + tri + 4 * ni + rule
            passes = (ni * (3 * d + profile_terms + 4 + d)       # k, a, b, G; mu, iso . c
                      + 2 * tri + 4 * ni                         # v = Li k, w = Li^T v;
                                                                 # |v|^2, iso . w
                      + 4 * ni * d + d)                          # grad mu, grad sigma
            hessian = (tri * d                                   # P = Li G
                       + ni * (d + 4)                            # C_j = coef_j r_j
                       + 4 * ni * sym                            # r_j C_j' + P_j P_j', i >= k
                       + 8 * sym + 6 * d)                        # rank-one terms, active set
        else:
            value = ni * (3 * d + profile) + 2 * ni * ni + 4 * ni + rule
            passes = (ni * (3 * d + profile_terms + 4 + d)       # k, a, b, G; mu, iso . c
                      + 2 * ni * ni + 4 * ni                     # w = W k; variance, iso . w
                      + 4 * ni * d + d)                          # grad mu, grad sigma
            hessian = (2 * ni * ni * d                           # W G
                       + ni * (3 * d + 6)                        # Q_j
                       + 2 * ni * sym                            # sum_j r_j Q_j', i >= k
                       + 8 * sym + 6 * d)                        # rank-one terms, active set
        chol = d ** 3 / 3.0 + 2 * d * d + 4 * d
        direction = 2 * d * d + 20 * d                           # Gershgorin, norms
        iteration = (_CANDIDATES * (value + 3 * d) + passes + rule + partials
                     + hessian + chol + direction)
        flops += its * iteration + S * value
    lanes = len(n)
    matrix = cap * (cap + 1) // 2 if li else cap * cap
    read = (lanes * (cap * d + matrix + cap + 2) + 2 * d + S * d + 2) * itemsize + 8 * lanes
    written = lanes * (d + 1) * itemsize
    return float(flops), int(read + written)


def _on_device(a, dt, dev):
    """`a` as a tensor of dtype dt on dev. A tensor is converted on the
    device and a Python number filled there, so that neither copies from
    the host (which a CUDA-graph capture refuses); an array from the host
    is copied, and raises inside a capture."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dt)
    if isinstance(a, (int, float)):
        return torch.full((), a, dtype=dt, device=dev)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise ValueError("newton_solve_lanes: inside a CUDA-graph capture the bounds, "
                         "starts and kernel parameters must be tensors or numbers")
    return torch.as_tensor(a, dtype=dt, device=dev)


def _check_lanes(X, Li, c, n, fmini, theta0, lbs, ubs, xstarts, kind, rule):
    """Validate the lane arguments (both routes); returns lbs, ubs, xstarts
    as tensors of the lane dtype on the lane device (`_on_device`)."""
    if not supported(kind, rule):
        raise ValueError(f"newton_solve_lanes: unsupported ({kind!r}, {rule!r})")
    dt, dev = X.dtype, X.device
    if dt not in _ENTRY:
        raise TypeError(f"newton_solve_lanes: dtype {dt} (need float32/float64)")
    if X.dim() != 3:
        raise ValueError(f"newton_solve_lanes: X must be (L, cap, d), got {tuple(X.shape)}")
    nl, cap, d = X.shape
    lbs, ubs, xstarts = (_on_device(a, dt, dev) for a in (lbs, ubs, xstarts))
    S = xstarts.shape[0]
    want = {"X": (X, (nl, cap, d), dt), "Li": (Li, (nl, cap, cap), dt),
            "c": (c, (nl, cap), dt), "n": (n, (nl,), torch.int64),
            "fmini": (fmini, (nl,), dt), "theta0": (theta0, (nl,), dt),
            "lbs": (lbs, (d,), dt), "ubs": (ubs, (d,), dt),
            "xstarts": (xstarts, (S, d), dt)}
    for name, (t, shape, tdt) in want.items():
        if t.device != dev or t.dtype != tdt or tuple(t.shape) != shape:
            raise ValueError(f"newton_solve_lanes: {name} must be {tdt} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"newton_solve_lanes: {name} must be contiguous")
    return lbs, ubs, xstarts


def _layout_args(layout: Layout):
    """The entry points' lanes_per_block, groups_per_lane, start_blocks and
    stage_m."""
    return layout.lanes, layout.groups, layout.start_blocks, int(layout.stage_m)


def _launch(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, period, *,
            kind, rule, iterations, sigma_tol, sigma_floor, ridge, f_tol, x_tol, runs=None):
    """One solve on the current stream (two kernels where a lane's starts
    spread over start blocks, and always in float64: the solve and the best
    start per lane over the start blocks; one count in LAUNCHES or RECORDED
    either way). It copies nothing from the host and does not synchronize,
    so a CUDA graph can capture it (`utils.graphs`): the launcher runs
    `cudaFuncSetAttribute`, the launches and `cudaGetLastError`. `runs`, an
    int32 (L, S) tensor, takes the iterations each (lane, start) ran (a
    start stops at a fixed point of the iteration), for the measurements'
    work count. The library's measurement entries
    (`newton_lanes_phase_cycles`, `newton_lanes_blocks_per_sm`) copy from
    the device or query it, and are called only outside the path."""
    global LAUNCHES, RECORDED
    dt, dev = X.dtype, X.device
    nl, cap, d = X.shape
    S = xstarts.shape[0]
    params = torch.stack([_on_device(ell, dt, dev).reshape(()),
                          _on_device(period, dt, dev).reshape(())])
    xout = torch.empty((nl, d), dtype=dt, device=dev)
    vout = torch.empty((nl,), dtype=dt, device=dev)
    if nl == 0:
        return xout, vout
    layout = _block_shape(cap, d, S, X.element_size(), nl,
                          sms=_sm_count(dev.index if dev.index is not None
                                        else torch.cuda.current_device()))
    M = _lane_matrix(Li)[0]         # W for the float kernel, Li for the double one
    # each block's best start per lane where there are several (always in
    # float64): value, start, x
    part = (torch.empty((nl, layout.start_blocks, d + 2), dtype=dt, device=dev)
            if dt == torch.float64 or layout.start_blocks > 1 else None)
    fn = getattr(_library(), _ENTRY[dt])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(X.data_ptr(), M.data_ptr(), c.data_ptr(), n.data_ptr(),
             fmini.data_ptr(), theta0.data_ptr(), params.data_ptr(),
             lbs.data_ptr(), ubs.data_ptr(), xstarts.data_ptr(),
             xout.data_ptr(), vout.data_ptr(), None if part is None else part.data_ptr(),
             None if runs is None else runs.data_ptr(), nl, cap, d, S, iterations,
             _KIND_IDS[kind], _RULE_IDS[rule], *_layout_args(layout),
             sigma_tol, sigma_floor, ridge, f_tol, x_tol, layout.smem, stream)
    if err != 0:
        raise RuntimeError(f"newton_lanes kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        RECORDED += 1
    else:
        LAUNCHES += 1
    return xout, vout


def _iterations_run(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, period=1.0, *,
                    kind="matern52", rule="EI", iterations=12, sigma_tol=1e-8,
                    sigma_floor=1e-10, ridge=1e-8, f_tol=0.0, x_tol=0.0):
    """The iterations each (lane, start) runs in one more launch on the card,
    int32 (L, S): `lane_solve_work`'s `runs` for the measurements (a start
    stops at a fixed point or the loose freeze)."""
    if X.device.type != "cuda":
        raise ValueError("_iterations_run: lanes on the card only")
    lbs, ubs, xstarts = _check_lanes(X, Li, c, n, fmini, theta0, lbs, ubs, xstarts,
                                     kind, rule)
    runs = torch.zeros((X.shape[0], xstarts.shape[0]), dtype=torch.int32, device=X.device)
    _launch(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, period, kind=kind, rule=rule,
            iterations=iterations, sigma_tol=sigma_tol, sigma_floor=sigma_floor, ridge=ridge,
            f_tol=f_tol, x_tol=x_tol, runs=runs)
    return runs


def newton_solve_lanes(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts,
                       period=1.0, *, kind="matern52", rule="EI", iterations=12,
                       sigma_tol=1e-8, sigma_floor=1e-10, ridge=1e-8,
                       f_tol=0.0, x_tol=0.0):
    """Multistart Newton argmax per lane. Returns (xstar (L, d), v (L,)).

    X (L, cap, d), Li (L, cap, cap) = L^{-1}, the lower-triangular inverse
    of the Cholesky factor of the active block with identity padding (the
    surrogate state's `Li`: zero above the diagonal), c (L, cap), n (L,)
    int64 active counts, fmini (L,), theta0 (L,) the rule's theta[0]; ell,
    period, lbs / ubs (d,) and xstarts (S, d) are shared by every lane. The
    lane dtype is X's (float32 or float64); it picks the form of the
    variance (`_lane_matrix`). `f_tol` / `x_tol` > 0 turn on the IPNewton-style
    loose per-start freeze. Every lane tensor must be contiguous. CUDA
    tensors run the kernel, CPU tensors the plain version; any other
    device raises.
    """
    lbs, ubs, xstarts = _check_lanes(X, Li, c, n, fmini, theta0, lbs, ubs, xstarts,
                                     kind, rule)
    kw = dict(kind=kind, rule=rule, iterations=iterations, sigma_tol=sigma_tol,
              sigma_floor=sigma_floor, ridge=ridge, f_tol=f_tol, x_tol=x_tol)
    if X.device.type == "cuda":
        return _launch(X, Li, c, n, fmini, theta0, ell, lbs, ubs, xstarts, period, **kw)
    if X.device.type == "cpu":
        return newton_solve_lanes_ref(X, Li, c, n, fmini, theta0, ell, lbs, ubs,
                                      xstarts, period, **kw)
    raise ValueError(f"newton_solve_lanes: no route for device {X.device}")
