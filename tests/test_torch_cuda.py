"""PyTorch port on the card: the CUDA Newton lane kernel vs its plain version.

Every test here is marked `cuda` and skips without a CUDA device (the
kernel has no CPU mode). This file imports no jax, so it also runs on a
GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Criteria as in chip_smoke.py and tests/test_pallas_newton.py, on the same
CUDA lanes: (a) the kernel's value matches a plain re-evaluation of the
acquisition at its argmax (float32 rtol 2e-3, log rules atol 2e-3 in log
space; float64 rtol 1e-6); (b) its solution is never worse than the plain
solver's beyond 5e-4 relative in float32 / 1e-6 in float64 — or beyond
the acceptance tolerance f_tol (|v| + 1) under the loose freeze, whose
stopping iteration rounding near the threshold may shift.
"""

import numpy as np
import pytest
import torch

from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import kernels as K
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.ops import qmc
from rollout_bo_tpu_torch.rollout import solvers

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _lane_state(L, d, cap, kind, dtype, device, seed):
    """L single-lane fits with active counts 3..9, stacked into one state.

    float32 lanes get noise 1e-3: with 1e-4 a squared-exponential K on
    these points is conditioned beyond what float32 resolves, and the
    W = K^{-1} (kernel) and Li (re-evaluation) variance forms then differ
    by far more than the criteria's tolerance on a lane or two."""
    rng = np.random.default_rng(seed)
    theta = (0.9, 3.0) if kind == "periodic" else (0.8,)
    kern = K.RBFKernel(torch.tensor(theta, dtype=dtype, device=device), kind)
    lanes = []
    for _ in range(L):
        n = int(rng.integers(3, 10))
        X = rng.uniform(-1.0, 1.0, (n, d))
        lanes.append(sg.fit(kern, X, np.sin(2.0 * X.sum(axis=1)), capacity=cap,
                            noise=1e-3 if dtype == torch.float32 else 1e-4,
                            device=device, dtype=dtype))
    cat = {f: torch.stack([getattr(s, f) for s in lanes])
           for f in ("X", "y", "L", "c", "n", "Li")}
    return sg.SurrogateState(kern, noise=lanes[0].noise, **cat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", nl.SUPPORTED_KINDS)
@pytest.mark.parametrize("rule_name", nl.SUPPORTED_RULES)
def test_kernel_matches_plain_version(dev, rule_name, kind, dtype):
    L, d = 64, 3
    st = _lane_state(L, d, 12, kind, dtype, dev, 1)
    rule = dr.RULES[rule_name]()          # POI: the loose freeze
    lbs = torch.full((d,), -1.0, dtype=dtype, device=dev)
    ubs = torch.full((d,), 1.0, dtype=dtype, device=dev)
    xstarts = torch.tensor(qmc.generate_initial_guesses(6, -np.ones(d), np.ones(d)),
                           dtype=dtype, device=dev)
    th = torch.full((L, 1), 0.5 if rule_name == "LCB" else 0.0, dtype=dtype, device=dev)
    W = st.Li.transpose(-1, -2) @ st.Li
    args = (st.X, W, st.c, st.n, sg.get_active_minimum(st), th[:, 0].contiguous(),
            st.kernel.theta[0], lbs, ubs, xstarts,
            st.kernel.theta[1] if kind == "periodic" else 1.0)
    kw = dict(kind=kind, rule=rule_name, iterations=8, f_tol=rule.solve_f_tol,
              x_tol=rule.solve_x_tol)
    before = nl.LAUNCHES
    xk, vk = nl.newton_solve_lanes(*args, **kw)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before + 1
    xr, vr = nl.newton_solve_lanes_ref(*args, **kw)
    assert nl.LAUNCHES == before + 1
    vk_cross = sg.acquisition(st, rule, xk, th)
    vr_cross = sg.acquisition(st, rule, xr, th)
    f32 = dtype == torch.float32
    rtol = 2e-3 if f32 else 1e-6
    atol = (2e-3 if f32 else 1e-6) if rule_name.startswith("Log") else (1e-6 if f32 else 1e-9)
    torch.testing.assert_close(vk, vk_cross, rtol=rtol, atol=atol)
    if rule.solve_f_tol > 0:
        slack = rule.solve_f_tol * (vr_cross.abs() + 1.0)
    else:
        slack = (5e-4 if f32 else 1e-6) * vr_cross.abs().clamp(min=1.0) + 1e-6
    assert torch.all(vk_cross >= vr_cross - slack)


def test_maximize_hot_launches_once_for_all_lane_axes(dev):
    flat = _lane_state(12, 2, 8, "matern52", torch.float32, dev, 3)
    lanes = {f: getattr(flat, f).reshape((3, 4) + getattr(flat, f).shape[1:])
             for f in ("X", "y", "L", "c", "n", "Li")}
    st = sg.SurrogateState(flat.kernel, noise=flat.noise, **lanes)
    before = nl.LAUNCHES
    x, v = solvers.maximize_hot(st, dr.EI(), torch.zeros((3, 4, 1), device=dev),
                                torch.full((2,), -1.0, device=dev),
                                torch.full((2,), 1.0, device=dev),
                                torch.zeros((4, 2), device=dev), iterations=4)
    torch.cuda.synchronize()
    assert nl.LAUNCHES == before + 1
    assert x.shape == (3, 4, 2) and bool(torch.all(torch.isfinite(v)))


def test_kernel_raises_instead_of_falling_back(dev):
    """Shapes beyond the kernel's maxima raise for CUDA tensors."""
    d = nl.MAX_D + 1
    X = torch.zeros((2, 4, d), device=dev)
    W = torch.eye(4, device=dev).expand(2, 4, 4).contiguous()
    z = torch.zeros(2, device=dev)
    with pytest.raises(ValueError, match="outside"):
        nl.newton_solve_lanes(X, W, torch.zeros((2, 4), device=dev),
                              torch.tensor([2, 2], device=dev), z, z, 0.8,
                              torch.full((d,), -1.0, device=dev),
                              torch.full((d,), 1.0, device=dev),
                              torch.zeros((3, d), device=dev), iterations=1)
