"""PyTorch port, the slice end to end: MC rollout estimator and outer SGA.

The same GP state (the JAX package's, carried across as numpy arrays), QMC
stream and starts go through both packages in float64 at d = 2, capacity
16, horizon 2, M = 8. Tolerance rtol 1e-6: the JAX CPU route solves with
the Li-formulated XLA solver and the port with its lane solver in the
same Li form; in float64 they agree to ~1e-12, and the IFT gradients inherit
that agreement amplified by at most the conditioning of the Newton system.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollout_bo_tpu.models import decision_rules as jdr
from rollout_bo_tpu.models import surrogate as jsg
from rollout_bo_tpu.ops import kernels as jK
from rollout_bo_tpu.ops import qmc
from rollout_bo_tpu.rollout import mc as jmc
from rollout_bo_tpu.rollout import outer as jouter
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTP
from rollout_bo_tpu_torch.models import decision_rules as dr
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.ops import newton_lanes as nl
from rollout_bo_tpu_torch.rollout import mc, outer
from rollout_bo_tpu_torch.rollout.trajectory import TrajectoryParams

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers (a multiple of
# the wall time of these files at 6 workers on 8 cores).
torch.set_num_threads(1)

f64 = torch.float64
RTOL = 1e-6
D, CAP, H, M = 2, 16, 2, 8
LBS, UBS = np.array([-2.0, -1.0]), np.array([2.0, 3.0])


def _t(a):
    return torch.tensor(np.array(a), dtype=f64)


def _setup(seed=2):
    rng = np.random.default_rng(seed)
    X = qmc.randsample(7, D, LBS, UBS, rng)
    y = np.sin(1.5 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * X[:, 0] ** 2
    js = jsg.fit(jK.matern52((1.0,)), X, y, capacity=CAP, noise=1e-5,
                 dtype=jnp.float64)
    st = sg.from_numpy_state(js.kernel.kind, js.kernel.theta, js.X, js.y, js.L,
                             js.Li, js.c, js.n, js.noise, device="cpu", dtype=f64)
    xstarts = qmc.generate_initial_guesses(4, LBS, UBS)
    z = qmc.gen_low_discrepancy_sequence(M, D, H + 1)
    x0 = X[:4] + np.array([0.31, -0.27])
    return js, st, xstarts, z, x0


def _tps(z, x0, theta=(0.0,)):
    jtp = JTP(x0=jnp.asarray(x0[0]), theta=jnp.asarray(theta), lbs=jnp.asarray(LBS),
              ubs=jnp.asarray(UBS), rnstream=jnp.asarray(z))
    tp = TrajectoryParams(x0=_t(x0), theta=_t(theta), lbs=_t(LBS), ubs=_t(UBS),
                          rnstream=_t(z))
    return jtp, tp


@pytest.mark.parametrize("rule_name", ["EI", "LCB"])
def test_simulate_trajectory_mc_matches_jax(rule_name):
    js, st, xstarts, z, x0 = _setup()
    theta = (0.3,) if rule_name == "LCB" else (0.0,)
    jtp, tp = _tps(z, x0, theta)
    rule, jrule = dr.RULES[rule_name](), jdr.RULES[rule_name]()
    # all restarts in one batch-first call
    eto = mc.simulate_trajectory_mc(st, tp, rule, _t(xstarts), iterations=6)
    sim = jax.jit(lambda x: jmc.simulate_trajectory_mc(
        js, jtp._replace(x0=x), jrule, jnp.asarray(xstarts), iterations=6))
    for r in range(x0.shape[0]):
        je = sim(jnp.asarray(x0[r]))
        for f in ("mu", "std_mu", "grad_x", "std_grad_x", "grad_theta"):
            np.testing.assert_allclose(getattr(eto, f)[r].numpy(), np.asarray(getattr(je, f)),
                                       rtol=RTOL, atol=1e-10, err_msg=f"{f} restart {r}")
    assert float(eto.std_mu.abs().sum()) > 0.0   # the MC lanes really differ
    # value-only evaluation
    ev = mc.simulate_trajectory_mc(st, tp, rule, _t(xstarts), iterations=6,
                                   with_gradients=False)
    torch.testing.assert_close(ev.mu, eto.mu, rtol=1e-12, atol=0.0)
    assert ev.grad_x is None


def test_stochastic_solve_fused_matches_jax():
    js, st, xstarts, z, x0 = _setup()
    jtp, tp = _tps(z, x0)
    prog = jouter.make_fused_sga_program(js, jtp, jdr.EI(), jnp.asarray(xstarts),
                                         max_iters=5, lr=0.05, inner_iterations=6,
                                         select_best=True)
    jx, jv = prog(js, jtp.rnstream, jnp.asarray(x0))
    res = outer.stochastic_solve_fused(st, tp, dr.EI(), _t(xstarts), _t(x0),
                                       max_iters=5, lr=0.05, inner_iterations=6,
                                       select_best=True)
    assert 1 <= res.iterations <= 5
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jx), rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(float(res.value), float(jv), rtol=1e-6)


def test_fused_solver_calls_once_per_step_for_all_lanes(monkeypatch):
    """Every SGA iteration makes `horizon` solver calls covering all
    restarts x MC lanes at once, plus `horizon` for the value-only pass:
    the launch count chip_smoke.py checks on the card."""
    _, st, xstarts, z, x0 = _setup()
    _, tp = _tps(z, x0)
    calls = []
    real = nl.newton_solve_lanes

    def counting(X, *args, **kw):
        calls.append(X.shape[0])
        return real(X, *args, **kw)

    monkeypatch.setattr(nl, "newton_solve_lanes", counting)
    res = outer.stochastic_solve_fused(st, tp, dr.EI(), _t(xstarts), _t(x0),
                                       max_iters=2, inner_iterations=4)
    assert len(calls) == H * (res.iterations + 1)
    assert set(calls) == {x0.shape[0] * M}


def test_adam_and_eswavs_match_jax():
    rng = np.random.default_rng(0)
    x, g = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    jst, jx = jouter.adam_init(jnp.asarray(x)), jnp.asarray(x)
    st, tx = outer.adam_init(_t(x)), _t(x)
    for _ in range(3):
        jst, jx = jouter.adam_update(jst, jx, jnp.asarray(g), lr=0.05)
        st, tx = outer.adam_update(st, tx, _t(g), lr=0.05)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12)
    var = np.abs(rng.standard_normal((3, 4)))
    var[1] = 0.0
    g[1] = 0.0
    for n in (2, 200):
        want = [bool(jouter.eswavs(jnp.asarray(g[i]), jnp.asarray(var[i]), n))
                for i in range(3)]
        assert outer.eswavs(_t(g), _t(var), n).tolist() == want
    # float32: a zero-gradient, zero-variance restart freezes (no NaN)
    g32, v32 = torch.zeros((1, 4)), torch.zeros((1, 4))
    assert bool(outer.eswavs(g32, v32, 200)[0])
