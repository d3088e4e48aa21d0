"""Expected-improvement derivative chain, checked against finite differences.

Port of the JAX package's `examples/derivs_ei.py`, the script analog of the
reference's `notebooks/derivsEI.ipynb` ("Derivatives for expected
improvement — sanity checks"): walk the full derivative chain the inner
Newton solve and the adjoint need —

  kernel profile psi(rho)            -> dpsi, d2psi
  kernel k(x,y)                      -> grad k, Hess k
  posterior mean mu = k_xX c         -> grad mu, Hess mu
  posterior std sigma                -> grad sigma, Hess sigma
  z = (f+ - mu - xi) / sigma         -> grad z   (minimization EI form)
  g(z) = z Phi(z) + phi(z)           -> g', g''
  alpha = sigma g(z)                 -> grad alpha, Hess alpha
  hyper/data perturbations           -> dmu, d(grad sigma), d(grad alpha)
                                        w.r.t. lengthscale and observations

— and print the relative error of each analytic quantity against a
centered finite difference, the notebook's procedure, in float64. The
quantities come from the closed-form posterior (`models/surrogate.py::
posterior`) and `torch.func.grad` / `jvp`, so this doubles as an
end-to-end autograd-vs-FD audit. It fails above 1e-5.

Run:  python -m rollout_bo_tpu_torch.examples.derivs_ei [--seed 7] [--n 8] [--dim 2]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
from rollout_bo_tpu_torch.models import surrogate as sg
from rollout_bo_tpu_torch.models.decision_rules import EI
from rollout_bo_tpu_torch.ops import kernels as K


def centered_fd(f, x, h=1e-6):
    """Centered FD gradient of scalar f at vector (or scalar) x."""
    x = np.asarray(x, float)
    if x.ndim == 0:
        return (f(x + h) - f(x - h)) / (2 * h)
    g = np.zeros_like(x)
    for i in range(x.size):
        e = np.zeros_like(x)
        e[i] = h
        g[i] = (f(x + e) - f(x - e)) / (2 * h)
    return g


def relerr(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    den = max(float(np.max(np.abs(b))), 1e-12)
    return float(np.max(np.abs(a - b))) / den


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--n", type=int, default=8, help="observations")
    p.add_argument("--dim", type=int, default=2)
    add_device_argument(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=dev)  # noqa: E731
    num = lambda a: a.detach().cpu().numpy()  # noqa: E731
    grad = torch.func.grad

    rng = np.random.default_rng(args.seed)
    d, n = args.dim, args.n
    ell = 0.9
    kernel = K.squared_exponential((ell,), device=dev)

    checks = []

    # -- kernel profile: psi, dpsi, d2psi (notebook cell 5) ----------------
    rho = 1.23
    psi = lambda r: float(kernel.psi(t(r)))  # noqa: E731
    dpsi = float(grad(kernel.psi)(t(rho)))
    d2psi = float(grad(grad(kernel.psi))(t(rho)))
    checks.append(("dpsi/drho", relerr(dpsi, centered_fd(psi, rho))))
    checks.append(("d2psi/drho2",
                   relerr(d2psi, centered_fd(lambda r: float(grad(kernel.psi)(t(r))), rho))))

    # -- kernel point derivatives: grad k, Hess k (notebook cell 6) --------
    x = t(rng.uniform(-1, 1, d))
    y = t(rng.uniform(-1, 1, d))
    kf = lambda xv: float(K.kernel_value(kernel, t(xv) - y))  # noqa: E731
    gk = num(K.kernel_grad(kernel, x - y))
    Hk = num(K.kernel_hess(kernel, x - y))
    checks.append(("grad k", relerr(gk, centered_fd(kf, num(x)))))
    Hfd = np.stack([centered_fd(lambda xv: num(K.kernel_grad(kernel, t(xv) - y))[i], num(x))
                    for i in range(d)])
    checks.append(("Hess k", relerr(Hk, Hfd)))

    # -- GP fit -------------------------------------------------------------
    X = rng.uniform(-1, 1, (n, d))
    yobs = np.sin(X.sum(axis=1)) + 0.1 * rng.standard_normal(n)
    state = sg.fit(kernel, X, yobs, capacity=n, noise=1e-8, device=dev)
    # query near (not at) the incumbent; at the defaults z = (f+ - mu)/sigma
    # is -8.5 there, so the chain runs in EI's lower tail (Phi(z) ~ 1e-17)
    xq = t(X[int(np.argmin(yobs))] + 0.35)
    post = sg.posterior(state, xq)

    # -- mean chain: mu, grad mu, Hess mu (notebook cells 7-8) --------------
    muf = lambda xv: float(sg.posterior(state, t(xv)).mu)  # noqa: E731
    checks.append(("grad mu", relerr(num(post.grad_mu), centered_fd(muf, num(xq)))))
    Hmu_fd = np.stack([centered_fd(lambda xv: num(sg.posterior(state, t(xv)).grad_mu)[i],
                                   num(xq)) for i in range(d)])
    checks.append(("Hess mu", relerr(num(post.hess_mu), Hmu_fd)))

    # -- std chain: sigma, grad sigma, Hess sigma (notebook cells 10-11) ----
    sf = lambda xv: float(sg.posterior(state, t(xv)).sigma)  # noqa: E731
    checks.append(("grad sigma", relerr(num(post.grad_sigma), centered_fd(sf, num(xq)))))
    Hs_fd = np.stack([centered_fd(lambda xv: num(sg.posterior(state, t(xv)).grad_sigma)[i],
                                  num(xq)) for i in range(d)])
    checks.append(("Hess sigma", relerr(num(post.hess_sigma), Hs_fd)))

    # -- z and g chains (notebook cells 13-16; minimization EI form) --------
    fmini = float(sg.get_active_minimum(state))
    xi = 0.0

    def zf(xv):
        pq = sg.posterior(state, t(xv))
        return (fmini - float(pq.mu) - xi) / float(pq.sigma)

    z_grad = (-num(post.grad_mu) - zf(num(xq)) * num(post.grad_sigma)) / float(post.sigma)
    checks.append(("grad z", relerr(z_grad, centered_fd(zf, num(xq)))))

    # erfc, not torch.special.ndtr: see models/decision_rules.py::_cdf
    cdf = lambda z: float(0.5 * torch.special.erfc(-t(z) / math.sqrt(2.0)))  # noqa: E731
    pdf = lambda z: float(torch.exp(-0.5 * t(z) ** 2) / math.sqrt(2.0 * math.pi))  # noqa: E731
    g = lambda z: float(z) * cdf(z) + pdf(z)  # noqa: E731
    z0 = zf(num(xq))
    checks.append(("g'(z) = Phi(z)", relerr(cdf(z0), centered_fd(g, z0))))
    checks.append(("g''(z) = phi(z)", relerr(pdf(z0), centered_fd(cdf, z0))))

    # -- alpha = sigma g(z): value, grad, Hess (notebook cells 15-17) -------
    rule = EI()
    theta = torch.zeros((1,), dtype=torch.float64, device=dev)
    a, ga, Ha = sg.acquisition_value_grad_hess(state, rule, xq, theta)
    af = lambda xv: float(sg.acquisition(state, rule, t(xv), theta))  # noqa: E731
    checks.append(("EI value = sigma*g(z)", relerr(float(a), float(post.sigma) * g(z0))))
    checks.append(("grad EI", relerr(num(ga), centered_fd(af, num(xq)))))
    Ha_fd = np.stack([centered_fd(
        lambda xv: num(sg.acquisition_grad(state, rule, t(xv), theta)[1])[i], num(xq))
        for i in range(d)])
    checks.append(("Hess EI", relerr(num(Ha), Ha_fd)))

    # -- hyper/data perturbations (notebook cells 9, 11, 17) ----------------
    # dmu, d(grad sigma), d(grad alpha) under a lengthscale variation ldot
    # and an observation variation ydot: one jvp through the refit replaces
    # the notebook's hand-assembled delta-chains.
    ldot, ydot = 0.37, rng.standard_normal(n)

    def with_hypers(ev, yv):
        st = sg.fit(K.RBFKernel(ev.reshape(1), "squared_exponential"), X, yv, capacity=n,
                    noise=1e-8, device=dev)
        pq = sg.posterior(st, xq)
        _, gA = sg.acquisition_grad(st, rule, xq, theta)
        return pq.mu, pq.grad_sigma, gA

    _, (dmu, dgs, dga) = torch.func.jvp(with_hypers, (t(ell), t(yobs)), (t(ldot), t(ydot)))
    h = 1e-6
    hi = with_hypers(t(ell + h * ldot), t(yobs + h * ydot))
    lo = with_hypers(t(ell - h * ldot), t(yobs - h * ydot))
    fd3 = [(num(a) - num(b)) / (2 * h) for a, b in zip(hi, lo)]
    checks.append(("delta mu (hyper+data)", relerr(num(dmu), fd3[0])))
    checks.append(("delta grad sigma", relerr(num(dgs), fd3[1])))
    checks.append(("delta grad EI", relerr(num(dga), fd3[2])))

    print(f"== EI derivative chain vs centered finite differences (d={d}, n={n}) ==")
    worst = 0.0
    for name, e in checks:
        print(f"  {name:<24} rel err {e:.3e}")
        worst = max(worst, e)
    print(f"worst relative error: {worst:.3e}")
    if worst > 1e-5:
        raise SystemExit("FD check failed (worst > 1e-5)")
    print("all checks passed")
    return {"checks": dict(checks), "worst": worst}


if __name__ == "__main__":
    main()
