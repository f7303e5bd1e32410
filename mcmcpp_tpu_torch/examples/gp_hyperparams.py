"""GP regression with unknown hyperparameters by blocked Gibbs.

The port of ``examples/gp_hyperparams.py``. ``gp_latent`` samples a GP
latent under fixed kernel hyperparameters; real GP workflows learn them.
The blocked Gibbs engine alternates:

- elliptical slice over the whitened latent (f = L(θ) e, e ~ N(0, I));
- both hyperparameter conditionals, interwoven (ASIS, Yu & Meng 2011):
  θ | e (ancillary) then θ | f (sufficient), through the exact coordinate
  switch of :class:`GaussianInterweaveKernel`.

The oracle is the exact marginal hyperposterior (f integrates out:
y ~ N(0, K(θ) + σ²I)), by quadrature on a 41 × 41 grid. Returns non-zero
unless the chain's log lengthscale and log amplitude means lie within 0.5
exact sds of the exact means, the lengthscale's spread within (0.4, 2.5) of
the exact sd, and the latent's RMSE against the truth below 2σ.

Usage:
    python -m mcmcpp_tpu_torch.examples.gp_hyperparams [--quick] \
        [--device cuda|cpu]
"""

import argparse
import math
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    BlockedGibbsSampler,
    GaussianInterweaveKernel,
    HMCKernel,
)
from mcmcpp_tpu_torch.models.gp import RBF, gram_cholesky
from mcmcpp_tpu_torch.sampler import resolve_device

N = 48
SIG = 0.2
TRUE_L, TRUE_A = 0.8, 1.5


def chol_fn(xs):
    """(log l, log a) -> the lower Cholesky factor of the RBF Gram of
    ``xs`` (a tensor) plus 1e-5 I."""
    def k_chol(log_l, log_a):
        kern = RBF(lengthscale=torch.exp(log_l),
                   variance=torch.exp(2.0 * log_a))
        return gram_cholesky(kern, xs, jitter=1e-5)

    return k_chol


def make_data(seed=11):
    """The inputs, the true latent and the observations (float32), drawn as
    the JAX program draws them (its latent is a float32 product)."""
    rng = np.random.default_rng(seed)
    xs = torch.linspace(0.0, 5.0, N)
    chol = chol_fn(xs)(torch.tensor(math.log(TRUE_L)),
                       torch.tensor(math.log(TRUE_A)))
    f_true = (chol @ torch.as_tensor(rng.standard_normal(N),
                                     dtype=torch.float32)).numpy()
    y = (f_true + SIG * rng.standard_normal(N)).astype(np.float32)
    return xs.numpy(), f_true, y


def loglike_fn(y):
    def loglike_f(f):
        return -0.5 * torch.sum((y - f) ** 2) / SIG ** 2

    return loglike_f


def hyper_logprior(h):
    return -0.5 * torch.sum(h * h)  # N(0, 1) on log l, log a


def exact_hyper_posterior(xs, y):
    """Means and sds of (log l, log a) under the exact marginal
    hyperposterior, by 2-D grid quadrature in float64."""
    gl = np.linspace(-1.2, 1.2, 41)
    ga = np.linspace(-1.2, 1.8, 41)
    y = np.asarray(y, np.float64)
    # the squared distances of the float32 inputs in float32, as the JAX
    # program takes them
    xs = np.asarray(xs, np.float32)
    d2 = ((xs[:, None] - xs[None, :]) ** 2).astype(np.float64)
    lp = np.empty((gl.size, ga.size))
    for i, a1 in enumerate(gl):
        for j, a2 in enumerate(ga):
            k = (np.exp(2 * a2) * np.exp(-0.5 * d2 / np.exp(2 * a1))
                 + (SIG ** 2 + 1e-5) * np.eye(len(xs)))
            _, logdet = np.linalg.slogdet(k)
            lp[i, j] = (-0.5 * (a1 ** 2 + a2 ** 2) - 0.5 * logdet
                        - 0.5 * y @ np.linalg.solve(k, y))
    w = np.exp(lp - lp.max())
    w /= w.sum()
    m_l = float((w.sum(1) * gl).sum())
    m_a = float((w.sum(0) * ga).sum())
    s_l = float(np.sqrt((w.sum(1) * (gl - m_l) ** 2).sum()))
    s_a = float(np.sqrt((w.sum(0) * (ga - m_a) ** 2).sum()))
    return (m_l, s_l), (m_a, s_a)


def run(quick=False, device="cuda", chains=None, burn=None, keep=None):
    """Sample (h, e) by interwoven Gibbs and hold it to the exact
    hyperposterior; the budgets default to the program's (``quick``: 16
    chains, 400 + 800 sweeps; else 32, 800 + 2400). Returns a dict: the
    draws ``h``, the latent's ``rmse``, the ``exact`` means and sds, and
    the names of the ``failed`` checks."""
    chains = chains or (16 if quick else 32)
    burn = burn or (400 if quick else 800)
    keep = keep or (800 if quick else 2400)
    xs_np, f_true, y_np = make_data()
    xs = torch.as_tensor(xs_np, device=device)
    y = torch.as_tensor(y_np, device=device)
    k_chol = chol_fn(xs)
    s = BlockedGibbsSampler(
        [
            (("h", "e"), (2, N), GaussianInterweaveKernel(
                loglike_fn(y), lambda h: k_chol(h[0], h[1]), hyper_logprior,
                lambda logp: HMCKernel(logp, step_size=0.01,
                                       n_leapfrog=16))),
        ],
        n_chains=chains, seed=0, device=device,
    )
    s.init({"e": np.zeros(N), "h": np.zeros(2)})
    s.run(burn, thin=burn)
    s.chain.clear()
    s.run(keep, thin=4)
    h = s.get_block("h", flat=True)
    e = s.get_block("e", flat=True)
    # the latent per stored draw: f = L(θ) e
    with torch.no_grad():
        f_draws = torch.func.vmap(lambda hh, ee: k_chol(hh[0], hh[1]) @ ee)(
            torch.as_tensor(h, device=device),
            torch.as_tensor(e, device=device))
    f_mean = f_draws.mean(0).cpu().numpy()
    rmse = float(np.sqrt(np.mean((f_mean - f_true) ** 2)))
    (m_l, s_l), (m_a, s_a) = exact_hyper_posterior(xs_np, y_np)
    print(f"log lengthscale: gibbs {h[:, 0].mean():+.3f}±{h[:, 0].std():.3f}"
        f"  exact {m_l:+.3f}±{s_l:.3f}  (true {np.log(TRUE_L):+.3f})")
    print(f"log amplitude:   gibbs {h[:, 1].mean():+.3f}±{h[:, 1].std():.3f}"
        f"  exact {m_a:+.3f}±{s_a:.3f}  (true {np.log(TRUE_A):+.3f})")
    print(f"latent RMSE vs truth: {rmse:.3f} (noise sd {SIG})")
    checks = {
        "lengthscale off": abs(h[:, 0].mean() - m_l) < 0.5 * s_l,
        "amplitude off": abs(h[:, 1].mean() - m_a) < 0.5 * s_a,
        # stuck or runaway chains show up as a spread beyond 2.5x
        "lengthscale spread off": 0.4 < h[:, 0].std() / s_l < 2.5,
        "latent reconstruction degraded": rmse < 2 * SIG,
    }
    return {"h": h, "rmse": rmse, "exact": ((m_l, s_l), (m_a, s_a)),
            "failed": [k for k, ok in checks.items() if not ok]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    failed = run(args.quick, args.device)["failed"]
    print("OK" if not failed else "FAILED: " + ", ".join(failed))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
