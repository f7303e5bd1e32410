"""Gaussian-process latent inference with elliptical slice sampling.

The port of ``examples/gp_latent.py``: a 1-D log-Gaussian-Cox-style model,
f ~ GP(0, RBF), counts y_i ~ Poisson(exp(f_i)). The GP prior is the
structure elliptical slice sampling (Murray et al. 2010) exploits: no
tuning, no gradients, every proposal on the prior ellipse. Returns non-zero
unless more than 80% of the true latents lie within 2 posterior sds of the
posterior mean.

Usage:
    python -m mcmcpp_tpu_torch.examples.gp_latent [--n 60] [--quick] \
        [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import EllipticalSliceSampler
from mcmcpp_tpu_torch.sampler import resolve_device


def make_problem(n, seed=0):
    """The prior factor (float32), the true latent and the counts."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 4.0, n)
    k = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.5 ** 2)
    chol = np.linalg.cholesky(k + 1e-6 * np.eye(n)).astype(np.float32)
    f_true = chol @ rng.standard_normal(n).astype(np.float32)
    y = rng.poisson(np.exp(f_true)).astype(np.float32)
    return chol, f_true, y


def make_loglike(y):
    """Poisson(exp(f)) counts, per θ; ``y`` a tensor."""
    def loglike(f):
        return torch.sum(y * f - torch.exp(f))

    return loglike


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    n = args.n
    steps = 400 if args.quick else 4000

    chol, f_true, y = make_problem(n)
    s = EllipticalSliceSampler(
        make_loglike(torch.as_tensor(y, device=args.device)),
        prior_mean=np.zeros(n), prior_chol=chol, n_chains=64, seed=1,
        device=args.device)
    s.init_prior(seed=2)
    s.run(steps // 4)  # burn-in
    s.chain.clear()
    s.run(steps)
    flat = s.get_samples(flat=True)
    f_mean = flat.mean(axis=0)
    f_sd = flat.std(axis=0)
    inside = float(np.mean(np.abs(f_mean - f_true) < 2 * f_sd))
    rmse = float(np.sqrt(np.mean((f_mean - f_true) ** 2)))
    print(f"n={n} latents, {steps} steps x 64 chains")
    print(f"posterior-mean RMSE vs true latent: {rmse:.3f} "
          f"(prior sd ~ 1.0)")
    print(f"truth within 2sd band: {100 * inside:.0f}% of inputs")
    ok = inside > 0.8
    print("OK" if ok else "FAILED: 80% or fewer inside the band")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
