"""Gradient-based inference: NUTS, HMC, MALA, SMC and ADVI on one posterior.

The port of ``examples/gradient_inference.py``: a correlated Gaussian
posterior (AR(1) correlation, ρ = 0.5) fit with every gradient-based engine,
their posterior summaries side by side. Beyond the reference, whose
Calculator contract is gradient-free.

The JAX program prints its checks; this one returns non-zero unless they
hold: each MCMC engine's largest |mean| below 0.2 (the posterior sds are 1),
its largest R-hat below 1.1 (fixed-length HMC's is 1.04 in both packages)
and its smallest ESS above 100; SMC's particles' largest |mean| below 0.2
and its log evidence within 0.5 of the closed form, −½ log det(I + 9Λ)
(prior N(0, 9I), the likelihood the unnormalized Gaussian of precision Λ);
ADVI's largest |mean| below 0.25 and its covariance within 0.35 of the
truth (the JAX package's run: 0.115 and 0.224). ``--quick`` cuts the
steps.

Usage:
    python -m mcmcpp_tpu_torch.examples.gradient_inference [--dim 10] \
        [--chains 64] [--quick] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    ADVI,
    HMCSampler,
    MALASampler,
    NUTSSampler,
    SMCSampler,
)
from mcmcpp_tpu_torch.analysis import summary
from mcmcpp_tpu_torch.sampler import resolve_device

RHO = 0.5
PRIOR_VAR = 9.0


def target(dim, device, dtype=torch.float32):
    """The AR(1) covariance and the per-θ logp −½ θᵀΛθ."""
    idx = np.arange(dim)
    cov = RHO ** np.abs(idx[:, None] - idx[None, :])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=dtype, device=device)

    def logp(t):
        return -0.5 * t @ (prec @ t)

    return cov, logp


def exact_log_evidence(cov):
    """log E_prior[exp(−½ θᵀΛθ)] under θ ~ N(0, 9I): −½ log det(I + 9Λ)."""
    lam = np.linalg.inv(cov)
    return -0.5 * np.linalg.slogdet(np.eye(len(cov)) + PRIOR_VAR * lam)[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=10)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    dim, dev = args.dim, args.device
    warm, steps, vi_steps = (400, 500, 1000) if args.quick else (400, 1000,
                                                                 2000)
    cov, logp = target(dim, dev)
    failed = []

    print(f"target: {dim}-D AR(1)-correlated Gaussian, rho={RHO}")
    for name, cls, kw in [
        ("NUTS", NUTSSampler, {"max_depth": 8}),
        ("HMC", HMCSampler, {"n_leapfrog": 16}),
        ("MALA", MALASampler, {}),
    ]:
        s = cls(torch.func.vmap(logp), n_chains=args.chains, n_params=dim,
                seed=0, device=dev, **kw)
        s.init_ball(np.zeros(dim), scale=1.0, seed=1)
        s.warmup(warm)
        s.run(steps)
        st = summary(s.get_samples(burn_in=100), device=dev)
        mean, rhat, ess = (np.abs(st["mean"]).max(), st["rhat"].max(),
                           st["ess"].min())
        step = float(torch.as_tensor(s.step_size).mean())
        print(f"{name:5s} accept={s.last_mean_accept:.2f} step={step:.3f} "
              f"max|mean|={mean:.3f} max rhat={rhat:.3f} min ess={ess:.0f}")
        if not (mean < 0.2 and rhat < 1.1 and ess > 100):
            failed.append(name)

    smc = SMCSampler(
        log_prior_fn=lambda t: -0.5 * torch.sum(t * t) / PRIOR_VAR,
        log_like_fn=logp,
        prior_sample_fn=lambda g, n: 3.0 * torch.randn(
            (n, dim), generator=g, device=g.device),
        n_particles=4096, n_params=dim, seed=0, device=dev)
    smc.run()
    exact = exact_log_evidence(cov)
    smc_mean = float(np.abs(np.asarray(smc.particles).mean(0)).max())
    print(f"SMC   stages={smc.n_stages} logZ={smc.log_evidence:.2f} "
          f"(exact {exact:.2f}) max|mean|={smc_mean:.3f}")
    if not (abs(smc.log_evidence - exact) < 0.5 and smc_mean < 0.2):
        failed.append("SMC")

    vi = ADVI(logp, n_params=dim, full_rank=True, learning_rate=0.02, seed=0,
              device=dev)
    vi.fit(vi_steps)
    vi_mean = float(np.abs(np.asarray(vi.mean)).max())
    err = float(np.abs(np.asarray(vi.cov) - cov).max())
    print(f"ADVI  max|mean|={vi_mean:.3f} max|cov err|={err:.3f}")
    if not (vi_mean < 0.25 and err < 0.35):
        failed.append("ADVI")
    print("OK" if not failed else "FAILED: " + ", ".join(failed))
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
