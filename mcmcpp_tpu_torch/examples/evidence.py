"""Bayesian model comparison with the evidence triad.

The port of ``examples/evidence.py``. Which model generated the data: a
single Gaussian (M1) or a symmetric two-component mixture (M2)? The
marginal likelihoods answer it directly (posterior odds = Bayes factor ×
prior odds). log Z of both models is computed three independent ways:

1. nested sampling (:class:`NestedSampler`);
2. adaptive-ladder SMC (:class:`SMCSampler`);
3. power-posterior parallel tempering (:class:`ParallelTemperingSampler`
   with ``loglike_fn``/``logprior_fn``), the stepping-stone estimator;

and by quadrature on a fine grid (both models have one parameter), printed
beside them. Returns non-zero unless the three engines agree within 1 nat on
each model and the log Bayes factor of M2 over M1 is above 5.

Usage:
    python -m mcmcpp_tpu_torch.examples.evidence [--quick] \
        [--device cuda|cpu]
"""

import argparse
import math
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    NestedSampler,
    ParallelTemperingSampler,
    SMCSampler,
    power_ladder,
)
from mcmcpp_tpu_torch.sampler import resolve_device

SIGMA = 0.6  # the known observation sd of both models
PRIOR_SD = 5.0


def make_data(seed=7):
    """A bimodal sample: two Gaussians at ±2."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(-2.0, SIGMA, 60),
                           rng.normal(2.0, SIGMA, 60)]).astype(np.float32)


def m1(data):
    """M1, a single Gaussian: θ = (mu,), mu ~ N(0, 5²). Returns per-θ
    ``(logprior, loglike, prior_sample)``; ``data`` a tensor."""
    norm = math.log(SIGMA * math.sqrt(2 * math.pi))

    def logprior(t):
        return (-0.5 * torch.sum(t * t) / PRIOR_SD ** 2
                - 0.5 * math.log(2 * math.pi * PRIOR_SD ** 2))

    def loglike(t):
        return torch.sum(-0.5 * ((data - t[0]) / SIGMA) ** 2 - norm)

    def prior_sample(g, n):
        return PRIOR_SD * torch.randn((n, 1), generator=g, device=g.device)

    return logprior, loglike, prior_sample


def m2(data):
    """M2, the symmetric mixture ½N(s, σ²) + ½N(−s, σ²): θ = (s,), s ~
    HalfNormal(5) (the density's log 2 + N(0, 5²) on s > 0, −inf below)."""
    norm = math.log(0.5) - math.log(SIGMA * math.sqrt(2 * math.pi))

    def logprior(t):
        lp = (math.log(2.0) - 0.5 * t[0] ** 2 / PRIOR_SD ** 2
              - 0.5 * math.log(2 * math.pi * PRIOR_SD ** 2))
        return torch.where(t[0] > 0.0, lp, -torch.inf)

    def loglike(t):
        s = t[0]
        a = -0.5 * ((data - s) / SIGMA) ** 2
        b = -0.5 * ((data + s) / SIGMA) ** 2
        return torch.sum(torch.logaddexp(a, b) + norm)

    def prior_sample(g, n):
        return torch.abs(PRIOR_SD * torch.randn((n, 1), generator=g,
                                                device=g.device))

    return logprior, loglike, prior_sample


def quadrature_logz(logprior, loglike, lo=-20.0, hi=20.0, n=400_001,
                    device="cpu"):
    """log ∫ exp(logprior + loglike) dθ by the trapezoid rule on ``n``
    points of [lo, hi], in float64 (the functions must take float64 θ)."""
    grid = torch.linspace(lo, hi, n, dtype=torch.float64, device=device)
    f = torch.func.vmap(lambda t: logprior(t) + loglike(t))(grid[:, None])
    w = torch.full_like(f, (hi - lo) / (n - 1))
    w[0] = w[-1] = 0.5 * w[0]
    return float(torch.logsumexp(f + torch.log(w), dim=0))


def triad(tag, model, quick, device):
    logprior, loglike, prior_sample = model
    ns = NestedSampler(logprior, loglike, prior_sample, n_params=1,
                       n_live=300 if quick else 600, n_mcmc=20, seed=0,
                       device=device)
    r = ns.run()
    smc = SMCSampler(logprior, loglike, prior_sample,
                     n_particles=1024 if quick else 4096, n_params=1,
                     n_mcmc=5, seed=0, device=device)
    smc.run()
    k = 8 if quick else 16
    pt = ParallelTemperingSampler(
        loglike_fn=loglike, logprior_fn=logprior, n_walkers=128,
        n_params=1, betas=power_ladder(k), seed=0, device=device)
    pt.init_ball(np.ones(1), scale=0.5)
    pt.run_mcmc(300, thin=300)
    pt.reset_evidence()
    pt.run_mcmc(500 if quick else 2000, thin=10)
    ss = pt.log_evidence("stepping_stone")
    spread = max(r.logz, smc.log_evidence, ss) - min(
        r.logz, smc.log_evidence, ss)
    print(f"{tag}: nested={r.logz:+.2f}±{r.logz_err:.2f}  "
          f"smc={smc.log_evidence:+.2f}  pt-ss={ss:+.2f}  "
          f"(spread {spread:.2f})")
    return float(np.mean([r.logz, smc.log_evidence, ss])), spread


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    y = make_data()
    data = torch.as_tensor(y, device=args.device)
    print(f"n={len(y)} bimodal observations")
    exact = [quadrature_logz(*m(torch.as_tensor(y, dtype=torch.float64,
                                                device=args.device))[:2],
                             device=args.device) for m in (m1, m2)]
    lz1, sp1 = triad("M1 (single Gaussian)  ", m1(data), args.quick,
                     args.device)
    lz2, sp2 = triad("M2 (symmetric mixture)", m2(data), args.quick,
                     args.device)
    print(f"quadrature: M1 {exact[0]:+.2f}, M2 {exact[1]:+.2f}")
    bf = lz2 - lz1
    print(f"log Bayes factor (M2 vs M1): {bf:+.1f} "
          f"({'decisive for M2' if bf > 5 else 'inconclusive'})")
    ok = sp1 < 1.0 and sp2 < 1.0 and bf > 5
    print("OK" if ok else "FAILED: the engines disagree by 1 nat or more, "
          "or the mixture does not win decisively")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
