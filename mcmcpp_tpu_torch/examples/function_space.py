"""Function-space inference: pCN against elliptical slice on a GP latent.

The port of ``examples/function_space.py``. The defining pCN property
(Cotter et al. 2013): its proposal is reversible with respect to the
Gaussian prior, so the kernel is well defined on function space and its
acceptance does not degrade as the discretization of the latent function
refines. A latent f on a grid is inferred from 12 noisy point observations
under an RBF-kernel GP prior at three grid resolutions; for each the program
prints pCN's acceptance and the RMSE of both samplers' posterior means
against the exact GP-regression posterior mean.

The JAX program prints its checks; this one returns non-zero unless they
hold: pCN's acceptance flat in P (max − min below 0.1) and both samplers'
RMSE below 0.1 at every resolution (the posterior sd away from the data is
the prior's, 1). ``--quick`` runs 300 steps of 8 chains, as the JAX
package's test runs the program.

Usage:
    python -m mcmcpp_tpu_torch.examples.function_space [--steps 2000] \
        [--chains 32] [--beta 0.12] [--quick] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import EllipticalSliceSampler, PCNSampler
from mcmcpp_tpu_torch.sampler import resolve_device

ELL, SIG_OBS = 0.25, 0.15
X_OBS = np.linspace(0.05, 0.95, 12)
RNG = np.random.default_rng(3)
Y_OBS = (np.sin(2 * np.pi * X_OBS) * np.exp(-X_OBS)
         + SIG_OBS * RNG.standard_normal(X_OBS.size))
SIZES = (64, 256, 1024)
MAX_ACCEPT_SPREAD = 0.1
MAX_RMSE = 0.1


def _kernel(xa, xb):
    return np.exp(-0.5 * ((xa[:, None] - xb[None, :]) / ELL) ** 2)


def problem(p, device):
    """Grid of p points, observed at the nearest grid point: the prior
    factor (float64 numpy), the per-θ log-likelihood, and the exact
    GP-regression posterior mean at the grid."""
    grid = np.linspace(0.0, 1.0, p)
    chol = np.linalg.cholesky(_kernel(grid, grid) + 1e-6 * np.eye(p))
    obs_idx = torch.as_tensor(
        np.abs(grid[:, None] - X_OBS[None, :]).argmin(axis=0), device=device)
    y = torch.as_tensor(Y_OBS, dtype=torch.float32, device=device)

    def loglike(f):
        return -0.5 * torch.sum(torch.square((y - f[obs_idx]) / SIG_OBS))

    k_oo = _kernel(X_OBS, X_OBS) + SIG_OBS ** 2 * np.eye(X_OBS.size)
    exact_mean = _kernel(grid, X_OBS) @ np.linalg.solve(k_oo, Y_OBS)
    return chol, loglike, exact_mean


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--beta", type=float, default=0.12)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    steps, chains = (300, 8) if args.quick else (args.steps, args.chains)

    print(f"{'P':>6} {'pCN accept':>11} {'pCN RMSE':>9} {'ESS RMSE':>9}")
    accepts, rmses = [], []
    for p in SIZES:
        chol, loglike, exact_mean = problem(p, args.device)
        pcn = PCNSampler(loglike, prior_mean=np.zeros(p), prior_chol=chol,
                         beta=args.beta, n_chains=chains, seed=0,
                         device=args.device)
        pcn.init_prior(seed=1)
        pcn.run(steps // 2)  # burn-in
        pcn.chain.clear()
        pcn.run(steps)
        f_pcn = pcn.get_samples(flat=True).mean(axis=0)

        ess = EllipticalSliceSampler(loglike, prior_mean=np.zeros(p),
                                     prior_chol=chol, n_chains=chains, seed=0,
                                     device=args.device)
        ess.init_prior(seed=2)
        ess.run(steps // 4)
        ess.chain.clear()
        ess.run(steps // 2)  # rejection-free: fewer steps needed
        f_ess = ess.get_samples(flat=True).mean(axis=0)

        def rmse(f):
            return float(np.sqrt(np.mean((np.asarray(f) - exact_mean) ** 2)))

        accepts.append(pcn.acceptance_fraction)
        rmses += [rmse(f_pcn), rmse(f_ess)]
        print(f"{p:>6} {accepts[-1]:>11.3f} {rmses[-2]:>9.4f} "
              f"{rmses[-1]:>9.4f}")
    spread = max(accepts) - min(accepts)
    ok = spread < MAX_ACCEPT_SPREAD and max(rmses) < MAX_RMSE
    print(f"\npCN acceptance spread over P: {spread:.3f}; worst RMSE "
          f"{max(rmses):.4f}")
    print("pCN acceptance is FLAT in P (dimension-robust); both samplers "
          "match the exact GP-regression posterior mean." if ok else
          f"FAILED: outside the bounds (spread < {MAX_ACCEPT_SPREAD}, RMSE "
          f"< {MAX_RMSE})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
