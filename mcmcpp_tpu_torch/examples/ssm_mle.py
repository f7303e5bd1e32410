"""SSM parameter estimation three ways: the exact Kalman MLE, IF2 and PMMH.

The port of ``examples/ssm_mle.py``: one linear-Gaussian state-space model
(so the exact answer is computable), and the particle toolbox's routes to
it: IF2 iterated filtering (a simulation-based MLE) and PMMH (a posterior
whose mean brackets the same point). The exact MLE is a Nelder–Mead search
over the port's own collapsed Kalman likelihood. Returns non-zero when
IF2's estimate is further than (0.05, 0.10) from the exact MLE in (a,
log σ_r), the bounds of ``tests/test_if2.py``.

Usage:
    python -m mcmcpp_tpu_torch.examples.ssm_mle [--t 150] [--if2-iters 30] \
        [--particles 1500] [--pmmh-steps 550] [--quick] [--device cuda|cpu]

``--quick`` runs 40 PMMH steps (the IF2 check is unchanged).
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import PMMHSampler, StateSpaceModel, if2
from mcmcpp_tpu_torch.models.lgss import lgss_loglik, lgss_params

A_TRUE, Q_TRUE, SR_TRUE = 0.85, 0.3, 0.5
SQ = float(np.sqrt(Q_TRUE))
C0 = 0.5 * np.log(2 * np.pi)


def simulate(t_n, seed=11):
    rng = np.random.default_rng(seed)
    x, ys = 0.0, np.empty(t_n, np.float32)
    for t in range(t_n):
        x = A_TRUE * x + SQ * rng.standard_normal()
        ys[t] = x + SR_TRUE * rng.standard_normal()
    return ys


def exact_loglik(theta, ys):
    p = lgss_params(A=float(theta[0]), b=0.0, Q=Q_TRUE, H=1.0, c=0.0,
                    R=float(np.exp(2 * theta[1])), m0=0.0, P0=0.0,
                    dtype=torch.float64, device="cpu")
    return float(lgss_loglik(p, ys, initial="prior"))


def kalman_mle(ys):
    from scipy.optimize import minimize

    return minimize(lambda th: -exact_loglik(th, ys), x0=[0.5, 0.0],
                    method="Nelder-Mead",
                    options={"xatol": 1e-5, "fatol": 1e-8}).x


def if2_model():
    """θ = [a, log σ_r], per particle (the IF2 hook contract)."""
    return StateSpaceModel(
        init_sample=lambda g, n, th: SQ * torch.randn(
            (n, 1), generator=g, device=g.device),
        trans_sample=lambda g, x, t, th: th[:, 0:1] * x + SQ * torch.randn(
            x.shape, generator=g, device=g.device),
        obs_logpdf=lambda y, x, t, th: (
            -0.5 * ((y[0] - x[:, 0]) / torch.exp(th[:, 1])) ** 2
            - th[:, 1] - C0))


def pmmh_model():
    """The same model with θ (C, 2) for C filters at once (PMMH with
    ``batched=True``)."""
    return StateSpaceModel(
        init_sample=lambda g, n, th: SQ * torch.randn(
            (th.shape[0], n, 1), generator=g, device=g.device),
        trans_sample=lambda g, x, t, th: th[:, None, :1] * x + SQ
        * torch.randn(x.shape, generator=g, device=g.device),
        obs_logpdf=lambda y, x, t, th: (
            -0.5 * ((y[0] - x[..., 0]) / torch.exp(th[:, 1:])) ** 2
            - th[:, 1:] - C0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=150)
    ap.add_argument("--if2-iters", type=int, default=30)
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--pmmh-steps", type=int, default=550)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.pmmh_steps = 40
    ys = simulate(args.t)
    mle = kalman_mle(ys)
    print(f"truth        : a={A_TRUE:.3f}  log_sr={np.log(SR_TRUE):+.3f}")
    print(f"Kalman MLE   : a={mle[0]:.3f}  log_sr={mle[1]:+.3f}")
    r = if2(0, if2_model(), ys, n_particles=args.particles,
            theta0=np.array([0.5, 0.0], np.float32), sigma0=0.05,
            n_iters=args.if2_iters, cooling=0.9, device=args.device)
    est = r.theta.cpu().numpy()
    print(f"IF2 MLE      : a={est[0]:.3f}  log_sr={est[1]:+.3f}  "
          f"(final swarm sd {r.theta_sd_trace[-1].cpu().numpy().round(4)})")
    pm = PMMHSampler(pmmh_model(), ys,
                     log_prior=lambda th: -0.5 * torch.sum(th * th, -1) / 4.0,
                     n_params=2, n_particles=256, proposal_scale=[0.04, 0.08],
                     n_chains=16, seed=0, batched=True, device=args.device)
    pm.init(np.tile(np.array([0.5, 0.0], np.float32), (16, 1)))
    pm.run(args.pmmh_steps)
    post = pm.get_samples(burn_in=args.pmmh_steps * 3 // 11, flat=True)
    print(f"PMMH mean    : a={post[:, 0].mean():.3f}  "
          f"log_sr={post[:, 1].mean():+.3f}  (sd {post.std(axis=0).round(3)})")
    err = np.abs(est - mle)
    print(f"\nIF2 - MLE    : |da|={err[0]:.3f}  |dlog_sr|={err[1]:.3f}")
    ok = err[0] < 0.05 and err[1] < 0.10
    print("OK" if ok else "FAILED: IF2 off the exact MLE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
