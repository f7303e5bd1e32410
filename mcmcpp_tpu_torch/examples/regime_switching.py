"""Regime-switching state space: online regime tracking with the
Rao-Blackwellised (mixture Kalman) filter, then inference on the
observation noise by PMMH driven by the same filter through ``loglik_fn``.

The port of ``examples/regime_switching.py``. A local level whose drift
variance switches between a calm and a volatile regime (a 2-state Markov
chain):

    z_t ~ Markov(P),  P = [[0.95, 0.05], [0.10, 0.90]]
    x_t = x_{t-1} + N(0, q[z_t]),   q = (0.02², 0.5²)
    y_t = x_t + N(0, r²)

Returns non-zero outside the reference's bounds (classification accuracy
> 0.7; at full size the posterior mean of r within 0.15 of the truth).

Usage:
    python -m mcmcpp_tpu_torch.examples.regime_switching [--quick] \
        [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import PMMHSampler, rao_blackwell_filter, switching_model

TRANS = np.array([[0.95, 0.05], [0.10, 0.90]], np.float32)
SIG_Q = np.array([0.02, 0.5], np.float32)   # calm / volatile drift
SIG_R = 0.25


def simulate(t_n, seed=0):
    rng = np.random.default_rng(seed)
    z, x = 0, 0.0
    zs, ys = [], []
    for t in range(t_n):
        if t > 0:
            z = rng.choice(2, p=TRANS[z])
            x = x + SIG_Q[z] * rng.standard_normal()
        zs.append(z)
        ys.append(x + SIG_R * rng.standard_normal())
    return np.asarray(zs), np.asarray(ys, np.float32)


def build_model(sig_r, device="cuda"):
    """The switching model; ``sig_r`` may be a tensor (a PMMH parameter)."""
    eye = torch.eye(1, device=device)
    r = torch.as_tensor(sig_r, dtype=torch.float32, device=device) ** 2
    return switching_model(
        TRANS, A=torch.stack([eye, eye]),
        b=torch.zeros((2, 1), device=device),
        Q=torch.stack([float(SIG_Q[0]) ** 2 * eye,
                       float(SIG_Q[1]) ** 2 * eye]),
        H=torch.stack([eye, eye]), c=torch.zeros((2, 1), device=device),
        R=torch.stack([r * eye, r * eye]), m0=torch.zeros(1, device=device),
        P0=4.0 * eye, init_probs=np.array([0.9, 0.1], np.float32),
        device=device)


def track(ys, zs, n_particles, device, seed=0):
    """Online regime tracking: (accuracy of the filtered regime, result)."""
    res = rao_blackwell_filter(seed, build_model(SIG_R, device), ys,
                               n_particles, device=device)
    hard = res.z_stats.argmax(1).cpu().numpy()
    return float((hard == zs).mean()), res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    t_n = 80 if args.quick else 300
    n_particles = 256 if args.quick else 1024
    zs, ys = simulate(t_n, seed=7)

    # -- 1. online regime tracking
    acc, res = track(ys, zs, n_particles, dev)
    print(f"RBPF: T={t_n}, N={n_particles} regime-classification "
          f"accuracy {acc:.2f} (chance 0.5)")
    print(f"  log-evidence {float(res.loglik):.2f}; "
          f"min particle ESS {float(res.ess.min()):.0f}")

    # -- 2. PMMH over log r with the Rao-Blackwellised likelihood
    n_pm = n_particles if args.quick else 512

    def loglik_fn(gen, theta):
        return rao_blackwell_filter(gen, build_model(torch.exp(theta[0]), dev),
                                    ys, n_pm).loglik

    pm = PMMHSampler(None, None, log_prior=lambda th: -0.5 * th[0] ** 2,
                     n_params=1, proposal_scale=0.25, n_chains=8, seed=1,
                     loglik_fn=loglik_fn, device=dev)
    pm.init(np.full((8, 1), np.log(0.5), np.float32))
    pm.run(60 if args.quick else 300)
    draws = np.exp(pm.get_samples(burn_in=20 if args.quick else 100,
                                  flat=True))
    print(f"PMMH (RB'd likelihood): r posterior {draws.mean():.3f} +- "
          f"{draws.std():.3f} (truth {SIG_R})")
    print(f"  acceptance {pm.acceptance_fraction.mean():.2f}")
    ok = acc > 0.7 and (args.quick or abs(draws.mean() - SIG_R) < 0.15)
    print("OK" if ok else "FAILED: outside the bounds")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
