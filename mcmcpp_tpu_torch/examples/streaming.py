"""Streaming Bayesian inference with IBIS: an online posterior and a live
prequential Bayes factor between two models.

The port of ``examples/streaming.py``. M0 is a fixed N(0, 1); M1 an
unknown-mean N(θ, 1) with θ ~ N(0, 2²). The stream's first half has mean 0
(M0's parsimony wins) and its second mean 1.5 (M1 wins); after every chunk
M1's IBIS run extends in place and the running log Bayes factor is printed.
Returns non-zero outside the reference's bounds (the factor below 1 at the
switch and above 3 at the end).

Usage:
    python -m mcmcpp_tpu_torch.examples.streaming [--quick] \
        [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import IBISSampler

TAU = 2.0


def make_stream(n_per_regime, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n_per_regime)
    b = 1.5 + rng.standard_normal(n_per_regime)
    return np.concatenate([a, b]).astype(np.float32)


def m1_sampler(n_particles, batch_size, device, seed=0, max_chunk_steps=32):
    """M1's IBIS run (a per-row log-likelihood, vmapped over rows and
    particles)."""
    return IBISSampler(
        log_prior_fn=lambda t: -0.5 * t[0] ** 2 / TAU ** 2,
        loglike_point_fn=lambda t, y: -0.5 * (y - t[0]) ** 2
        - 0.5 * np.log(2 * np.pi),
        prior_sample_fn=lambda g, n: TAU * torch.randn(
            (n, 1), generator=g, device=g.device),
        n_particles=n_particles, n_params=1, batch_size=batch_size,
        seed=seed, max_chunk_steps=max_chunk_steps, device=device)


def m0_logz(ys):
    """M0's exact log evidence: the N(0, 1) log score."""
    return float(np.sum(-0.5 * np.asarray(ys, np.float64) ** 2
                        - 0.5 * np.log(2 * np.pi)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_half = 40 if args.quick else 120
    chunk = 10 if args.quick else 20
    ys = make_stream(n_half)
    m1 = m1_sampler(2048, 5, args.device)
    logz0 = 0.0
    print(f"{'rows':>5} {'post mean (M1)':>15} {'log BF (M1-M0)':>15}")
    flips = []
    for start in range(0, len(ys), chunk):
        batch = ys[start:start + chunk]
        m1.update(batch)
        logz0 += m0_logz(batch)
        bf = m1.log_evidence - logz0
        flips.append(bf)
        print(f"{start + len(batch):>5} {float(m1.moments()[0][0]):>15.3f} "
              f"{bf:>15.2f}")
    post = m1.posterior(2000, seed=1)
    print(f"final posterior mean {post.mean():.3f}; resample events: "
          f"{m1.n_resamples}")
    ok = flips[len(flips) // 2 - 1] < 1.0 and flips[-1] > 3.0
    print("OK" if ok else "FAILED: outside the bounds")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
