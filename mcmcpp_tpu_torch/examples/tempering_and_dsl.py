"""Parallel tempering and the log-prob DSL, a walkthrough.

The port of ``examples/tempering_and_dsl.py``:

1. a declarative model (DSL) with a positive scale, compiled to a flat logp
   and fit with NUTS;
2. parallel tempering rescuing mixing on a two-mode target whose modes are
   16 σ apart (the plain stretch move cannot cross).

The JAX program prints its checks; this one returns non-zero unless they
hold: the posterior means of mu and sigma within 3 posterior sds (0.7/√n and
0.7/√(2n)) of the data's own mean and sd, the cold chain's share in the
right mode inside (0.3, 0.7) (0.5 ideal, 0.0 without tempering) and every
ladder pair swapping. ``--quick`` cuts the steps.

Usage:
    python -m mcmcpp_tpu_torch.examples.tempering_and_dsl [--quick] \
        [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    NUTSSampler,
    ParallelTemperingSampler,
    gaussian_mixture,
)
from mcmcpp_tpu_torch.dsl import HalfNormal, Model, Normal
from mcmcpp_tpu_torch.sampler import resolve_device


def make_data(seed=0):
    return np.random.default_rng(seed).normal(1.5, 0.7, 200).astype(
        np.float32)


def build_model(data):
    """mu ~ N(0, 10), sigma ~ HalfNormal(2), data ~ N(mu, sigma); ``data``
    a tensor (its device is the logp's)."""
    return (
        Model()
        .param("mu", Normal(0.0, 10.0))
        .param("sigma", HalfNormal(2.0))
        .likelihood(
            lambda p: torch.sum(Normal(p["mu"], p["sigma"]).logpdf(data)))
    )


def dsl_demo(device, quick):
    y = make_data()
    data = torch.as_tensor(y, device=device)
    logp, dim, constrain = build_model(data).build()
    s = NUTSSampler(torch.func.vmap(logp), n_chains=32, n_params=dim, seed=0,
                    device=device)
    s.init_ball(np.zeros(dim), scale=1.0)
    s.warmup(100 if quick else 400)
    s.run(250 if quick else 1000)
    draws = constrain(s.get_samples(burn_in=100, flat=True))
    mu, sigma = draws["mu"], draws["sigma"]
    print("[dsl] posterior mu    :",
          f"{mu.mean():.3f} ± {mu.std():.3f} (true 1.5)")
    print("[dsl] posterior sigma :",
          f"{sigma.mean():.3f} ± {sigma.std():.3f} (true 0.7)")
    n = len(y)
    ok = (abs(mu.mean() - y.mean()) < 3 * 0.7 / np.sqrt(n)
          and abs(sigma.mean() - y.std()) < 3 * 0.7 / np.sqrt(2 * n))
    print(f"[dsl] data mean {y.mean():.3f}, sd {y.std():.3f}: "
          f"{'within' if ok else 'OUTSIDE'} 3 posterior sds")
    return ok


def tempering_demo(device, quick):
    t = gaussian_mixture([[-8.0], [8.0]], scales=[0.5, 0.5], device=device)
    pt = ParallelTemperingSampler(
        t, n_walkers=64, n_params=1, n_temps=8, seed=1,
        betas=np.geomspace(1.0, 0.005, 8), batched=True, device=device)
    pt.init_ball(np.array([-8.0]), scale=0.5)  # everyone starts in one mode
    steps = 1000 if quick else 4000
    pt.run_mcmc(steps)
    flat = pt.get_samples(burn_in=steps // 4, flat=True)[:, 0]
    right = float((flat > 0).mean())
    swaps = np.asarray(pt.swap_acceptance)
    print(f"[pt] fraction in right mode: {right:.2f} "
          f"(0.5 ideal; 0.0 without tempering)")
    print(f"[pt] swap acceptance per ladder pair: {np.round(swaps, 2)}")
    return 0.3 < right < 0.7 and bool(np.all(swaps > 0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    ok = dsl_demo(args.device, args.quick)
    ok = tempering_demo(args.device, args.quick) and ok
    print("OK" if ok else "FAILED: outside the bounds")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
