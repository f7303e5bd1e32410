"""Hierarchical (eight-schools) model: the DSL + ChEES-HMC workflow.

The port of ``examples/hierarchical.py``: named parameters with priors, a
plate, a deterministic (the non-centered reparameterization), an observe
site, ChEES-HMC on the DSL's vmapped logp run by `run_until_converged`,
and posterior-predictive replication. Beyond the reference, whose "model
language" is a black-box C++ Calculator
(``MCMCpp/Utility/UserOjbectsTest.h:144-151``).

Usage:
    python -m mcmcpp_tpu_torch.examples.hierarchical [--device cuda|cpu] \
        [--chains 32] [--warmup 700] [--max-steps 20000] [--check-every 2000]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import CheesHMCSampler, run_until_converged
from mcmcpp_tpu_torch.dsl import HalfNormal, Model, Normal
from mcmcpp_tpu_torch.ops.random import make_generator

# Rubin (1981) eight-schools data: treatment effects and standard errors
Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def build_model():
    return (
        Model()
        .plate("schools", len(Y))
        .param("mu", Normal(0.0, 10.0))
        .param("tau", HalfNormal(10.0))
        .param("theta_raw", Normal(0.0, 1.0), plate="schools")
        # non-centered: theta = mu + tau * theta_raw (the funnel lives in
        # theta_raw, which is a priori N(0, 1))
        .deterministic("theta", lambda p: p["mu"] + p["tau"] * p["theta_raw"])
        .observe("y", lambda p: Normal(p["theta"], SIGMA), Y)
    )


def run(chains=32, warmup=700, max_steps=20000, check_every=2000,
        device="cuda", seed=0, quiet=False):
    """Fit eight schools; returns a dict with the named draws (``draws``),
    the flat unconstrained draws (``flat``), the convergence report
    (``report``), the sampler and the model."""
    say = (lambda *a: None) if quiet else print
    model = build_model()
    logp, dim, constrain = model.build()
    say(f"eight schools: {dim} unconstrained parameters")
    s = CheesHMCSampler(torch.func.vmap(logp), n_chains=chains, n_params=dim,
                        seed=seed, device=device)
    s.init_ball(np.zeros(dim), scale=0.5)
    s.warmup(warmup)
    say(f"adapted: step={float(torch.as_tensor(s.step_size).mean()):.3f} "
        f"trajectory={s.traj_length:.3f}")
    rep = run_until_converged(s, max_steps=max_steps, check_every=check_every,
                              act_multiplier=50, rhat_threshold=1.01)
    say(f"convergence: {rep.reason} after {rep.steps_run} steps "
        f"(tau_max={np.max(rep.tau):.1f})")
    flat = s.get_samples(flat=True)
    draws = constrain(flat)
    return {"draws": draws, "flat": flat, "report": rep, "sampler": s,
            "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=700)
    ap.add_argument("--max-steps", type=int, default=20000)
    ap.add_argument("--check-every", type=int, default=2000)
    args = ap.parse_args(argv)

    out = run(args.chains, args.warmup, args.max_steps, args.check_every,
              args.device)
    draws, flat = out["draws"], out["flat"]
    print(f"mu    = {draws['mu'].mean():6.2f} +- {draws['mu'].std():.2f}")
    print(f"tau   = {draws['tau'].mean():6.2f} +- {draws['tau'].std():.2f}")
    print("theta =", np.round(draws["theta"].mean(axis=0), 2))

    # posterior predictive: replicate the study
    take = flat[:: max(1, len(flat) // 1000)]
    gen = make_generator(1, 0, out["sampler"].device)
    y_rep = out["model"].posterior_predictive(gen, take)["y"]
    print("y_rep mean:", np.round(y_rep.mean(axis=0), 1))
    print("observed  :", Y)
    # posterior-predictive p-value for the max statistic
    p_max = float(np.mean(y_rep.max(axis=1) > Y.max()))
    print(f"posterior-predictive p(max y_rep > max y) = {p_max:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
