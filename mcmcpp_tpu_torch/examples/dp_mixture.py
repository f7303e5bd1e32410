"""Dirichlet-process mixture (truncated): Bayesian nonparametric density
estimation with the GEM stick-breaking prior.

The port of ``examples/dp_mixture.py``. The model never fixes the number of
clusters: K is a truncation level, ``w ~ GEM(alpha, K)`` puts geometrically
decaying mass on the sticks, and the learned concentration ``alpha`` says
how many components the data activate (Ishwaran & James 2001). An
``Ordered`` prior on the component means breaks label switching. On three
well-separated Gaussian clusters the K = 8 mixture should (a) put nearly all
weight on 3 components and (b) recover the predictive density. Outside
``--quick`` it returns non-zero unless the density's L1 error is below 0.15
and exactly 3 components hold more than 5% of the weight.

Usage:
    python -m mcmcpp_tpu_torch.examples.dp_mixture [--quick] [--n 400] \
        [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import NUTSSampler
from mcmcpp_tpu_torch.dsl import (
    GEM,
    Gamma,
    HalfNormal,
    Mixture,
    Model,
    Normal,
    StickBreaking,
    ordered,
)
from mcmcpp_tpu_torch.sampler import resolve_device

K = 8
TRUE_MEANS = np.array([-3.0, 0.5, 4.0])
TRUE_SDS = np.array([0.6, 0.5, 0.8])
TRUE_W = np.array([0.3, 0.45, 0.25])
GRID = np.linspace(-6.5, 7.5, 281)


def make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.choice(3, size=n, p=TRUE_W)
    return (TRUE_MEANS[z] + TRUE_SDS[z] * rng.standard_normal(n)).astype(
        np.float32)


def build_model(y):
    def obs(p):
        comps = [Normal(p["mu"][k], p["sigma"][k]) for k in range(K)]
        return Mixture(comps, weights=p["w"])

    return (
        Model()
        .param("alpha", Gamma(2.0, 1.0))
        .param("w", lambda p: GEM(p["alpha"], K), shape=(K,),
               transform=StickBreaking(K))
        .param("mu", ordered(Normal(0.0, 5.0)), shape=(K,))
        .param("sigma", HalfNormal(2.0), shape=(K,))
        .observe("y", obs, y)
    )


def _norm_pdf(x, m, s):
    return np.exp(-0.5 * ((x - m) / s) ** 2) / (s * np.sqrt(2 * np.pi))


def true_density(grid):
    return sum(w * _norm_pdf(grid, m, s)
               for w, m, s in zip(TRUE_W, TRUE_MEANS, TRUE_SDS))


def predictive_density(post, grid, max_draws=400):
    """The posterior predictive density on ``grid`` from at most about
    ``max_draws`` draws of the constrained posterior ``post``."""
    sub = slice(None, None, max(1, post["w"].shape[0] // max_draws))
    w_s, mu_s, sd_s = (np.asarray(post[k])[sub] for k in ("w", "mu",
                                                           "sigma"))
    dens = np.zeros_like(grid)
    for wk, mk, sk in zip(w_s, mu_s, sd_s):
        dens += (wk[None, :] * _norm_pdf(grid[:, None], mk[None, :],
                                         sk[None, :])).sum(axis=1)
    return dens / len(w_s)


def l1_error(dens, grid):
    """∫ |dens − truth| by the trapezoid rule."""
    f = np.abs(dens - true_density(grid))
    return float(np.sum(0.5 * (f[1:] + f[:-1]) * np.diff(grid)))


def run(n=400, quick=False, device="cuda", chains=16, warmup=None,
        steps=None, max_depth=8):
    """Fit the mixture to ``n`` points and measure it; the budgets default
    to the program's (``quick``: 150 + 300 steps, else 600 + 1500).
    Returns a dict: the constrained draws ``post``, the posterior mean
    weights ``w_mean``, the ``active`` components, the density's ``l1``
    error and ``ok`` (the gates, which ``quick`` skips)."""
    warm_d, steps_d = (150, 300) if quick else (600, 1500)
    warmup = warm_d if warmup is None else warmup
    steps = steps_d if steps is None else steps
    logp, dim, constrain = build_model(make_data(n)).build()
    print(f"DP mixture: truncation K={K}, {dim} unconstrained dims, n={n}")

    s = NUTSSampler(torch.func.vmap(logp), n_chains=chains, n_params=dim,
                    seed=0, max_depth=max_depth, device=device)
    s.init_ball(np.zeros(dim), scale=0.3, seed=1)
    s.warmup(warmup)
    s.run(steps)
    post = constrain(s.get_samples(burn_in=steps // 5, flat=True))

    # (a) how many components does the posterior actually use?
    w_mean = np.asarray(post["w"]).mean(axis=0)
    active = int((np.sort(w_mean)[::-1] > 0.05).sum())
    print("posterior mean stick weights:",
        np.array2string(w_mean, precision=3))
    print(f"components with >5% weight: {active} (truth: 3)")
    print(f"posterior mean alpha: {float(np.mean(post['alpha'])):.2f}")

    # (b) posterior predictive density vs truth on a grid
    l1 = l1_error(predictive_density(post, GRID), GRID)
    print(f"predictive-density L1 error: {l1:.3f} (0 = exact)")
    ok = quick or (l1 < 0.15 and active == 3)
    return {"post": post, "w_mean": w_mean, "active": active, "l1": l1,
            "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)  # no CPU fallback
    out = run(args.n, args.quick, args.device)
    print("OK" if out["ok"] else "FAILED: outside the bounds (L1 < 0.15, "
          "3 active components)")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
