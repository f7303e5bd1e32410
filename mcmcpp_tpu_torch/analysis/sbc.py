"""Simulation-based calibration (Talts et al. 2018, arXiv:1804.06788).

PyTorch counterpart of ``mcmcpp_tpu/analysis/sbc.py``. SBC checks the whole
inference pipeline (model, sampler, tuning) at once: draw θ* from the
prior, simulate data y* | θ*, fit the posterior and rank θ* among L
posterior draws. A calibrated pipeline gives ranks uniform on {0, …, L};
∪-shapes (overconfident), ∩-shapes (diffuse) and skews (bias) each have
their signature.

Randomness comes from ``torch.Generator``s where JAX splits keys: each
replication i gets its own generators, seeded from ``SeedSequence([seed,
i, stream])``. JAX's ``vectorized=True`` vmaps the pipeline; here it means
the three functions are written for the whole batch of replications at
once (a leading replication axis), which is how torch batches.
"""

import numpy as np
import torch
from scipy.special import gammaincc

from mcmcpp_tpu_torch.ops.random import make_generator
from mcmcpp_tpu_torch.sampler import resolve_device


def _numpy(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _generators(seed, i, device):
    """The prior, simulation and fit generators of replication ``i``."""
    return [make_generator(int(np.random.SeedSequence([int(seed), int(i)])
                               .generate_state(1)[0]), stream, device)
            for stream in range(3)]


def sbc_ranks(prior_sample, simulate, fit, n_sims, seed=0,
              vectorized=False, device="cuda"):
    """Rank statistics for ``n_sims`` SBC replications.

    prior_sample: (gen) -> θ* (Q,), the scalar quantities being calibrated.
    simulate: (gen, θ*) -> y* (anything ``fit`` takes): one dataset.
    fit: (gen, y*) -> (L, Q) posterior draws for that dataset, thinned to
        approximately independent draws (Talts et al. §5.1).
    vectorized: the functions take the whole batch instead:
        ``prior_sample(gen, n_sims) -> (n_sims, Q)``, ``simulate(gen, θ)``
        over the batch, ``fit(gen, y) -> (n_sims, L, Q)``, with one set of
        generators (those of replication 0).
    device: where the generators live ("cuda" unless asked for the CPU).

    Returns ``ranks`` (n_sims, Q) int32 in [0, L]: the number of posterior
    draws strictly below θ* per quantity.
    """
    device = resolve_device(device)
    if vectorized:
        gp, gs, gf = _generators(seed, 0, device)
        theta = _numpy(prior_sample(gp, int(n_sims)))
        draws = _numpy(fit(gf, simulate(gs, torch.as_tensor(
            theta, device=device))))
        return np.sum(draws < theta[:, None, :], axis=1).astype(np.int32)
    ranks = []
    for i in range(int(n_sims)):
        gp, gs, gf = _generators(seed, i, device)
        theta = prior_sample(gp)
        draws = _numpy(fit(gf, simulate(gs, theta)))
        ranks.append(np.sum(draws < _numpy(theta)[None, :], axis=0))
    return np.stack(ranks).astype(np.int32)


def sbc_uniformity(ranks, n_posterior_draws, n_bins=None):
    """χ² uniformity test per quantity over binned ranks.

    Returns (stat (Q,), p_value (Q,)): Pearson χ² against the uniform
    histogram with ``n_bins`` bins (default: L+1 capped at 20 so expected
    counts stay ≥ ~5) and its survival p-value by the regularized upper
    incomplete gamma (scipy's, in float64). Small p: the pipeline is
    miscalibrated for that quantity.
    """
    ranks = np.asarray(ranks)
    n_sims, n_q = ranks.shape
    levels = int(n_posterior_draws) + 1  # ranks live on {0..L}
    n_bins = int(min(levels, 20, max(2, n_sims // 5))
                 if n_bins is None else n_bins)
    n_bins = max(2, min(n_bins, levels))
    # integer edges give each bin a KNOWN number of rank values (levels is
    # often prime), and the per-bin expectation follows: the null is exact
    edges = np.round(np.linspace(0, levels, n_bins + 1)).astype(int)
    per_bin = np.diff(edges)
    expected = n_sims * per_bin / levels
    stats = np.empty(n_q)
    for q in range(n_q):
        counts, _ = np.histogram(ranks[:, q], bins=edges)
        stats[q] = np.sum((counts - expected) ** 2 / expected)
    df = n_bins - 1
    return stats, gammaincc(df / 2.0, stats / 2.0)


def sbc_model(build_model, fit, n_sims, seed=0, device="cuda"):
    """SBC for a declarative :class:`~mcmcpp_tpu_torch.dsl.Model`.

    ``build_model(sim_data)`` returns the Model: with ``None`` on its
    ORIGINAL data (the template whose priors and observe sites are the
    simulator), with a dict ``{site: array}`` on that simulated data.
    ``fit(gen, logp, dim) -> (L, dim)`` returns approximately independent
    UNCONSTRAINED posterior draws for the rebuilt model's per-θ ``logp``
    (ranks are per unconstrained coordinate). Each replication draws θ*
    from ``build_split``'s prior sampler and the data from the template's
    posterior predictive at θ*, on ``device``.

    Returns ``(ranks (n_sims, dim), L)`` for :func:`sbc_uniformity` /
    :func:`sbc_summary`.
    """
    device = resolve_device(device)
    template = build_model(None)
    _, _, dim, _, prior_sample = template.build_split()
    ranks = []
    n_draws = None
    for i in range(int(n_sims)):
        gp, gs, gf = _generators(seed, i, device)
        theta = prior_sample(gp, 1)  # (1, dim) unconstrained
        sim = template.posterior_predictive(gs, theta)
        m = build_model({k: v[0] for k, v in sim.items()})
        logp, dim2, _ = m.build()
        if dim2 != dim:
            raise ValueError(
                f"rebuilt model changed dimension ({dim2} != {dim})"
            )
        draws = _numpy(fit(gf, logp, dim))
        if n_draws is None:
            n_draws = draws.shape[0]
        elif draws.shape[0] != n_draws:
            raise ValueError("fit returned varying draw counts")
        ranks.append(np.sum(draws < _numpy(theta)[0][None, :], axis=0))
    return np.stack(ranks).astype(np.int32), n_draws


def sbc_ecdf_band(ranks, n_posterior_draws, alpha=0.05, n_sim=4000,
                  seed=0):
    """Simultaneous rank-ECDF confidence band (Säilynoja, Bürkner & Vehtari
    2022 style, calibrated by Monte Carlo under the exact discrete-uniform
    null; numpy's generator of ``seed``, as the JAX package draws it).

    Returns a dict with ``levels`` (L+1,), ``expected`` the null CDF,
    ``band`` the simultaneous half-width, ``ecdf`` (Q, L+1),
    ``max_deviation`` (Q,) and ``reject`` (Q,) booleans.
    """
    ranks = np.asarray(ranks)
    n_sims, n_q = ranks.shape
    levels = int(n_posterior_draws) + 1
    ks = np.arange(levels)
    expected = (ks + 1.0) / levels
    # the null distribution of the sup-deviation, by simulation
    rng = np.random.default_rng(seed)
    sims = rng.integers(0, levels, size=(int(n_sim), n_sims))
    counts = np.apply_along_axis(
        lambda row: np.bincount(row, minlength=levels), 1, sims
    )
    null_ecdf = np.cumsum(counts, axis=1) / n_sims
    sup = np.max(np.abs(null_ecdf - expected[None, :]), axis=1)
    band = float(np.quantile(sup, 1.0 - alpha))
    ecdf = np.empty((n_q, levels))
    for q in range(n_q):
        c = np.bincount(ranks[:, q], minlength=levels)
        ecdf[q] = np.cumsum(c) / n_sims
    dev = np.max(np.abs(ecdf - expected[None, :]), axis=1)
    return {
        "levels": ks,
        "expected": expected,
        "band": band,
        "ecdf": ecdf,
        "max_deviation": dev,
        "reject": dev > band,
    }


def sbc_summary(ranks, n_posterior_draws, names=None):
    """Human-readable calibration report: per-quantity χ², p-value, and a
    shape diagnosis (uniform / overconfident / diffuse / biased)."""
    ranks = np.asarray(ranks)
    stats, p = sbc_uniformity(ranks, n_posterior_draws)
    lines = []
    l_half = n_posterior_draws / 2.0
    for q in range(ranks.shape[1]):
        name = names[q] if names is not None else f"q{q}"
        r = ranks[:, q]
        lo, hi = np.quantile(r, [0.25, 0.75])
        spread = (hi - lo) / n_posterior_draws  # uniform → 0.5
        shift = (np.mean(r) - l_half) / n_posterior_draws
        if p[q] >= 0.05:
            shape = "uniform (calibrated)"
        elif abs(shift) > 0.1:
            shape = ("biased high (posterior underestimates)"
                     if shift > 0 else
                     "biased low (posterior overestimates)")
        elif spread > 0.55:
            shape = "∪-shaped (overconfident / too narrow)"
        else:
            shape = "∩-shaped (diffuse / too wide)"
        lines.append(
            f"{name}: chi2={stats[q]:.1f} p={p[q]:.3f} — {shape}"
        )
    return "\n".join(lines)
