"""Convergence diagnostics: split-R̂, Monte-Carlo standard error, summaries.

Beyond the reference's analysis layer (which stops at ACT/covariance/
histograms — SURVEY.md §2 #19-23): rank-normalized split-R̂ and bulk/tail
ESS in the Vehtari et al. (2021) style, plus MCSE. Walkers/chains map onto
the "chains" axis.
"""

import numpy as np
import torch
from scipy import stats as _stats

from mcmcpp_tpu_torch.analysis.ess import (
    effective_sample_size,
    rank_normalize_tensor,
)


def _split_chains(samples):
    """(S, C) -> (S//2, 2C): split each chain in half (split-R̂)."""
    s = samples.shape[0] - samples.shape[0] % 2
    half = s // 2
    return np.concatenate([samples[:half], samples[half:s]], axis=1)


def _rank_normalize(x):
    """Map values to normal scores via average ranks (Vehtari et al. 2021)."""
    r = _stats.rankdata(x, axis=None).reshape(x.shape)
    return _stats.norm.ppf((r - 0.375) / (x.size + 0.25))


def potential_scale_reduction(samples, rank_normalized=True):
    """Split-R̂ per parameter.

    samples: (S, C, P) — S steps, C chains/walkers, P parameters; numpy or
    a tensor (reduced on its device in float64).
    Values near 1 (≲1.01) indicate convergence.

    numpy input runs the JAX package's numpy arithmetic, so that
    ``run_until_converged``'s decisions match its bit for bit (torch's
    reductions and ``ndtri`` differ from numpy's and scipy's by an ulp); a
    tensor never leaves its device.
    """
    if isinstance(samples, torch.Tensor):
        return _rhat_tensor(samples, rank_normalized)
    arr = np.asarray(samples, np.float64)
    if arr.ndim != 3:
        raise ValueError("expected (steps, chains, params)")
    out = np.empty(arr.shape[-1])
    for p in range(arr.shape[-1]):
        x = _split_chains(arr[:, :, p])
        if rank_normalized:
            x = _rank_normalize(x)
        s, c = x.shape
        chain_means = x.mean(axis=0)
        b = s * chain_means.var(ddof=1)
        w = x.var(axis=0, ddof=1).mean()
        var_plus = (s - 1) / s * w + b / s
        out[p] = np.sqrt(var_plus / w) if w > 0 else np.inf
    return out


def _rhat_tensor(x, rank_normalized):
    """:func:`potential_scale_reduction` on a tensor's device."""
    if x.ndim != 3:
        raise ValueError("expected (steps, chains, params)")
    x = x.to(torch.float64)
    s_even = x.shape[0] - x.shape[0] % 2
    half = s_even // 2
    x = torch.cat([x[:half], x[half:s_even]], dim=1)  # split chains
    if rank_normalized:
        x = rank_normalize_tensor(x)
    s = x.shape[0]
    b = s * x.mean(dim=0).var(dim=0, correction=1)
    w = x.var(dim=0, correction=1).mean(dim=0)
    var_plus = (s - 1) / s * w + b / s
    return torch.where(w > 0, torch.sqrt(var_plus / w),
                       torch.inf).cpu().numpy()


def mcse_mean(samples, ess=None, **ess_kw):
    """Monte-Carlo standard error of the posterior mean per parameter.

    samples: (S, C, P). MCSE = posterior sd / sqrt(ESS). Pass a
    precomputed ``ess`` to skip re-running the ACT analysis; ``ess_kw``
    goes to :func:`effective_sample_size` (whose ``device``, default
    "cuda", takes the ACT's FFT).
    """
    arr = np.asarray(samples, np.float64)
    flat = arr.reshape(-1, arr.shape[-1])
    sd = flat.std(axis=0, ddof=1)
    if ess is None:
        ess = effective_sample_size(arr, **ess_kw)
    ess = np.asarray(ess, np.float64)
    return sd / np.sqrt(np.maximum(ess, 1.0))


def mcse_quantile(samples, prob, device=None):
    """Monte-Carlo standard error of a posterior quantile per parameter
    (Vehtari et al. 2021 §4.3 / the `posterior` package's estimator).

    The quantile's sampling error is driven by the ESS of the INDICATOR
    series I(x <= Q_prob) — autocorrelation-aware where the naive
    sqrt(q(1-q)/N)/f(Q) plug-in is iid-only. The MCSE is read off the
    order-statistic Beta interval: with S_eff the indicator ESS,
    the central 68.27% interval of Beta(q S_eff + 1, (1-q) S_eff + 1)
    mapped through the empirical quantile function gives
    mcse = (Q_upper - Q_lower) / 2.

    samples: (S, C, P) (or (S, C)). Returns (P,) (or a float). The
    indicator ESS's FFT runs on ``device`` (default "cuda"); the rest is
    numpy, as in the JAX package.
    """
    arr = np.asarray(samples, np.float64)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("expected (steps, chains[, params])")
    q = float(prob)
    if not 0.0 < q < 1.0:
        raise ValueError("prob must be in (0, 1)")
    p_dim = arr.shape[-1]
    out = np.empty(p_dim)
    for j in range(p_dim):
        x = arr[:, :, j]
        flat = x.reshape(-1)
        q_val = np.quantile(flat, q)
        ind = (x <= q_val).astype(np.float64)
        # indicator ESS; a constant indicator (quantile at the support
        # edge) has no sampling error at this resolution
        if ind.std() == 0:
            out[j] = 0.0
            continue
        s_eff = float(np.asarray(effective_sample_size(ind[:, :, None],
                                                      device=device))[0])
        if not np.isfinite(s_eff):
            # per-chain-constant indicator (chains stuck in separate
            # modes) or an unclosed ACT window: the error is not
            # estimable — degrade to NaN like mcse_mean, never raise
            out[j] = np.nan
            continue
        s_eff = max(s_eff, 4.0)
        a = _stats.beta.ppf(0.15865, q * s_eff + 1, (1 - q) * s_eff + 1)
        b = _stats.beta.ppf(0.84135, q * s_eff + 1, (1 - q) * s_eff + 1)
        lo, hi = np.quantile(flat, [a, b])
        out[j] = (hi - lo) / 2.0
    return float(out[0]) if squeeze else out


def summary(samples, prob=0.9, device=None):
    """Per-parameter posterior summary dict.

    samples: (S, C, P). Returns dict of arrays: mean, sd, median, central
    credible interval bounds, HDI bounds (shortest interval at the same
    prob), ess (+ rank-normalized ess_bulk and ess_tail, Vehtari et al.
    2021), rhat, mcse. The ESS columns run on ``device`` (default "cuda");
    the rest is numpy, as in the JAX package.
    """
    from mcmcpp_tpu_torch.analysis.ess import ess_bulk, ess_tail

    arr = np.asarray(samples, np.float64)
    flat = arr.reshape(-1, arr.shape[-1])
    lo_q, hi_q = (1 - prob) / 2, 1 - (1 - prob) / 2
    ess = np.asarray(effective_sample_size(arr, device=device))
    return {
        "mean": flat.mean(axis=0),
        "sd": flat.std(axis=0, ddof=1),
        "median": np.median(flat, axis=0),
        f"q{round(lo_q * 100, 6):g}": np.quantile(flat, lo_q, axis=0),
        f"q{round(hi_q * 100, 6):g}": np.quantile(flat, hi_q, axis=0),
        "hdi_lo": hdi(flat, prob=prob)[0],
        "hdi_hi": hdi(flat, prob=prob)[1],
        "ess": ess,
        "ess_bulk": np.atleast_1d(ess_bulk(arr, device=device)),
        "ess_tail": np.atleast_1d(ess_tail(arr, device=device)),
        "rhat": potential_scale_reduction(arr),
        "mcse": mcse_mean(arr, ess=ess),
    }


def hdi(samples, prob=0.94):
    """Highest-density interval per parameter (shortest interval holding
    ``prob`` posterior mass — narrower than the central interval for
    skewed marginals; equal for symmetric ones).

    samples: (S, P), (S, W, P) chain layout, or (N,) draws. Returns
    (lo, hi) arrays of shape (P,) (scalars for 1-D input).
    """
    x = np.asarray(samples, np.float64)
    scalar = x.ndim == 1
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    keep = max(1, int(np.floor(prob * n)))
    if keep >= n:
        raise ValueError(f"prob={prob} needs more than {n} draws")
    xs = np.sort(x, axis=0)
    widths = xs[keep:] - xs[: n - keep]  # candidate interval widths
    start = np.argmin(widths, axis=0)
    cols = np.arange(x.shape[1])
    lo, hi = xs[start, cols], xs[start + keep, cols]
    return (float(lo[0]), float(hi[0])) if scalar else (lo, hi)


def ppc_pvalue(stat_fn, observed, replicated):
    """Posterior-predictive p-value: P(T(y_rep) >= T(y_obs)).

    stat_fn: dataset -> scalar test quantity; ``replicated``: (N, *shape)
    simulated datasets from :meth:`~mcmcpp_tpu_torch.dsl.Model
    .posterior_predictive`. Values near 0 or 1 flag the aspect of the
    data the model cannot reproduce (Gelman et al., BDA3 ch. 6).
    """
    t_obs = float(stat_fn(np.asarray(observed)))
    t_rep = np.asarray([float(stat_fn(r)) for r in np.asarray(replicated)])
    return float(np.mean(t_rep >= t_obs))


def nested_rhat(samples, n_superchains):
    """Nested R̂ for the many-short-chains regime (Margossian, Hoffman,
    Sountsov, Riou-Durand, Vehtari & Gelman 2023, Bayesian Analysis).

    Classic split-R̂ needs each chain long enough to estimate its own
    variance — useless in THIS framework's natural regime (thousands of
    device-parallel walkers, few steps each). Nested R̂ groups the C chains
    into K superchains of M = C/K chains and compares the
    between-SUPERCHAIN variance to the total within-superchain variance
    (between-chain + within-chain), which is well defined even at ONE
    draw per chain:

        nR̂ = sqrt(1 + B / W),
        B   = (1/K) Σ_k (x̄_k − x̄)²,
        W   = (1/K) Σ_k [ (1/M) Σ_m s²_km  +  (1/M) Σ_m (x̄_km − x̄_k)² ]

    VALIDITY REQUIREMENT (the paper's §2.2): chains within a superchain
    must be initialized from a common point (or a common draw), with
    overdispersion only ACROSS superchains — then nR̂ → 1 iff the chains
    forget their initializations. Group assignment here is contiguous:
    chains [0, M) form superchain 0, etc. — lay your initializations out
    accordingly.

    samples: (S, C, P) (or (S, C)); returns (P,) (or a float).
    Threshold guidance from the paper: nR̂ < 1.01 is the analogue of the
    usual split-R̂ gate.
    """
    arr = np.asarray(samples, np.float64)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("expected (steps, chains[, params])")
    s, c, p = arr.shape
    k = int(n_superchains)
    if k < 2:
        raise ValueError("need at least 2 superchains")
    if c % k != 0:
        raise ValueError(f"{c} chains not divisible by {k} superchains")
    out = nested_rhat_from_stats(
        arr.mean(axis=0), arr.var(axis=0), k
    )
    return float(out[0]) if squeeze else out


def nested_rhat_from_stats(chain_mean, chain_var, n_superchains):
    """Nested R̂ from per-chain sufficient statistics.

    chain_mean / chain_var: (C, P) per-chain draw means and (1/N)
    variances. This is the multihost building block: each host computes
    its shard's (C_local, P) stats, a tiny allgather concatenates them,
    and every host evaluates the identical global nR̂ — the full draws
    never leave their shards (same pattern as analysis.global_stats).
    """
    chain_mean = np.asarray(chain_mean, np.float64)
    chain_var = np.asarray(chain_var, np.float64)
    if chain_mean.ndim != 2 or chain_var.shape != chain_mean.shape:
        raise ValueError("chain_mean/chain_var must both be (C, P)")
    c, p = chain_mean.shape
    k = int(n_superchains)
    if k < 2:
        raise ValueError("need at least 2 superchains")
    if c % k != 0:
        raise ValueError(f"{c} chains not divisible by {k} superchains")
    m = c // k
    cm = chain_mean.reshape(k, m, p)
    cv = chain_var.reshape(k, m, p)
    super_mean = cm.mean(axis=1)                       # (K, P)
    grand = super_mean.mean(axis=0)                    # (P,)
    b = np.square(super_mean - grand[None, :]).mean(axis=0)
    w = cv.mean(axis=(0, 1)) + np.square(
        cm - super_mean[:, None, :]
    ).mean(axis=(0, 1))
    return np.sqrt(1.0 + np.divide(
        b, w, out=np.full(p, np.inf), where=w > 0
    ))
