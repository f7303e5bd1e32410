"""Effective sample size — derived metric the reference lacks but the
benchmark tracks (BASELINE.md: ESS/s alongside walker-updates/s).

ESS = S·W / τ per parameter, using the windowed-Sokal τ from
:mod:`mcmcpp_tpu_torch.analysis.autocorr`.
"""

import numpy as np

from mcmcpp_tpu_torch.analysis.autocorr import autocorr_time


def effective_sample_size(samples, window_scaling=4.0, **kw):
    """ESS per parameter for (S, W, P) (or scalar for (S, W)) samples.

    Unconverged τ estimates (returned negative by ``autocorr_time``) yield
    NaN so they can't silently inflate ESS.
    """
    arr = np.asarray(samples)
    tau = autocorr_time(arr, window_scaling=window_scaling, **kw)
    n_total = arr.shape[0] * arr.shape[1]
    tau = np.asarray(tau, np.float64)
    ess = np.where(tau > 0, n_total / np.maximum(tau, 1e-12), np.nan)
    return float(ess) if ess.ndim == 0 else ess


def batch_means_ess(samples, n_batches=32):
    """O(1)-memory ESS via the batch-means variance-ratio estimator.

    For chains too long to FFT in one window (SURVEY.md §7 hard part (c)):
    split each walker's series into ``n_batches`` consecutive batches; with
    batch size b, ESS ≈ N·Var[x]/(b·Var[batch means]). Consistent as both
    b and n_batches grow; needs only streaming batch sums, so it works on
    chains read chunk-by-chunk from disk.

    samples: (S, W) or (S, W, P). Returns float or (P,).
    """
    arr = np.asarray(samples, np.float64)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    s, w, p = arr.shape
    b = s // int(n_batches)
    if b < 2:
        raise ValueError("chain too short for the requested n_batches")
    trimmed = arr[: b * n_batches]
    # (n_batches, b, W, P) -> batch means (n_batches, W, P)
    means = trimmed.reshape(n_batches, b, w, p).mean(axis=1)
    var_means = means.var(axis=0, ddof=1).mean(axis=0)  # avg over walkers
    var_x = trimmed.reshape(-1, w, p).var(axis=(0, 1), ddof=1)
    n_total = b * n_batches * w
    # per-walker ESS = s·Var[x]/(b·Var[batch means]); total sums over walkers
    with np.errstate(divide="ignore", invalid="ignore"):
        ess = n_total * var_x / (b * var_means)
    ess = np.minimum(ess, float(n_total))
    return float(ess[0]) if squeeze else ess


def multivariate_ess(samples, n_batches=32):
    """Multivariate ESS (Vats, Flegal & Jones 2019, Biometrika):

        mESS = n · (det Λ / det Σ)^{1/p}

    with Λ the stationary covariance of the draws and Σ the asymptotic
    (Monte-Carlo) covariance of the mean, estimated by multivariate batch
    means. One number for the whole parameter vector — unlike min-over-
    coordinates ESS it accounts for cross-parameter correlation in the
    estimator error, which is what volume-of-confidence-region stopping
    rules (see :func:`min_ess_required`) actually need.

    samples: (S, W, P); each walker is treated as an independent chain
    (per-walker batch means and per-walker centering, averaged), matching
    the whole-ensemble convention of the reference's analysis layer
    (``MCMCpp/Analysis/AutoCorrCalc.h:151-221``). Returns a
    float. NaN if either covariance estimate is singular beyond repair
    (chain far too short for p).
    """
    arr = np.asarray(samples, np.float64)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    s, w, p = arr.shape
    b = s // int(n_batches)
    if b < 2:
        raise ValueError("chain too short for the requested n_batches")
    trimmed = arr[: b * n_batches]  # (nb*b, W, P)
    centered = trimmed - trimmed.mean(axis=0, keepdims=True)
    # Λ: per-walker draw covariance, averaged over walkers
    lam = np.einsum("swi,swj->ij", centered, centered) / (
        w * (b * n_batches - 1.0)
    )
    # Σ: multivariate batch means, per walker, averaged
    means = trimmed.reshape(n_batches, b, w, p).mean(axis=1)  # (nb, W, P)
    mc = means - means.mean(axis=0, keepdims=True)
    sig = b * np.einsum("kwi,kwj->ij", mc, mc) / (w * (n_batches - 1.0))
    sign_l, logdet_l = np.linalg.slogdet(lam)
    sign_s, logdet_s = np.linalg.slogdet(sig)
    if sign_l <= 0 or sign_s <= 0:
        return float("nan")
    n_total = float(b * n_batches * w)
    return float(n_total * np.exp((logdet_l - logdet_s) / p))


def min_ess_required(p, alpha=0.05, eps=0.05):
    """Minimum multivariate ESS for the relative fixed-volume sequential
    stopping rule (Vats, Flegal & Jones 2019, eq. 8):

        minESS = 2^{2/p} π / (p Γ(p/2))^{2/p} · χ²_{1-α, p} / ε²

    i.e. the mESS at which the 100(1-α)% confidence region for the
    p-dimensional posterior mean has volume ε^p relative to the posterior
    spread. p=1, α=.05, ε=.05 gives the familiar ≈6146.
    """
    from scipy import stats as _stats
    from scipy.special import gammaln

    p = int(p)
    log_c = ((2.0 / p) * np.log(2.0) + np.log(np.pi)
             - (2.0 / p) * (np.log(p) + gammaln(p / 2.0)))
    chi2 = _stats.chi2.ppf(1.0 - alpha, df=p)
    return float(np.exp(log_c) * chi2 / eps**2)


def _rank_normalize_3d(arr):
    """(S, W, P) -> normal scores per parameter (Vehtari et al. 2021 §3)."""
    from scipy import stats as _stats

    out = np.empty_like(arr, np.float64)
    s, w, p = arr.shape
    for i in range(p):
        r = _stats.rankdata(arr[:, :, i], axis=None).reshape(s, w)
        out[:, :, i] = _stats.norm.ppf((r - 0.375) / (s * w + 0.25))
    return out


def ess_bulk(samples, **kw):
    """Rank-normalized bulk ESS (Vehtari et al. 2021): ESS of the normal
    scores — robust to heavy tails and measures mixing in the bulk.

    samples: (S, W, P) or (S, W). Returns (P,) or float.
    """
    arr = np.asarray(samples, np.float64)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    ess = effective_sample_size(_rank_normalize_3d(arr), **kw)
    return float(ess[0]) if squeeze else ess


def ess_tail(samples, prob=0.05, **kw):
    """Tail ESS: min over the ``prob`` and ``1-prob`` quantile indicator
    ESS (Vehtari et al. 2021 §4.3) — mixing quality where credible-interval
    endpoints are estimated.

    samples: (S, W, P) or (S, W). Returns (P,) or float.
    """
    arr = np.asarray(samples, np.float64)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    out = []
    for q in (prob, 1.0 - prob):
        cut = np.quantile(arr.reshape(-1, arr.shape[2]), q, axis=0)
        ind = (arr <= cut[None, None, :]).astype(np.float64)
        out.append(np.atleast_1d(effective_sample_size(ind, **kw)))
    ess = np.minimum(*out)
    return float(ess[0]) if squeeze else ess
