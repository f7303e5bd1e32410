"""Predictive model comparison: WAIC and importance-sampling LOO.

A copy of ``mcmcpp_tpu/analysis/model_compare.py`` (numpy and scipy alone).

Vehtari, Gelman & Gabry (2017, Stat. Comput.): expected log pointwise
predictive density (elpd) estimated from an (N_draws, n_obs) pointwise
log-likelihood matrix (``Model.pointwise_log_likelihood``), by WAIC
(lppd minus the pointwise-variance penalty) or by leave-one-out
importance sampling. The LOO weights use truncated importance sampling
(Ionides 2008: cap at mean * sqrt(N)) with a per-observation Hill
tail-index diagnostic standing in for the paper's PSIS fit — the same
convention as pathfinder.py; observations with ``pareto_k > 0.7`` have
unreliable LOO contributions.

Host-side numpy (float64 accumulation): comparison runs once per fit,
off the hot path — like the rest of the analysis layer
(≙ the reference's ``MCMCpp/Analysis/`` being host-side too; the
reference itself has no model-comparison facilities).
"""

from typing import NamedTuple

import numpy as np

from scipy.special import logsumexp


class ElpdResult(NamedTuple):
    elpd: float  # total expected log pointwise predictive density
    se: float  # standard error over observations
    p_eff: float  # effective number of parameters
    pointwise: np.ndarray  # (n_obs,) per-observation elpd contributions
    pareto_k: np.ndarray  # (n_obs,) tail diagnostic (NaN for WAIC)
    method: str  # "waic" | "loo"


def _flatten(loglik):
    """(N, ...) or {site: (N, ...)} -> (N, n_obs) float64, NaN (masked)
    columns dropped."""
    if isinstance(loglik, dict):
        mats = [np.asarray(v, np.float64).reshape(v.shape[0], -1)
                for v in loglik.values()]
        ll = np.concatenate(mats, axis=1)
    else:
        ll = np.asarray(loglik, np.float64)
        ll = ll.reshape(ll.shape[0], -1)
    keep = ~np.isnan(ll).any(axis=0)
    return ll[:, keep]


def waic(loglik):
    """WAIC from an (N_draws, n_obs) matrix (or dict of per-site
    matrices). Vehtari et al. 2017, eqs. (11)-(13)."""
    ll = _flatten(loglik)
    n, n_obs = ll.shape
    lppd = logsumexp(ll, axis=0) - np.log(n)
    p = ll.var(axis=0, ddof=1)
    pointwise = lppd - p
    return ElpdResult(
        elpd=float(pointwise.sum()),
        se=float(np.sqrt(n_obs * pointwise.var(ddof=1))),
        p_eff=float(p.sum()),
        pointwise=pointwise,
        pareto_k=np.full(n_obs, np.nan),
        method="waic",
    )


def loo(loglik, khat_frac=0.2):
    """Leave-one-out elpd by truncated importance sampling.

    Raw weights per observation i: ``w_s ∝ 1 / p(y_i | theta_s)``;
    truncated at ``mean(w) * sqrt(N)`` before normalization. ``pareto_k``
    is the Hill estimator over the top ``khat_frac`` of raw log-weights.
    """
    from mcmcpp_tpu_torch.analysis.importance import hill_khat, truncated_weights

    ll = _flatten(loglik)
    n, n_obs = ll.shape
    lw = -ll  # log raw weights
    logw = np.log(truncated_weights(lw))
    # elpd_i = log( sum_s w_s p(y_i|theta_s) / sum_s w_s )
    pointwise = logsumexp(logw + ll, axis=0) - logsumexp(logw, axis=0)
    # Hill tail index of the RAW weights (before truncation)
    khat = hill_khat(lw, khat_frac)
    p_eff = (logsumexp(ll, axis=0) - np.log(n) - pointwise).sum()
    return ElpdResult(
        elpd=float(pointwise.sum()),
        se=float(np.sqrt(n_obs * pointwise.var(ddof=1))),
        p_eff=float(p_eff),
        pointwise=pointwise,
        pareto_k=khat,
        method="loo",
    )


def _pointwise_matrix(results):
    """{name: ElpdResult} -> (names, (n_obs, K) pointwise elpd matrix)."""
    if not results:
        raise ValueError("no results to combine")
    names = list(results)
    n_obs = {k: len(v.pointwise) for k, v in results.items()}
    if len(set(n_obs.values())) != 1:
        raise ValueError(f"models score different observation sets: {n_obs}")
    lpd = np.stack([np.asarray(results[k].pointwise, np.float64)
                    for k in names], axis=1)
    return names, lpd


def stacking_weights(results):
    """Bayesian stacking of predictive distributions (Yao, Vehtari,
    Simpson & Gelman 2018, Bayesian Analysis): find simplex weights
    maximizing the combined LOO log score

        max_w  Σ_i log Σ_k w_k p_k(y_i | y_{-i}),

    with ``p_k(y_i|y_{-i}) = exp(pointwise_i)`` from each model's
    :func:`loo` (or :func:`waic`) result. Unlike (pseudo-)BMA this
    optimizes the POOLED predictive, so it degrades gracefully in the
    M-open setting — when every candidate is misspecified, weights split
    to cover the data instead of collapsing onto the least-bad model.

    results: {name: ElpdResult} over the same observations.
    Returns {name: weight} (sums to 1). The objective is concave on the
    simplex, so the SLSQP solve from the uniform start is the global
    optimum.
    """
    from scipy.optimize import minimize

    names, lpd = _pointwise_matrix(results)
    n, k = lpd.shape
    if k == 1:
        return {names[0]: 1.0}
    rowmax = lpd.max(axis=1, keepdims=True)
    p = np.exp(lpd - rowmax)  # (n, K), rows scaled to max 1

    def neg_score(w):
        mix = p @ w
        return -np.sum(np.log(np.maximum(mix, 1e-300)))

    def grad(w):
        mix = np.maximum(p @ w, 1e-300)
        return -(p / mix[:, None]).sum(axis=0)

    res = minimize(
        neg_score, np.full(k, 1.0 / k), jac=grad, method="SLSQP",
        bounds=[(0.0, 1.0)] * k,
        constraints=[{"type": "eq", "fun": lambda w: w.sum() - 1.0,
                      "jac": lambda w: np.ones_like(w)}],
        options={"maxiter": 500, "ftol": 1e-12},
    )
    if not res.success:
        import warnings

        warnings.warn(
            f"stacking solve did not converge ({res.message}); returning "
            "the best iterate — treat the weights as approximate",
            stacklevel=2,
        )
    w = np.clip(res.x, 0.0, None)
    w /= w.sum()
    return dict(zip(names, w.tolist()))


def pseudo_bma_weights(results, bootstrap=True, n_boot=1000, seed=0):
    """Pseudo-BMA weights ``w_k ∝ exp(elpd_k)`` (Yao et al. 2018 §3.2).

    ``bootstrap=True`` (pseudo-BMA+, the paper's recommendation): the
    elpd's sampling uncertainty is propagated by the Bayesian bootstrap —
    Dirichlet(1,…,1) reweightings of the pointwise contributions, weights
    averaged over replicates — so a model ahead by less than its standard
    error no longer takes effectively all the mass.

    Returns {name: weight} (sums to 1).
    """
    names, lpd = _pointwise_matrix(results)
    n, k = lpd.shape
    if not bootstrap:
        e = lpd.sum(axis=0)
        w = np.exp(e - e.max())
        return dict(zip(names, (w / w.sum()).tolist()))
    rng = np.random.default_rng(seed)
    alpha = rng.dirichlet(np.ones(n), size=int(n_boot))  # (B, n)
    elpd_b = n * (alpha @ lpd)  # (B, K) bootstrap elpd replicates
    wb = np.exp(elpd_b - elpd_b.max(axis=1, keepdims=True))
    wb /= wb.sum(axis=1, keepdims=True)
    w = wb.mean(axis=0)
    return dict(zip(names, (w / w.sum()).tolist()))


def stacked_predictive_resample(draws_by_model, weights, n_draws=None,
                                seed=0):
    """Draw from the stacked posterior-predictive mixture: each returned
    row comes from model k with probability ``weights[k]``.

    draws_by_model : {name: (N_k, ...) array} — posterior(-predictive)
        draws per model (trailing shapes must agree).
    weights : {name: w} from :func:`stacking_weights` /
        :func:`pseudo_bma_weights` (keys must match).
    Returns an (n_draws, ...) array (default: the smallest N_k).
    """
    if set(draws_by_model) != set(weights):
        raise ValueError(
            f"model keys differ: draws {sorted(draws_by_model)} vs "
            f"weights {sorted(weights)}"
        )
    names = list(draws_by_model)
    arrs = [np.asarray(draws_by_model[k]) for k in names]
    tails = {a.shape[1:] for a in arrs}
    if len(tails) != 1:
        raise ValueError(f"draw shapes beyond axis 0 differ: {tails}")
    w = np.asarray([weights[k] for k in names], np.float64)
    if np.any(w < 0) or not np.isclose(w.sum(), 1.0, atol=1e-6):
        raise ValueError("weights must be a (near-)normalized simplex")
    w = w / w.sum()
    n = (min(a.shape[0] for a in arrs) if n_draws is None
         else int(n_draws))
    rng = np.random.default_rng(seed)
    which = rng.choice(len(names), size=n, p=w)
    out = np.empty((n,) + arrs[0].shape[1:], arrs[0].dtype)
    for k, a in enumerate(arrs):
        rows = np.flatnonzero(which == k)
        if rows.size:
            out[rows] = a[rng.integers(0, a.shape[0], rows.size)]
    return out


def compare(results):
    """Rank fitted models by elpd. ``results``: {name: ElpdResult} (same
    observations in the same order). Returns rows
    ``(name, elpd, se, d_elpd, d_se)`` best-first, where ``d_elpd`` is
    the difference to the best model and ``d_se`` its paired standard
    error over pointwise contributions (Vehtari et al. 2017, §5.2)."""
    if not results:
        raise ValueError("no results to compare")
    n_obs = {k: len(v.pointwise) for k, v in results.items()}
    if len(set(n_obs.values())) != 1:
        raise ValueError(f"models score different observation sets: {n_obs}")
    ranked = sorted(results.items(), key=lambda kv: -kv[1].elpd)
    best = ranked[0][1]
    rows = []
    for name, r in ranked:
        d = r.pointwise - best.pointwise
        d_se = float(np.sqrt(len(d) * d.var(ddof=1))) if r is not best else 0.0
        rows.append((name, r.elpd, r.se, r.elpd - best.elpd, d_se))
    return rows
