"""Power-scaling sensitivity analysis (priorsense-style).

Kallioinen, Paananen, Bürkner & Vehtari (2023, Stat. Comput.): perturb
the posterior by raising the prior or the likelihood to a power α,

    π_α(θ) ∝ p(θ)^α · p(y | θ)      (prior scaling)
    π_α(θ) ∝ p(θ) · p(y | θ)^α      (likelihood scaling)

and measure how much the posterior moves. Because the perturbed
posterior differs from the base one only by the factor ``comp^(α−1)``,
NO refitting is needed — existing draws are importance-reweighted
(truncated IS with a Pareto-k̂ reliability diagnostic, same estimator
family as :func:`mcmcpp_tpu_torch.analysis.model_compare.loo`). Reading the
pair of sensitivities:

- prior-sensitive AND likelihood-sensitive → prior-data CONFLICT;
- prior-sensitive only → the prior dominates (weak likelihood);
- likelihood-sensitive only → healthy (data-driven) posterior;
- neither → likelihood so strong the prior is irrelevant.

Distance: normalized symmetric cumulative Jensen–Shannon distance
between the base and perturbed weighted ECDFs of each marginal (Nguyen
& Vreeken 2015 — the metric priorsense adopts); sensitivity is the
finite-difference derivative of that distance w.r.t. log2 α at α = 1.
The 0.05 threshold follows Kallioinen et al.'s rule of thumb.

No reference counterpart (the C++ library has no workflow layer);
north-star scope. Pairs naturally with the DSL: ``Model.build_split()``
exposes exactly the per-draw ``log_prior`` / ``log_lik`` totals this
module consumes.

A copy of ``mcmcpp_tpu/analysis/power_scaling.py`` (numpy alone).
"""

from typing import NamedTuple

import numpy as np

from mcmcpp_tpu_torch.analysis.importance import hill_khat, truncated_weights


class PowerScaleResult(NamedTuple):
    alpha: float
    mean: np.ndarray      # (P,) perturbed posterior means
    sd: np.ndarray        # (P,) perturbed posterior sds
    pareto_k: float       # IS reliability (k̂ > 0.7 → unreliable)
    distance: np.ndarray  # (P,) CJS distance from the base posterior


class SensitivityResult(NamedTuple):
    prior: np.ndarray        # (P,) prior power-scaling sensitivity
    likelihood: np.ndarray   # (P,) likelihood power-scaling sensitivity
    diagnosis: list          # (P,) strings (see module docstring)
    threshold: float


def _cjs_dist(x, w_q):
    """Normalized symmetric cumulative JS distance between the
    uniform-weight ECDF of ``x`` and the ``w_q``-weighted one."""
    order = np.argsort(x)
    xs = x[order]
    p = np.cumsum(np.full(len(x), 1.0 / len(x)))
    q = np.cumsum(w_q[order])
    q = q / q[-1]
    dx = np.diff(xs)
    if not dx.size or dx.sum() == 0:
        return 0.0
    p, q = p[:-1], q[:-1]
    eps = 1e-12

    def cjs(a, b):
        t = a * np.log2(2 * a / np.maximum(a + b, eps) + eps)
        return np.sum((t + (b - a) / (2 * np.log(2))) * dx)

    den = np.sum(0.5 * (p + q) * dx)
    if den <= 0:
        return 0.0
    return float(np.sqrt(max(cjs(p, q) + cjs(q, p), 0.0) / (2 * den)))


def powerscale(draws, log_comp, alpha):
    """Importance-reweight ``draws`` to the posterior with ``log_comp``
    (the TOTAL log prior or log likelihood per draw) raised to ``alpha``.

    draws: (n, P) flattened posterior draws; log_comp: (n,).
    Returns :class:`PowerScaleResult`.
    """
    draws = np.asarray(draws, np.float64)
    if draws.ndim == 1:
        draws = draws[:, None]
    log_comp = np.asarray(log_comp, np.float64)
    if log_comp.shape != (draws.shape[0],):
        raise ValueError("log_comp must be (n_draws,)")
    lw = (float(alpha) - 1.0) * log_comp
    khat = float(hill_khat(lw))
    w = truncated_weights(lw)
    w = w / w.sum()
    mean = w @ draws
    sd = np.sqrt(np.maximum(w @ (draws - mean[None, :]) ** 2, 0.0))
    dist = np.array([
        _cjs_dist(draws[:, j], w) for j in range(draws.shape[1])
    ])
    return PowerScaleResult(float(alpha), mean, sd, khat, dist)


def powerscale_sensitivity(draws, log_prior, log_lik, alpha=1.01,
                           threshold=0.05):
    """Two-sided power-scaling sensitivity of every marginal.

    draws: (n, P); log_prior / log_lik: (n,) totals at each draw.
    Sensitivity = (D(α) + D(1/α)) / (2·log2 α) — the finite-difference
    derivative of the CJS distance at α = 1. Returns
    :class:`SensitivityResult` with a per-parameter diagnosis.
    """
    a = float(alpha)
    if a <= 1.0:
        raise ValueError("alpha must be > 1 (both directions are used)")
    h = 2.0 * np.log2(a)
    sens = {}
    for name, comp in (("prior", log_prior), ("likelihood", log_lik)):
        d_up = powerscale(draws, comp, a).distance
        d_dn = powerscale(draws, comp, 1.0 / a).distance
        sens[name] = (d_up + d_dn) / h
    diagnosis = []
    for ps, ls in zip(sens["prior"], sens["likelihood"]):
        if ps >= threshold and ls >= threshold:
            diagnosis.append("prior-data conflict")
        elif ps >= threshold:
            diagnosis.append("strong prior / weak likelihood")
        elif ls >= threshold:
            diagnosis.append("likelihood-driven (healthy)")
        else:
            diagnosis.append("insensitive")
    return SensitivityResult(
        prior=sens["prior"], likelihood=sens["likelihood"],
        diagnosis=diagnosis, threshold=float(threshold),
    )
