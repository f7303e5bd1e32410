"""Shared truncated-importance-sampling primitives.

One copy of the estimator family used by :func:`model_compare.loo`
(PSIS-style leave-one-out) and :mod:`power_scaling` (prior/likelihood
power perturbation): sqrt(N)-truncated IS weights (Ionides 2008) and
the Hill tail-index reliability diagnostic (the k̂ > 0.7 rule of
Vehtari et al. 2017). Keeping them here means a fix to the truncation
rule or the tail fraction propagates to every consumer.

A copy of ``mcmcpp_tpu/analysis/importance.py`` (numpy alone).
"""

import numpy as np


def hill_khat(lw, frac=0.2):
    """Hill tail-index of RAW log-weights.

    lw: (n,) or (n, k) — the estimate is per column for 2-D input.
    ``frac`` of the largest weights (floored at 5) form the tail.
    """
    lw = np.asarray(lw, np.float64)
    n = lw.shape[0]
    m = max(int(frac * n), 5)
    top = np.sort(lw, axis=0)[-m:]
    if lw.ndim == 1:
        return float((top[1:] - top[0]).mean())
    return (top[1:] - top[0:1]).mean(axis=0)


def truncated_weights(lw):
    """sqrt(N)-truncated IS weights from RAW log-weights (same shape).

    Returns UNNORMALIZED weights after a per-column max shift and the
    ``mean(w)·sqrt(n)`` cap — ratio estimators can use them directly
    (the shift cancels); normalize for weighted moments.
    """
    lw = np.asarray(lw, np.float64)
    lw = lw - lw.max(axis=0, keepdims=lw.ndim > 1)
    w = np.exp(lw)
    cap = w.mean(axis=0) * np.sqrt(lw.shape[0])
    return np.minimum(w, cap)
