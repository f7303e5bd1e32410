"""R*: classifier-based MCMC convergence diagnostic.

Lambert & Vehtari (2022, Bayesian Analysis): train a classifier to
predict WHICH CHAIN a posterior draw came from. If the chains have
mixed, draws carry no chain information and held-out classification
accuracy falls to 1/C; if any chain occupies its own region, the
classifier finds it. R* = C · accuracy, so R* ≈ 1 indicates convergence
and R* > 1 flags trouble. Unlike R̂ (which compares first/second
moments per coordinate) R* is multivariate and moment-free — it catches
chains that agree marginally but differ jointly.

Needs scikit-learn, imported when ``rstar`` runs (after its argument
checks), so the package imports without it; where it is missing, as on
a machine set up for the GPU alone, ``rstar`` raises ``ImportError``. The
classifier is a gradient-boosted tree ensemble as in the paper. A copy of
``mcmcpp_tpu/analysis/rstar.py``.

No reference counterpart (the C++ library stops at ACT/covariance);
north-star scope. Complements :func:`~mcmcpp_tpu_torch.analysis.nested_rhat`
(many-short-chains) and rank-normalized split-R̂.
"""

import numpy as np


def rstar(samples, seed=0, test_frac=0.3, n_splits=1, max_iter=100,
          n_threads=None):
    """R* for a (S, C, P) (or (S, C)) chain array.

    test_frac : held-out fraction scored per split.
    n_splits : refit/rescore repetitions (different splits); the MEAN
        R* is returned — pass >1 for a stabler estimate on small S·C.
    max_iter : boosting rounds of the HistGradientBoostingClassifier.
    n_threads : cap sklearn's OpenMP threads (via threadpoolctl) for
        this call. Set it (e.g. 1) when running under a process pool —
        two concurrent uncapped fits on a small box measured a 70x
        slowdown from thread thrash (4.9 s -> 358 s under pytest-xdist).

    Guidance from the paper: R* ≲ 1.03 alongside R̂ < 1.01; values
    well above 1 mean some chain is distinguishable from the rest.
    """
    arr = np.asarray(samples, np.float64)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("expected (steps, chains[, params])")
    s, c, p = arr.shape
    if c < 2:
        raise ValueError("need at least 2 chains")
    if not 0.0 < float(test_frac) < 1.0:
        raise ValueError("test_frac must be in (0, 1)")
    # sklearn import AFTER validation: cheap-to-raise paths never load
    # the OpenMP runtime (see the in-suite isolation note in the tests)
    try:
        from sklearn.ensemble import HistGradientBoostingClassifier
        from sklearn.model_selection import train_test_split
    except ImportError as e:
        raise ImportError(
            "rstar needs scikit-learn, which is not installed"
        ) from e

    x = arr.transpose(1, 0, 2).reshape(c * s, p)
    y = np.repeat(np.arange(c), s)
    import contextlib

    if n_threads is not None:
        try:
            from threadpoolctl import threadpool_limits
        except ImportError as e:
            raise ImportError(
                "rstar(n_threads=...) needs threadpoolctl (ships with "
                "scikit-learn); pass n_threads=None to skip the cap"
            ) from e

        limiter = threadpool_limits(limits=int(n_threads))
    else:
        limiter = contextlib.nullcontext()
    accs = []
    with limiter:
        for split in range(int(n_splits)):
            x_tr, x_te, y_tr, y_te = train_test_split(
                x, y, test_size=float(test_frac), stratify=y,
                random_state=int(seed) + split,
            )
            clf = HistGradientBoostingClassifier(
                max_iter=int(max_iter), random_state=int(seed) + split,
            )
            clf.fit(x_tr, y_tr)
            accs.append(clf.score(x_te, y_te))
    return float(c * np.mean(accs))
