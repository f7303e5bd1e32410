"""ArviZ-interoperable export of sampled chains.

The wider PyMC/Stan/emcee ecosystem converges on ArviZ ``InferenceData``
for posterior storage/plotting. This module shapes the ensemble sampler's
chain into the exact dict convention ``arviz.from_dict`` consumes —
``(chain, draw, *shape)`` arrays — optionally resolving named/constrained
parameters through a ``constrain`` callable. ArviZ itself is NOT required
(not installed in minimal environments): ``to_inference_dict`` returns plain
numpy; ``to_arviz`` performs the gated import. Counterpart of
``mcmcpp_tpu/export.py``, with the nested-sampling, IBIS and SMC²
exporters.

    idata_kw = to_inference_dict(sampler, model=model)
    # elsewhere, with arviz installed:
    az.from_dict(**idata_kw)
"""

import numpy as np


def _chain_draw(samples):
    """(S, W, ...) -> (W, S, ...): ArviZ wants (chain, draw, *shape)."""
    return np.moveaxis(np.asarray(samples), 0, 1)


def to_inference_dict(sampler, model=None, burn_in=0, thin=1,
                      posterior_predictive=None):
    """Build ``{"posterior": ..., "sample_stats": ...}`` kwargs for
    ``arviz.from_dict``.

    sampler: any sampler with ``get_samples``/``get_log_probs``. model:
    optional object with ``build() -> (logp, dim, constrain)``, or the
    ``constrain`` callable itself ((N, P) numpy rows -> dict of named
    arrays): draws are pushed through it so the posterior group carries
    NAMED constrained parameters instead of a flat ``theta``.
    posterior_predictive: optional dict of flat (N, ...) arrays, reshaped to
    (chain, draw, ...).
    """
    samples = sampler.get_samples(burn_in=burn_in, thin=thin)  # (S, W, P)
    logp = sampler.get_log_probs(burn_in=burn_in, thin=thin)  # (S, W)
    s, w, p = samples.shape
    if model is not None:
        constrain = model if not hasattr(model, "build") else model.build()[2]
        named = constrain(samples.reshape(s * w, p))
        posterior = {
            k: _chain_draw(np.asarray(v).reshape((s, w) + v.shape[1:]))
            for k, v in named.items()
        }
    else:
        posterior = {"theta": _chain_draw(samples)}
    stats = {"lp": _chain_draw(logp)}
    # a sampler that exposes per-draw sample stats (diverging / energy,
    # Stan-style) gets them merged in
    get_stats = getattr(sampler, "get_sample_stats", None)
    if get_stats is not None:
        for k, v in get_stats(burn_in=burn_in, thin=thin).items():
            if np.asarray(v).shape[:1] == (s,):
                stats[k] = _chain_draw(v)
    out = {
        "posterior": posterior,
        "sample_stats": stats,
    }
    if posterior_predictive is not None:
        out["posterior_predictive"] = {
            k: _chain_draw(np.asarray(v).reshape((s, w) + v.shape[1:]))
            for k, v in posterior_predictive.items()
        }
    return out


def to_arviz(sampler, model=None, burn_in=0, thin=1,
             posterior_predictive=None):
    """``arviz.InferenceData`` (requires arviz; actionable error if absent)."""
    try:
        import arviz as az
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "arviz is not installed; use to_inference_dict() and feed the "
            "result to arviz.from_dict(**d) where arviz is available"
        ) from e
    return az.from_dict(**to_inference_dict(
        sampler, model=model, burn_in=burn_in, thin=thin,
        posterior_predictive=posterior_predictive,
    ))


def nested_to_inference_dict(sampler_or_result, model=None, n_draws=2000,
                             seed=0):
    """``arviz.from_dict`` kwargs from a nested-sampling run: the posterior
    group holds an equal-weight categorical resample of the weighted dead
    points (one "chain" of ``n_draws``), ``sample_stats`` their
    log-likelihoods and the run's logz, logz_err and weights' ESS. model:
    optional ``build()`` object or ``constrain`` callable for named
    parameters (see :func:`to_inference_dict`)."""
    from mcmcpp_tpu_torch.nested import NestedResult, NestedSampler

    if isinstance(sampler_or_result, NestedSampler):
        res = sampler_or_result.result
        if res is None:
            raise RuntimeError("call run() first")
    elif isinstance(sampler_or_result, NestedResult):
        res = sampler_or_result
    else:
        raise TypeError("expected a NestedSampler or NestedResult")
    rng = np.random.default_rng(seed)
    w = np.exp(res.logw - res.logw.max())
    w /= w.sum()
    idx = rng.choice(w.size, size=int(n_draws), p=w)
    draws = res.samples[idx]  # (n_draws, P)
    n = draws.shape[0]
    if model is not None:
        constrain = model if not hasattr(model, "build") else model.build()[2]
        named = constrain(draws)
        posterior = {k: np.asarray(v)[None, ...] for k, v in named.items()}
    else:
        posterior = {"theta": draws[None, :, :]}
    stats = {
        "log_likelihood": res.logl[idx][None, :],
        "logz": np.full((1, n), res.logz),
        "logz_err": np.full((1, n), res.logz_err),
        "weights_ess": np.full((1, n), res.ess),
    }
    return {"posterior": posterior, "sample_stats": stats}


def _weighted_cloud_export(sampler, model, n_draws, seed, counter_name):
    """The IBIS/SMC² export: an equal-weight resampled posterior (one
    "chain" of ``n_draws``) and the evidence, prequential and resample-count
    rows of sample_stats. A prequential trace longer than ``n_draws`` is
    truncated with a warning (``sampler.log_evidence_trace`` holds it
    whole)."""
    draws = sampler.posterior(n_draws=n_draws, seed=seed)  # (n, P)
    n = draws.shape[0]
    if model is not None:
        constrain = model if not hasattr(model, "build") else model.build()[2]
        named = constrain(draws)
        posterior = {k: np.asarray(v)[None, ...] for k, v in named.items()}
    else:
        posterior = {"theta": draws[None, :, :]}
    trace = np.asarray(sampler.log_evidence_trace, np.float64)
    if trace.size > n:
        import warnings

        warnings.warn(
            f"prequential trace ({trace.size} stages) is longer than "
            f"n_draws={n}; the sample_stats row keeps only the first "
            f"{n} increments — use sampler.log_evidence_trace for the "
            "full trace", UserWarning)
    padded = np.full(n, np.nan)
    padded[: min(trace.size, n)] = trace[:n]
    stats = {
        "log_evidence": np.full((1, n), sampler.log_evidence),
        "prequential_logp": padded[None, :],
        counter_name: np.full((1, n), float(sampler.n_resamples)),
    }
    return {"posterior": posterior, "sample_stats": stats}


def ibis_to_inference_dict(sampler, model=None, n_draws=2000, seed=0):
    """``arviz.from_dict`` kwargs from an IBIS run's current state: an
    equal-weight categorical resample of the weighted particles (one
    "chain" of ``n_draws``); sample_stats the running evidence, the
    prequential per-stage increments (a padded row) and the resample
    count."""
    from mcmcpp_tpu_torch.ibis import IBISSampler

    if not isinstance(sampler, IBISSampler):
        raise TypeError("expected an IBISSampler")
    return _weighted_cloud_export(sampler, model, n_draws, seed,
                                  "n_resamples")


def smc2_to_inference_dict(sampler, model=None, n_draws=2000, seed=0):
    """``arviz.from_dict`` kwargs from an SMC² run's current state: as
    :func:`ibis_to_inference_dict` for the θ-cloud, with the rejuvenation
    count and the marginal filtered-state estimate (one row per state
    dimension)."""
    from mcmcpp_tpu_torch.smc2 import SMC2Sampler

    if not isinstance(sampler, SMC2Sampler):
        raise TypeError("expected an SMC2Sampler")
    out = _weighted_cloud_export(sampler, model, n_draws, seed,
                                 "n_rejuvenations")
    est = sampler.state_estimate()
    n = next(iter(out["sample_stats"].values())).shape[1]
    for d in range(est.shape[0]):
        out["sample_stats"][f"filtered_state_{d}"] = np.full((1, n), est[d])
    return out
