"""ArviZ-interoperable export of sampled chains.

The wider PyMC/Stan/emcee ecosystem converges on ArviZ ``InferenceData``
for posterior storage/plotting. This module shapes the ensemble sampler's
chain into the exact dict convention ``arviz.from_dict`` consumes —
``(chain, draw, *shape)`` arrays — optionally resolving named/constrained
parameters through a ``constrain`` callable. ArviZ itself is NOT required
(not installed in minimal environments): ``to_inference_dict`` returns plain
numpy; ``to_arviz`` performs the gated import. Counterpart of
``mcmcpp_tpu/export.py``; the nested/IBIS/SMC² exporters come with their
engines.

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
