"""Convergence-driven sampling: run until the chain is provably long enough.

The reference leaves "how long to run" entirely to the user (fixed
``runMCMC(numSteps)``, ``test/sequential/AcTime/src/main.cpp:76-86`` checks
ACT by eye afterwards). This helper automates the standard emcee-lineage
recipe: sample in chunks, re-estimate the integrated autocorrelation time
(ACT) after each chunk, and stop once

  1. every parameter's Sokal window closed (all tau > 0),
  2. the stored chain exceeds ``act_multiplier x max(tau)`` steps, and
  3. the tau estimate has stabilized (relative change < ``tau_rtol``
     between consecutive checks),

optionally also requiring split-R-hat below ``rhat_threshold`` and/or the
Vats-Flegal-Jones multivariate-ESS stopping rule (``mess_rule``: stop only
once ``multivariate_ess >= min_ess_required(P, alpha, eps)`` — the
fixed-volume confidence-region criterion). Works with any sampler that
has ``run_mcmc`` (or ``run``) and ``get_samples``. Counterpart of
``mcmcpp_tpu/convergence.py``.
"""

from typing import NamedTuple

import numpy as np
import torch


class ConvergenceReport(NamedTuple):
    converged: bool
    steps_run: int  # raw MCMC steps advanced by this call
    stored_steps: int  # rows in the chain when we stopped
    tau: np.ndarray  # last ACT estimate (stored-step units, per param)
    rhat: np.ndarray  # last split-R-hat (per param); NaN if not computed
    checks: int  # number of ACT evaluations performed
    reason: str
    mess: float = float("nan")  # last multivariate ESS (if mess_rule set)
    nested: np.ndarray = None  # last nested R-hat (if nested_superchains)


def run_until_converged(
    sampler,
    max_steps,
    check_every=1000,
    act_multiplier=50.0,
    tau_rtol=0.05,
    rhat_threshold=None,
    mess_rule=None,
    nested_superchains=None,
    nested_rhat_threshold=1.01,
    thin=1,
    window_scaling=4.0,
    callback=None,
    multihost=None,
):
    """Drive ``sampler`` until its chain passes the ACT length criterion.

    ``max_steps`` bounds the raw steps this call may run. ``check_every``
    raw steps are run between ACT checks. ``callback(report)`` (optional)
    observes each intermediate check. Returns a :class:`ConvergenceReport`;
    ``converged=False`` means the budget (or the chain byte cap) was hit
    first — the criterion, not an exception, reports the outcome.

    ``nested_superchains=K`` additionally gates on nested R̂ (Margossian
    et al. 2023, :func:`analysis.nested_rhat`) with the walkers grouped
    into K contiguous superchains — the criterion of choice in the
    many-short-chains regime where per-walker series are too short for
    τ/split-R̂. Lay the initializations out superchain-contiguously
    (common init within a superchain, overdispersed across) for the
    diagnostic to be meaningful.

    The ACT is computed on the sampler's ``device`` (a sampler without one:
    "cuda"); R-hat, the multivariate ESS and nested R-hat are host numpy, as
    in the JAX package.

    Under a multi-process run (``multihost=None`` means a
    ``torch.distributed`` world size above 1, as the JAX package asks
    ``jax.process_count() > 1``) every statistic gates on the WHOLE
    ensemble, not this rank's walker shard: τ, R̂ and the mESS come from the
    collective ``analysis.global_*`` decompositions, nested R̂ from the
    ranks' gathered per-walker moments in global walker order, and every
    rank takes the same decision. Every rank must call this collectively
    with the same arguments.
    """
    from mcmcpp_tpu_torch import analysis
    from mcmcpp_tpu_torch.analysis.diagnostics import nested_rhat_from_stats
    from mcmcpp_tpu_torch.parallel import distributed

    if multihost is None:
        multihost = distributed.is_multihost()
    # the ACT's FFT runs where the sampler runs (its chain comes back as
    # numpy)
    device = getattr(sampler, "device", None)

    if multihost:
        def _tau(samples):
            return analysis.global_autocorr_time(
                samples, window_scaling=window_scaling, device=device)

        def _rhat(samples):
            return analysis.global_rank_normalized_rhat(samples,
                                                        device=device)

        def _mess(samples):
            return analysis.global_multivariate_ess(samples, device=device)

        def _nested(samples):
            # each rank's chain columns are [red_local, black_local]: put
            # the gathered per-walker moments back in the global walker
            # order [red…, black…] before grouping them in superchains
            arr = np.asarray(samples, np.float64)
            if arr.ndim == 2:
                arr = arr[:, :, None]

            def global_order(x):
                g = distributed.process_allgather(torch.from_numpy(x))
                r, w, p = g.shape
                return g.reshape(r, 2, w // 2, p).transpose(
                    1, 0, 2, 3).reshape(r * w, p)

            return nested_rhat_from_stats(
                global_order(arr.mean(axis=0)), global_order(arr.var(axis=0)),
                nested_superchains)
    else:
        def _tau(samples):
            return analysis.autocorr_time(
                samples, window_scaling=window_scaling, device=device)

        def _rhat(samples):
            return analysis.potential_scale_reduction(samples)

        def _mess(samples):
            return analysis.multivariate_ess(samples)

        def _nested(samples):
            return np.atleast_1d(
                analysis.nested_rhat(samples, nested_superchains))

    run = getattr(sampler, "run_mcmc", None) or sampler.run
    max_steps = int(max_steps)
    check_every = int(check_every)
    if check_every < 1 or max_steps < 1:
        raise ValueError("max_steps and check_every must be >= 1")
    tau_prev = None
    done = 0
    checks = 0
    nan = np.full(getattr(sampler, "n_params", 1), np.nan)
    report = ConvergenceReport(False, 0, 0, nan, nan, 0, "not started")
    while done < max_steps:
        take = min(check_every, max_steps - done)
        ok = run(take, thin=thin)
        done += take
        samples = sampler.get_samples()
        n_stored = samples.shape[0]
        if n_stored < 8:
            if not ok:  # chain capacity reached before anything usable
                return ConvergenceReport(
                    False, done, n_stored, report.tau, report.rhat,
                    checks, "chain capacity reached",
                )
            continue
        tau = np.atleast_1d(_tau(samples))
        checks += 1
        rhat = nan
        window_ok = bool(np.all(tau > 0))
        length_ok = window_ok and n_stored > act_multiplier * float(tau.max())
        stable_ok = (
            window_ok
            and tau_prev is not None
            and np.all(np.abs(tau - tau_prev) <= tau_rtol * np.abs(tau))
        )
        rhat_ok = True
        if rhat_threshold is not None:
            rhat = np.atleast_1d(_rhat(samples))
            rhat_ok = bool(np.all(rhat < rhat_threshold))
        nested = None
        nested_ok = True
        if nested_superchains is not None:
            nested = _nested(samples)
            nested_ok = bool(np.all(nested < nested_rhat_threshold))
        mess = float("nan")
        mess_ok = True
        if mess_rule is not None:
            alpha, eps = (0.05, 0.05) if mess_rule is True else mess_rule
            p_dim = samples.shape[-1] if samples.ndim == 3 else 1
            need = analysis.min_ess_required(p_dim, alpha=alpha, eps=eps)
            try:
                mess = _mess(samples)
            except ValueError:  # chain still too short to batch
                mess = float("nan")
            mess_ok = bool(np.isfinite(mess) and mess >= need)
        converged = (window_ok and length_ok and stable_ok and rhat_ok
                     and mess_ok and nested_ok)
        reason = (
            "converged" if converged
            else "window open" if not window_ok
            else f"chain shorter than {act_multiplier}*tau" if not length_ok
            else "tau not yet stable" if not stable_ok
            else f"rhat >= {rhat_threshold}" if not rhat_ok
            else f"nested rhat >= {nested_rhat_threshold}" if not nested_ok
            else f"mESS {mess:.0f} below the (alpha, eps) requirement"
        )
        report = ConvergenceReport(
            converged, done, n_stored, tau, rhat, checks, reason, mess,
            nested,
        )
        if callback is not None:
            callback(report)
        if converged:
            return report
        tau_prev = tau
        if not ok:  # chain byte cap reached (EndOfChain semantics)
            return report._replace(reason="chain capacity reached")
    return report._replace(reason=f"step budget {max_steps} exhausted: "
                                  f"{report.reason}")
