"""emcee-compatible facade over the ensemble sampler.

The reference (MCMCpp) is the C++ twin of emcee's affine-invariant
ensemble sampler (same Goodman-Weare algorithm family, ``README.md:1-2``),
so most prospective users arrive with emcee muscle memory. This shim
mirrors the emcee v3 surface — constructor argument order, ``run_mcmc``,
``get_chain(discard, thin, flat)``, ``get_log_prob``,
``get_autocorr_time``, per-walker ``acceptance_fraction`` — on top of
:class:`mcmcpp_tpu_torch.EnsembleSampler`.

Deliberate differences (documented, not silent):
- ``log_prob_fn`` must be written in torch and work under
  ``torch.func.vmap`` (it is batched on the device); pure NumPy callables
  won't do.
- ``device=`` (default "cuda", no CPU fallback) and the sampler's other
  keyword arguments pass through.
- ``moves`` accepts this package's mover classes, e.g.
  ``[(StretchMove(a=2.0), 0.7), (DESnookerMove(), 0.3)]``.

``acceptance_fraction`` is REAL per-walker data (the sampler carries
per-walker accept counters on device, ≙ ``MCMCpp/Walker/Walker.h:111-122``),
so a stuck walker is visible exactly as it would be in emcee.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.movers import MixtureMover, Mover


class State(NamedTuple):
    """emcee-style ensemble state."""

    coords: np.ndarray  # (nwalkers, ndim)
    log_prob: np.ndarray  # (nwalkers,)


class EnsembleSampler:
    """``emcee.EnsembleSampler(nwalkers, ndim, log_prob_fn)`` lookalike."""

    #: rows per device batch when :meth:`get_blobs` recomputes the blobs
    blob_chunk_rows = 1 << 20

    def __init__(self, nwalkers, ndim, log_prob_fn, args=None, kwargs=None,
                 moves=None, seed=0, **backend_kwargs):
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        if args or kwargs:
            a, kw = tuple(args or ()), dict(kwargs or {})
            fn = log_prob_fn
            log_prob_fn = lambda theta: fn(theta, *a, **kw)  # noqa: E731
        # emcee blobs: log_prob_fn returning (lp, blob, ...) — detect by
        # one call on a zero point. The posterior sees lp only; blobs
        # are recomputed from stored positions in get_blobs (so they must
        # be DETERMINISTIC functions of theta, emcee's standard use)
        from mcmcpp_tpu_torch.sampler import resolve_device

        device = resolve_device(backend_kwargs.get("device", "cuda"))
        self._blobs_fn = None
        out_struct = log_prob_fn(
            torch.zeros((self.ndim,), dtype=torch.float32, device=device)
        )
        if isinstance(out_struct, (tuple, list)):
            if len(out_struct) < 2:
                raise ValueError(
                    "log_prob_fn returned a 1-tuple; return a scalar or "
                    "(log_prob, blob, ...)"
                )
            full_fn = log_prob_fn
            self._blobs_fn = full_fn
            self._blobs_batched = torch.func.vmap(full_fn)
            log_prob_fn = lambda theta: full_fn(theta)[0]  # noqa: E731
        mover = None
        if moves is not None:
            if isinstance(moves, Mover):
                mover = moves
            else:
                pairs = [m if isinstance(m, tuple) else (m, 1.0)
                         for m in moves]
                mover = (pairs[0][0] if len(pairs) == 1
                         else MixtureMover(pairs))
        from mcmcpp_tpu_torch import EnsembleSampler as _Core

        self._s = _Core(log_prob_fn, self.nwalkers, self.ndim,
                        mover=mover, seed=seed, **backend_kwargs)

    # -- emcee surface -------------------------------------------------------

    def run_mcmc(self, initial_state, nsteps, thin_by=1, progress=False,
                 store=True):
        """Run ``nsteps`` ensemble steps; returns the final :class:`State`.

        ``initial_state``: (nwalkers, ndim) coords, a :class:`State`, or
        None to continue from the current state (as in emcee).
        """
        if initial_state is not None:
            coords = getattr(initial_state, "coords", initial_state)
            self._s.set_initial_walker_pos(np.asarray(coords))
        elif self._s.state is None:
            raise ValueError("initial_state required on the first run")
        self._s.run_mcmc(int(nsteps) * int(thin_by), thin=int(thin_by),
                         store=store)
        return self.get_last_sample()

    def sample(self, initial_state=None, iterations=1, thin_by=1,
               store=True, progress=False):
        """emcee's step-iterator: yields a :class:`State` after every
        (thinned) step — the surface custom convergence loops are
        written against.

        Faithful but NOT the fast path: each yield is a host round-trip
        (a device->host copy per ``thin_by`` steps), so throughput is
        bound by the host. Use :meth:`run_mcmc` plus
        :func:`mcmcpp_tpu_torch.convergence.run_until_converged` (which
        checks every ``check_every`` steps, not every step) when speed
        matters; use this when porting emcee code verbatim.
        """
        if initial_state is not None:
            coords = getattr(initial_state, "coords", initial_state)
            self._s.set_initial_walker_pos(np.asarray(coords))
        elif self._s.state is None:
            raise ValueError("initial_state required on the first run")
        for _ in range(int(iterations)):
            self._s.run_mcmc(int(thin_by), thin=int(thin_by), store=store)
            yield self.get_last_sample()

    def get_last_sample(self):
        pos = self._s.current_positions.cpu().numpy()
        lp = torch.cat(
            [self._s.state.logp_red, self._s.state.logp_black]
        ).cpu().numpy()
        return State(coords=pos, log_prob=lp)

    def get_chain(self, discard=0, thin=1, flat=False):
        """(nsteps, nwalkers, ndim) — emcee's axis order, which matches the
        native chain layout here."""
        return self._s.get_samples(burn_in=discard, thin=thin, flat=flat)

    def get_log_prob(self, discard=0, thin=1, flat=False):
        return self._s.get_log_probs(burn_in=discard, thin=thin, flat=flat)

    def get_autocorr_time(self, discard=0, thin=1, quiet=False, tol=50,
                          **kw):
        """Integrated ACT in RAW-step units (x thin, as emcee).

        Raises (emcee semantics) when the chain is shorter than
        ``tol * tau`` or the Sokal window never closed; ``quiet=True``
        returns the unreliable estimate instead.
        """
        from mcmcpp_tpu_torch import analysis

        chain = self.get_chain(discard=discard, thin=thin)
        tau = np.atleast_1d(analysis.autocorr_time(chain, **kw))
        unreliable = bool(
            np.any(tau < 0) or chain.shape[0] < tol * np.abs(tau).max()
        )
        if unreliable and not quiet:
            raise RuntimeError(
                f"The chain is shorter than {tol} times the integrated "
                f"autocorrelation time (tau = {np.abs(tau)}, "
                f"{chain.shape[0]} stored steps); run longer or pass "
                "quiet=True"
            )
        return np.abs(tau) * thin

    def get_blobs(self, discard=0, thin=1, flat=False):
        """emcee-style per-sample metadata, recomputed from the stored
        chain (None when ``log_prob_fn`` returns a bare scalar, as in
        emcee). Single blob → array of shape (nsteps, nwalkers, …);
        multiple blobs → tuple of such arrays. Blobs must be
        deterministic functions of position — the analogue of emcee's
        metadata channel (recomputation ≡ storage for deterministic
        blobs, and keeps the sampling hot loop free of metadata
        traffic). The rows go to the device in chunks of
        ``blob_chunk_rows``: a flat chain of 2^21 walkers does not fit one
        batch of blobs."""
        if self._blobs_fn is None:
            return None
        chain = self.get_chain(discard=discard, thin=thin, flat=flat)
        rows = chain.reshape(-1, self.ndim)
        parts = []
        for i in range(0, rows.shape[0], self.blob_chunk_rows):
            batch = torch.from_numpy(np.ascontiguousarray(
                rows[i:i + self.blob_chunk_rows])).to(self._s.device)
            parts.append([b.cpu().numpy()
                          for b in self._blobs_batched(batch)[1:]])
        lead = chain.shape[:-1]
        blobs = tuple(
            np.concatenate(bs, axis=0).reshape(lead + bs[0].shape[1:])
            for bs in zip(*parts)
        )
        return blobs[0] if len(blobs) == 1 else blobs

    @property
    def acceptance_fraction(self):
        """(nwalkers,) — true per-walker acceptance fractions (walker i is
        the i-th row of the initial coords, as in emcee)."""
        return np.asarray(self._s.per_walker_acceptance, np.float64)

    def reset(self):
        self._s.reset()
        return self

    @property
    def backend(self):
        """The underlying :class:`mcmcpp_tpu_torch.EnsembleSampler`."""
        return self._s
