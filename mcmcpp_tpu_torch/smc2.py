"""SMC²: online joint parameter and state inference for state-space models.

PyTorch counterpart of ``mcmcpp_tpu/smc2.py`` (Chopin, Jacob &
Papaspiliopoulos 2013): an IBIS-style θ-level particle system whose
per-observation likelihood increments come from one bootstrap particle
filter per θ-particle, the x-systems persisting across observations. Each
arriving y_t:

1. advances every θ-particle's x-system one filter step (the M filters as
   one ``(M, Nx, D)`` batch, :func:`mcmcpp_tpu_torch.particle.
   bootstrap_step`), giving p̂(y_t | y_{1:t-1}, θ^m);
2. reweights the θ-cloud by those increments (the prequential evidence);
3. when the θ-ESS degrades, resamples whole (θ, x-system) pairs and
   rejuvenates each θ by a PMMH move: propose θ', run a FRESH filter over
   the absorbed prefix y_{1:t} (all M filters as one batch), accept on the
   pseudo-marginal ratio (a non-finite proposal is rejected), and adopt the
   fresh x-system on acceptance.

The resample-or-move decision (JAX's ``lax.cond``) is a host test on the θ
ESS: one host sync a stage. The rejuvenation filter runs over the absorbed
rows only (the JAX package runs it over the padded capacity with a row
mask). ``max_chunk_steps`` groups stages between the host reads of their
increments (:func:`mcmcpp_tpu_torch.utils.buffers.chunked_stage_scan`; a
grouped and a per-stage run are bitwise equal); under ``grow_particles``
every stage is its own group, and a rejuvenating stage also reads its
acceptance to decide the exchange step (Chopin et al. 2013, §3.5). The
degenerate-cloud guard floors the proposal covariance by a device
``where``.

Sharded (``mesh=``, a ``WalkerLayout``), the θ-particles split over the
ranks together with their x-systems: a rank advances, weights and
rejuvenates its θ rows' filters locally. A stage gathers the θ log weights
and increments once (the evidence increment and the θ-ESS test are the
unsharded code's on every rank); a moving stage also gathers the θ cloud
with its x-systems, resamples whole (θ, x-system) pairs, takes the
proposal's moments from the whole resampled cloud, and sums the accepted
moves over the ranks (one all-reduce). The stage's own draws (the
x-systems' and the rejuvenation filters' resampling offsets, the θ offset,
the proposal normals and accept uniforms) and the prior sample are drawn
whole and cut; the hooks draw from :func:`~mcmcpp_tpu_torch.parallel.mesh.
hook_generator`'s generator: the step generator in a group of one (bit for
bit the unsharded run), a rank's fork over more ranks (another, equally
valid draw; with hooks that draw nothing, the unsharded run's on any
number of ranks). ``posterior()``, ``moments()`` and ``state_estimate()`` read
the whole cloud (one all-gather); ``state`` holds the rank's rows.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gibbs import per_chain
from mcmcpp_tpu_torch.ibis import cloud_draws, cloud_moments
from mcmcpp_tpu_torch.models.lgss import nan_cholesky
from mcmcpp_tpu_torch.ops.random import AUX_STREAM, STEP_STREAM, \
    make_generator
from mcmcpp_tpu_torch.particle import Hooks, as_series, bootstrap_step, \
    run_filter
from mcmcpp_tpu_torch.parallel.mesh import (
    _engine_device,
    gathered,
    hook_generator,
    own_rows,
)
from mcmcpp_tpu_torch.smc import ess_from_log_weights, systematic_resample
from mcmcpp_tpu_torch.utils.buffers import chunked_stage_scan

__all__ = ["SMC2Sampler", "SMC2State", "StageNoise"]


class SMC2State(NamedTuple):
    theta: torch.Tensor         # (M, P)
    log_prior: torch.Tensor     # (M,)
    loglik_hat: torch.Tensor    # (M,) carried PF estimate log p̂(y_{1:t}|θ)
    xs: torch.Tensor            # (M, Nx, D) per-θ state particles
    x_logw: torch.Tensor        # (M, Nx) normalized x log-weights
    log_w: torch.Tensor         # (M,) θ-level running log weights
    log_evidence: torch.Tensor  # () running log p̂(y_{1:t})
    n_included: torch.Tensor    # () int32 observations absorbed


class StageNoise(NamedTuple):
    """A stage's own uniforms and normals, for a replay (the hooks draw
    theirs from the generator): ``advance_u`` (M,) the x-systems'
    resampling offsets (unused at t = 0); ``u0`` () the θ resampling offset;
    ``moves`` one (z (M, P), filter_u (t, M), u (M,)) per PMMH step."""

    advance_u: torch.Tensor
    u0: torch.Tensor = None
    moves: list = ()


class SMC2Sampler:
    """Online SSM inference: the posterior over θ (and the filtered states)
    after every observation, with the prequential evidence.

    ssm : :class:`~mcmcpp_tpu_torch.particle.StateSpaceModel` reading θ as
        a flat ``(P,)`` vector (vmapped over the θ-particles), or with
        ``batched=True`` θ (M, P) and particles (M, Nx, D).
    log_prior_fn : (P,) -> scalar (batched: (M, P) -> (M,)).
    prior_sample_fn : (gen, n) -> (n, P) prior draws.
    n_theta / n_particles : M θ-particles / Nx x-particles per θ.
    device : default "cuda" (CUDA without a GPU raises).
    mesh : a ``WalkerLayout`` splitting the θ-particles (with their
        x-systems) over the ranks of a process group, on its device.
    """

    def __init__(self, ssm, log_prior_fn, prior_sample_fn, n_theta, n_params,
                 n_particles=128, n_mcmc=3, target_ess=0.5, ess_frac_x=0.5,
                 rw_scale=1.0, seed=0, dtype=torch.float32, mesh=None,
                 grow_particles=False, grow_threshold=0.15,
                 max_particles=None, max_chunk_steps=32, batched=False,
                 device=None):
        self.mesh = mesh
        self._rows = own_rows(mesh, int(n_theta), "n_theta")
        self.device = _engine_device(mesh, device)
        self.ssm = ssm
        self.batched = bool(batched)
        self.log_prior_fn = log_prior_fn
        self._log_prior = per_chain(log_prior_fn, batched)
        self.prior_sample_fn = prior_sample_fn
        self.m = int(n_theta)
        self.n_params = int(n_params)
        self.n_x = int(n_particles)
        self.n_mcmc = int(n_mcmc)
        self.target_ess = float(target_ess)
        self.ess_frac_x = float(ess_frac_x)
        self.rw_scale = float(rw_scale)
        self.dtype = dtype
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        # the hooks' and the filters' generator: the step generator itself
        # unsharded or in a group of one (rule (b) of parallel/mesh.py)
        self._hook_gen = hook_generator(mesh, self._step_gen)
        self.state = None
        self._ys = None            # the absorbed (T, E) observations
        self.n_resamples = 0
        self.log_evidence_trace = []   # per-obs log p̂(y_t | y_{1:t-1})
        self.grow_particles = bool(grow_particles)
        self.grow_threshold = float(grow_threshold)
        self.max_particles = (16 * self.n_x if max_particles is None
                              else int(max_particles))
        self.n_growths = 0
        self.last_rejuvenation_accept = float("nan")
        self._chunk_size = (1 if max_chunk_steps is None
                            else max(1, int(max_chunk_steps)))
        self.host_syncs = 0

    def _hooks(self, theta):
        return Hooks(self.ssm, theta, (theta.shape[0],), self.batched)

    def _x_dim(self):
        gen = torch.Generator(device=self.device)
        theta = torch.zeros((1, self.n_params), dtype=self.dtype,
                            device=self.device)
        shape = tuple(self._hooks(theta).init_sample(gen, self.n_x).shape)
        if len(shape) != 3 or shape[1] != self.n_x:
            raise ValueError(f"ssm.init_sample must return (n, D), got "
                             f"{shape[1:]}")
        return shape[2]

    def _masked_pf(self, gen, theta, ys, n, filter_u=None):
        """A fresh bootstrap filter per θ-row over the rows ``ys``:
        (loglik (M,), final particles, final log weights). The resampling
        uniforms come from ``gen`` (every θ's, cut to the rank's), the
        hooks' draws from the hook generator."""
        res, x, lw = run_filter(
            gen, self._hooks(theta), ys, n, self.ess_frac_x,
            resample_u=filter_u, stats=False, final=True,
            hook_gen=self._hook_gen, chains=None if self.mesh is None
            else (self.mesh, self._rows, self.m))
        return res.loglik.to(self.dtype), x.to(self.dtype), lw

    def _advance(self, gen, state, y, t, u=None):
        """One filter step of every x-system (t == 0: fresh systems from the
        initial law). Returns (xs, x_logw, incr (M,)); ``u`` every θ's
        resampling offset (drawn from ``gen`` when None), the hooks
        drawing from the hook generator."""
        hooks, n, hgen = self._hooks(state.theta), self.n_x, self._hook_gen
        if t == 0:
            x0 = hooks.init_sample(hgen, n).to(self.dtype)
            ll = hooks.obs_logpdf(y, x0, 0)
            norm = torch.logsumexp(ll, -1)
            return x0, ll - norm[:, None], norm - math.log(float(n))
        if u is None:
            u = torch.rand((self.m,), generator=gen, dtype=self.dtype,
                           device=self.device)
        xn, lw, incr = bootstrap_step(
            hgen, hooks, state.xs, state.x_logw,
            ess_from_log_weights(state.x_logw), y, t, n, self.ess_frac_x,
            u[self._rows])
        return xn.to(self.dtype), lw, incr

    @torch.no_grad()
    def stage(self, state, ys, t, noise=None):
        """Absorb observation row ``t`` of ``ys``: advance, reweight, then
        (on the host test of the θ-ESS) resample and rejuvenate. Returns
        (state, stage_logz (), moved (bool), acceptance () or NaN).
        ``noise`` holds every θ-particle's draws, also when sharded."""
        gen, m, rows = self._step_gen, self.m, self._rows
        xs, x_logw, incr = self._advance(
            gen, state, ys[t], t, None if noise is None else noise.advance_u)
        incr = incr.to(self.dtype)
        # every θ's old weights and increments (one all-gather)
        lw_old, incr_all = gathered(self.mesh, state.log_w, incr)
        log_w_all = lw_old + incr_all
        stage_logz = (torch.logsumexp(log_w_all, 0)
                      - torch.logsumexp(lw_old, 0))
        log_w = log_w_all[rows]
        loglik_hat = state.loglik_hat + incr
        theta, log_prior = state.theta, state.log_prior
        acc_rate = torch.full((), float("nan"), device=self.device)
        self.host_syncs += 1
        moved = bool(ess_from_log_weights(log_w_all) < self.target_ess * m)
        if moved:
            u0 = (torch.rand((), generator=gen, dtype=self.dtype,
                             device=self.device)
                  if noise is None else noise.u0)
            idx = systematic_resample(u0, log_w_all, m)
            x_shape = xs.shape[1:]
            theta_all, log_prior, loglik_hat, xs, x_logw = gathered(
                self.mesh, theta, log_prior, loglik_hat,
                xs.reshape(xs.shape[0], -1), x_logw)
            xs = xs.reshape((-1,) + tuple(x_shape))
            theta_all = theta_all[idx]
            own = idx[rows]
            theta, log_prior, loglik_hat = (theta_all[rows], log_prior[own],
                                            loglik_hat[own])
            xs, x_logw = xs[own], x_logw[own]
            centered = theta_all - torch.mean(theta_all, 0)
            cov = centered.mT @ centered / (m - 1.0)
            # the degenerate-cloud guard (PMMH tune()'s spread check as a
            # device select): floor a collapsed cloud's proposal
            eye = torch.eye(self.n_params, dtype=cov.dtype, device=cov.device)
            floor = torch.where(torch.trace(cov) < self.n_params * 1e-10,
                                1e-2, 1e-8)
            chol = nan_cholesky((self.rw_scale ** 2)
                                * (2.38 ** 2 / self.n_params)
                                * (cov + floor * eye))
            n_acc = torch.zeros((), dtype=torch.int32, device=self.device)
            prefix = ys[:t + 1]
            for i in range(self.n_mcmc):
                if noise is None:
                    z = torch.randn((m, self.n_params), generator=gen,
                                    dtype=self.dtype, device=self.device)
                    filter_u = None
                else:
                    z, filter_u, u = noise.moves[i]
                    filter_u = filter_u[:, rows]
                # the whole (M, P) product's rows (a small product's rows
                # can depend on how many it has)
                prop = theta + (z @ chol.mT)[rows]
                lp_new = self._log_prior(prop).to(self.dtype)
                ll_new, x_new, xw_new = self._masked_pf(
                    gen, prop, prefix, self.n_x, filter_u)
                if noise is None:
                    u = torch.clamp(torch.rand((m,), generator=gen,
                                               dtype=self.dtype,
                                               device=self.device), min=1e-37)
                u = u[rows]
                log_ratio = (lp_new + ll_new) - (log_prior + loglik_hat)
                ok = (torch.log(u) < log_ratio) & torch.isfinite(lp_new) \
                    & torch.isfinite(ll_new)
                theta = torch.where(ok[:, None], prop, theta)
                log_prior = torch.where(ok, lp_new, log_prior)
                loglik_hat = torch.where(ok, ll_new, loglik_hat)
                xs = torch.where(ok[:, None, None], x_new, xs)
                x_logw = torch.where(ok[:, None], xw_new, x_logw)
                n_acc = n_acc + torch.sum(ok.to(torch.int32))
            if self.mesh is not None:
                n_acc = self.mesh.sum(n_acc)
            acc_rate = n_acc / float(m * max(self.n_mcmc, 1))
            log_w = torch.zeros_like(log_w)
        new = SMC2State(theta, log_prior, loglik_hat, xs, x_logw, log_w,
                        state.log_evidence + stage_logz.to(
                            state.log_evidence.dtype),
                        state.n_included + 1)
        return new, stage_logz, moved, acc_rate

    def _grow(self, ys):
        """The exchange step: every x-system replaced by a fresh filter at
        2·Nx over the absorbed prefix, the θ-weights importance-corrected by
        the new/old estimate ratio."""
        new_nx = 2 * self.n_x
        s = self.state
        ll_new, x_new, xw_new = self._masked_pf(self._step_gen, s.theta, ys,
                                                new_nx)
        self.state = s._replace(loglik_hat=ll_new, xs=x_new, x_logw=xw_new,
                                log_w=s.log_w + (ll_new - s.loglik_hat))
        self.n_x = new_nx
        self.n_growths += 1

    # -- public API ----------------------------------------------------------

    @torch.no_grad()
    def init(self):
        theta = torch.as_tensor(self.prior_sample_fn(self._aux_gen,
                                                     self.m)).to(
            self.device, self.dtype)
        if tuple(theta.shape) != (self.m, self.n_params):
            raise ValueError(f"prior_sample returned {tuple(theta.shape)}, "
                             f"expected {(self.m, self.n_params)}")
        theta = theta[self._rows]
        d, n, m = self._x_dim(), self.n_x, theta.shape[0]
        zeros = torch.zeros(m, dtype=self.dtype, device=self.device)
        self.state = SMC2State(
            theta, self._log_prior(theta).to(self.dtype), zeros,
            torch.zeros((m, n, d), dtype=self.dtype, device=self.device),
            torch.full((m, n), -math.log(n), dtype=self.dtype,
                       device=self.device),
            zeros.clone(),
            torch.zeros((), dtype=self.dtype, device=self.device),
            torch.zeros((), dtype=torch.int32, device=self.device))
        return self

    def _run_stages(self, t0, count):
        ys = self._ys

        def one(gen, st, r):
            st, logz, moved, acc = self.stage(st, ys, t0 + r)
            return st, (logz, acc, float(moved))

        _, self.state, (logzs, accs, moveds) = chunked_stage_scan(
            one, self._step_gen, self.state, count)
        self.host_syncs += 1  # the group's increments and acceptances
        logzs, accs = torch.stack([logzs.double(), accs.double()]).cpu().numpy()
        self.log_evidence_trace.extend(float(v) for v in logzs)
        moveds = moveds.numpy().astype(bool)
        self.n_resamples += int(moveds.sum())
        if moveds.any():
            self.last_rejuvenation_accept = float(accs[moveds][-1])
        return bool(moveds[-1])

    def update(self, ys):
        """Absorb observations ``ys`` ((T_new, E) or (T_new,)) one at a time;
        call again as the stream grows. Returns self."""
        if self.state is None:
            self.init()
        ys = as_series(ys).to(self.device, self.dtype)
        t = 0 if self._ys is None else self._ys.shape[0]
        self._ys = ys if self._ys is None else torch.cat([self._ys, ys], 0)
        n_rows = self._ys.shape[0]
        chunk = 1 if self.grow_particles else self._chunk_size
        while t < n_rows:
            count = min(chunk, n_rows - t)
            moved = self._run_stages(t, count)
            t += count
            if (self.grow_particles and moved
                    and self.last_rejuvenation_accept < self.grow_threshold
                    and 2 * self.n_x <= self.max_particles):
                self._grow(self._ys[:t])
        return self

    # -- readout -------------------------------------------------------------

    @property
    def log_evidence(self):
        """Running log p̂(y_{1:t}) (prequential sum)."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return float(self.state.log_evidence)

    def posterior(self, n_draws=None, seed=0):
        """Weight-resampled θ draws from the current cloud."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return cloud_draws(*gathered(self.mesh, self.state.theta,
                                     self.state.log_w), self.m, n_draws, seed)

    def moments(self):
        """Weighted posterior mean and covariance of θ."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return cloud_moments(*gathered(self.mesh, self.state.theta,
                                       self.state.log_w))

    def state_estimate(self):
        """E[x_t | y_{1:t}] marginalized over θ: Σ_m w_m Σ_i w_mi x_mi."""
        if self.state is None:
            raise RuntimeError("call update() first")
        s = self.state
        lw, xw, xs = gathered(self.mesh, s.log_w, s.x_logw,
                              s.xs.reshape(s.xs.shape[0], -1))
        lw = lw.cpu().numpy().astype(np.float64)
        w = np.exp(lw - lw.max())
        w /= w.sum()
        xw = xw.cpu().numpy().astype(np.float64)
        xw = np.exp(xw - xw.max(axis=1, keepdims=True))
        xw /= xw.sum(axis=1, keepdims=True)
        xs = xs.reshape((-1,) + tuple(s.xs.shape[1:])).cpu().numpy().astype(
            np.float64)
        return w @ np.einsum("mi,mid->md", xw, xs)
