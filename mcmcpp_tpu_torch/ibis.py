"""IBIS: Iterated Batch Importance Sampling (data-tempered SMC).

PyTorch counterpart of ``mcmcpp_tpu/ibis.py`` (Chopin 2002). Particles track
the partial posteriors π_t(θ) ∝ p(θ) Π_{i<t} p(y_i | θ), reweighted by each
arriving batch's likelihood and resampled + moved (``n_mcmc`` Gaussian
random-walk MH steps with proposal covariance 2.38²/P × the resampled
cloud's) only when the ESS degrades. The running log-evidence is the
prequential sum of log p(y_batch | y_past), so new data extend a finished
run (:meth:`IBISSampler.update` again).

Where the JAX package scores masked rows of a buffer padded to a
power-of-two capacity (one traced program per capacity), the port scores
slices of the absorbed stream: the new batch ``[start, start + take)`` and,
in a move, the prefix ``[0, start + take)``. The resample-or-not decision
(JAX's ``lax.cond``) is a host test on the stage's ESS: a stage costs that
one host sync. ``max_chunk_steps`` keeps its name: full stages run in groups
of that many (:func:`mcmcpp_tpu_torch.utils.buffers.chunked_stage_scan`)
whose increments reach the host's ``log_evidence_trace`` in one read a
group; a grouped run and a per-stage run draw the same numbers and are
bitwise equal.

Sharded (``mesh=``, a ``WalkerLayout``), the particles split over the
ranks: a rank holds its rows of the cloud, its log prior, likelihood sums
and log weights, and scores its rows. A stage gathers the log weights and
the batch's increments once (the evidence increment and the ESS test are
then the unsharded code's on every rank, so every rank takes the same
branch); a resampling stage also gathers the cloud with its log prior and
likelihood sums, resamples it whole, takes the proposal's factor from the
whole resampled cloud and moves the rank's rows. Every draw (the prior
sample, the resampling offset, the moves' normals and uniforms) is drawn
whole and cut, so a sharded run equals the unsharded one bit for bit on
any number of ranks. ``posterior()`` and ``moments()`` read the whole
cloud (one all-gather); ``state`` holds the rank's rows.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gibbs import per_chain
from mcmcpp_tpu_torch.models.lgss import nan_cholesky
from mcmcpp_tpu_torch.ops.random import AUX_STREAM, STEP_STREAM, \
    make_generator
from mcmcpp_tpu_torch.parallel.mesh import _engine_device, gathered, \
    own_rows
from mcmcpp_tpu_torch.smc import ess_from_log_weights, systematic_resample
from mcmcpp_tpu_torch.utils.buffers import chunked_stage_scan

__all__ = ["IBISSampler", "IBISState", "StageNoise"]


class IBISState(NamedTuple):
    particles: torch.Tensor     # (n, P)
    log_prior: torch.Tensor     # (n,)
    loglik_cum: torch.Tensor    # (n,) Σ log p(y_i|θ) over included rows
    log_w: torch.Tensor         # (n,) running (unnormalized) log weights
    log_evidence: torch.Tensor  # () running log p(y_{1:t})
    n_included: torch.Tensor    # () int32 rows absorbed so far


class StageNoise(NamedTuple):
    """A resampling stage's draws: ``u0`` () the systematic offset and
    ``moves`` one (z (n, P), u (n,)) pair per MH step."""

    u0: torch.Tensor
    moves: list


def _rows(data, lo, hi):
    if isinstance(data, dict):
        return {k: v[lo:hi] for k, v in data.items()}
    return data[lo:hi]


def _n_rows(data):
    if isinstance(data, dict):
        sizes = {int(v.shape[0]) for v in data.values()}
        if len(sizes) != 1:
            raise ValueError(f"data leaves disagree on leading axis: {sizes}")
        return sizes.pop()
    return int(data.shape[0])


def _cat(a, b):
    if isinstance(a, dict):
        return {k: torch.cat([a[k], b[k]], 0) for k in a}
    return torch.cat([a, b], 0)


def _to_device(data, dev):
    if isinstance(data, dict):
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(dev) for k, v in data.items()}
    return torch.as_tensor(np.asarray(data) if not isinstance(
        data, torch.Tensor) else data).to(dev)


def cloud_moments(particles, log_w):
    """Weighted mean and covariance of a cloud, in float64 numpy (≙ the JAX
    package's ``moments``)."""
    x = particles.cpu().numpy().astype(np.float64)
    lw = log_w.cpu().numpy().astype(np.float64)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    mean = w @ x
    centered = x - mean
    cov = (centered * w[:, None]).T @ centered / (1.0 - (w ** 2).sum())
    return mean, cov


def cloud_draws(particles, log_w, n, n_draws, seed):
    """Weight-resampled draws (numpy's generator, as the JAX package)."""
    lw = log_w.cpu().numpy().astype(np.float64)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=n if n_draws is None else int(n_draws), p=w)
    return particles.cpu().numpy()[idx]


def rw_chol(particles, rw_scale, jitter):
    """The random-walk proposal's factor: 2.38²/P × the cloud's covariance
    (plus ``jitter`` on the diagonal), times ``rw_scale²``."""
    n, p = particles.shape
    centered = particles - torch.mean(particles, 0)
    cov = centered.mT @ centered / (n - 1.0)
    cov = cov + jitter * torch.eye(p, dtype=cov.dtype, device=cov.device)
    return nan_cholesky((rw_scale ** 2) * (2.38 ** 2 / p) * cov)


class IBISSampler:
    """Online posterior + prequential evidence over a data stream.

    log_prior_fn : (P,) -> scalar (or with ``batched=True`` (n, P) -> (n,)).
    loglike_point_fn : (theta (P,), row) -> scalar log p(y_i | θ) for ONE
        datum (vmapped over rows and particles), or with ``batched=True``
        (theta (n, P), rows) -> (n, R).
    prior_sample_fn : (gen, n) -> (n, P) prior draws on the sampler's
        device.
    batch_size : rows absorbed per stage; n_mcmc : RWM steps per resample
        event; target_ess : resample when ESS/n drops below it.
    device : default "cuda" (CUDA without a GPU raises).
    mesh : a ``WalkerLayout`` splitting the particles over the ranks of a
        process group, on the layout's device.
    """

    def __init__(self, log_prior_fn, loglike_point_fn, prior_sample_fn,
                 n_particles, n_params, batch_size=1, n_mcmc=5,
                 target_ess=0.5, rw_scale=1.0, seed=0, dtype=torch.float32,
                 mesh=None, max_chunk_steps=32, batched=False, device=None):
        self.mesh = mesh
        self._rows = own_rows(mesh, int(n_particles), "n_particles")
        self.device = _engine_device(mesh, device)
        self.log_prior_fn = log_prior_fn
        self.loglike_point_fn = loglike_point_fn
        self.prior_sample_fn = prior_sample_fn
        self._log_prior = per_chain(log_prior_fn, batched)
        if batched:
            self._loglik_rows = loglike_point_fn
        else:
            self._loglik_rows = torch.func.vmap(torch.func.vmap(
                loglike_point_fn, in_dims=(None, 0)), in_dims=(0, None))
        self.n = int(n_particles)
        self.n_params = int(n_params)
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.n_mcmc = int(n_mcmc)
        self.target_ess = float(target_ess)
        self.rw_scale = float(rw_scale)
        self.dtype = dtype
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self.state = None
        self._data = None  # the absorbed stream, leading axis = rows
        self.n_resamples = 0
        self.log_evidence_trace = []  # per-stage log p(y_batch | y_past)
        self._chunk_size = (1 if max_chunk_steps is None
                            else max(1, int(max_chunk_steps)))
        self.host_syncs = 0

    def _masked_loglik(self, particles, rows):
        """(n,) Σ over ``rows`` of log p(y_i | θ) per particle."""
        return torch.sum(self._loglik_rows(particles, rows), -1).to(
            self.dtype)

    def draw_stage_noise(self):
        """A resampling stage's draws, in the order a stage draws them."""
        gen, n, dev = self._step_gen, self.n, self.device
        u0 = torch.rand((), generator=gen, dtype=self.dtype, device=dev)
        moves = [(torch.randn((n, self.n_params), generator=gen,
                              dtype=self.dtype, device=dev),
                  torch.rand((n,), generator=gen, dtype=self.dtype,
                             device=dev))
                 for _ in range(self.n_mcmc)]
        return StageNoise(u0, moves)

    @torch.no_grad()
    def stage(self, state, data, start, take, noise=None):
        """Absorb rows ``[start, start + take)``: reweight, then (on the host
        test of the ESS) resample and move. ``noise`` replaces a resampling
        stage's draws (every particle's, when sharded). Returns (state,
        stage_logz (), resampled (bool))."""
        incr = self._masked_loglik(state.particles,
                                   _rows(data, start, start + take))
        rows = self._rows
        # every particle's old weights and increments (one all-gather)
        lw_old, incr_all = gathered(self.mesh, state.log_w, incr)
        log_w_all = lw_old + incr_all
        stage_logz = (torch.logsumexp(log_w_all, 0)
                      - torch.logsumexp(lw_old, 0))
        log_w = log_w_all[rows]
        loglik_cum = state.loglik_cum + incr
        ess = ess_from_log_weights(log_w_all)
        particles, log_prior = state.particles, state.log_prior
        self.host_syncs += 1
        resample = bool(ess < self.target_ess * self.n)
        if resample:
            if noise is None:
                noise = self.draw_stage_noise()
            whole, log_prior, loglik_cum = gathered(self.mesh, particles,
                                                    log_prior, loglik_cum)
            idx = systematic_resample(noise.u0, log_w_all, self.n)
            whole = whole[idx]
            chol = rw_chol(whole, self.rw_scale, 1e-8)
            idx = idx[rows]
            particles, log_prior = whole[rows], log_prior[idx]
            loglik_cum = loglik_cum[idx]
            prefix = _rows(data, 0, start + take)
            for z, u in noise.moves:
                # the whole (n, P) product's rows (a small product's rows
                # can depend on how many it has)
                u = u[rows]
                prop = particles + (z @ chol.mT)[rows]
                lp_new = self._log_prior(prop).to(self.dtype)
                ll_new = self._masked_loglik(prop, prefix)
                accept = torch.log(u) < ((lp_new + ll_new)
                                         - (log_prior + loglik_cum))
                particles = torch.where(accept[:, None], prop, particles)
                log_prior = torch.where(accept, lp_new, log_prior)
                loglik_cum = torch.where(accept, ll_new, loglik_cum)
            log_w = torch.zeros_like(log_w)
        new = IBISState(particles, log_prior, loglik_cum, log_w,
                        state.log_evidence + stage_logz.to(
                            state.log_evidence.dtype),
                        state.n_included + int(take))
        return new, stage_logz, resample

    # -- public API ----------------------------------------------------------

    @torch.no_grad()
    def init(self):
        particles = torch.as_tensor(
            self.prior_sample_fn(self._aux_gen, self.n)).to(self.device,
                                                            self.dtype)
        if tuple(particles.shape) != (self.n, self.n_params):
            raise ValueError(f"prior_sample returned {tuple(particles.shape)}"
                             f", expected {(self.n, self.n_params)}")
        particles = particles[self._rows]
        zeros = torch.zeros(particles.shape[0], dtype=self.dtype,
                            device=self.device)
        self.state = IBISState(
            particles, self._log_prior(particles).to(self.dtype), zeros,
            zeros.clone(), torch.zeros((), dtype=self.dtype,
                                       device=self.device),
            torch.zeros((), dtype=torch.int32, device=self.device))
        return self

    def _run_stages(self, data, start, count, take):
        def one(gen, st, r):
            st, logz, resampled = self.stage(st, data, start + r * take,
                                             take)
            return st, (logz, float(resampled))

        _, self.state, (logzs, resampleds) = chunked_stage_scan(
            one, self._step_gen, self.state, count)
        self.host_syncs += 1  # the group's trace, read once
        self.log_evidence_trace.extend(float(v) for v in logzs.tolist())
        self.n_resamples += int(resampleds.sum())

    def update(self, data):
        """Absorb ``data`` (an array, or a flat dict of arrays, leading
        axis = rows) batch by batch; call again as the stream grows.
        Returns self."""
        if self.state is None:
            self.init()
        data = _to_device(data, self.device)
        n_new = _n_rows(data)
        start = 0 if self._data is None else _n_rows(self._data)
        self._data = data if self._data is None else _cat(self._data, data)
        n_rows = start + n_new
        bs, chunk = self.batch_size, self._chunk_size
        while n_rows - start >= bs:
            count = min(chunk, (n_rows - start) // bs)
            self._run_stages(self._data, start, count, bs)
            start += count * bs
        if start < n_rows:  # a partial last batch
            self._run_stages(self._data, start, 1, n_rows - start)
        return self

    # -- readout -------------------------------------------------------------

    @property
    def log_evidence(self):
        """Running log p(y_{1:t}) (prequential sum)."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return float(self.state.log_evidence)

    def posterior(self, n_draws=None, seed=0):
        """Weight-resampled posterior draws from the current particles."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return cloud_draws(*gathered(self.mesh, self.state.particles,
                                     self.state.log_w), self.n,
                           n_draws, seed)

    def moments(self):
        """Weighted posterior mean and covariance of the current cloud."""
        if self.state is None:
            raise RuntimeError("call update() first")
        return cloud_moments(*gathered(self.mesh, self.state.particles,
                                       self.state.log_w))
