"""Particle filtering and particle MCMC for non-linear / non-Gaussian
state-space models: the bootstrap, auxiliary and guided particle filters,
the FFBSi smoother, predictive simulation, particle marginal
Metropolis–Hastings (PMMH) and particle Gibbs with ancestor sampling (PGAS)
as a trajectory block of :class:`~mcmcpp_tpu_torch.gibbs.BlockedGibbsSampler`.

PyTorch counterpart of ``mcmcpp_tpu/particle.py``. Every hook takes the
whole ``(N, D)`` particle block, as in the JAX package, and a
``torch.Generator`` where JAX's takes a key (the convention of
``SMCSampler.prior_sample_fn``); ``t`` is the step's Python int.

Batching whole filters over chains. The JAX package ``vmap``s a whole
filter over chains with split keys (PMMH, SMC², PGAS). The port writes the
filter once for any leading batch axes: particles ``(…, N, D)``, weights
``(…, N)``, and ``smc.systematic_resample`` resamples every row at once, so
C chains' filters advance as one ``(C, N, D)`` batch a time step, a fixed
number of launches whatever C is (a bootstrap step: the ESS, the systematic
resample with its blocked cumsum and ``searchsorted``, the gathers, the
hooks, the weight update; 77–93 launches on an H100, ``chip_smoke.py``
phase 13). Only
the user's hooks are mapped: with ``torch.func.vmap(..., randomness=
"different")`` over the chain axis, so they keep the per-filter contract
and each chain draws its own noise, or called on the batch directly when
built with ``batched=True``. (``vmap`` of the whole filter would also work,
but then every op of the T-step loop would pass through the batching
layer.) The time loop is a Python loop over T with no host sync: the
resample decision is a device ``torch.where``, as JAX's ``lax.scan`` body
has it.

Draws, for a replay: a filter step draws its resampling uniform (one a
row; ``resample_u`` hands them over) and then the hooks draw. Categorical
draws are argmax(logits + Gumbel), as ``jax.random.categorical`` is.

``mesh=`` (a ``WalkerLayout``), by the rules of
:mod:`mcmcpp_tpu_torch.parallel.mesh`. A single filter
(:func:`particle_filter`, :func:`particle_smoother`,
:func:`particle_forecast`) splits its particles over the ranks: a rank
draws its rows and propagates and weights them through the hooks, and one
all-gather a step brings every rank the whole cloud with its weight
increments (the auxiliary filter's lookahead is taken on the whole cloud,
with no collective). The normalizer, the ESS, the systematic resample
(its uniform drawn whole, the same on every rank), the filtered means and
the stored clouds are the unsharded code's on the whole cloud, so every
rank holds the unsharded result; a rank's ancestors index the whole cloud.
The smoother's backward pass runs on the gathered clouds on every rank
(its Gumbel noise drawn whole); the forecast resamples the whole cloud
once and propagates the rank's rows, which it returns. PMMH splits its
chains: each rank's filters are local, the step's proposal normals,
accept uniforms and the filters' resampling uniforms are drawn for every
chain and cut, acceptance is gathered when read and the chain stores the
rank's rows. The hooks (and PMMH's ``loglik_fn``) draw from
:func:`~mcmcpp_tpu_torch.parallel.mesh.hook_generator`: the caller's
generator in a group of one, so that the sharded run equals the unsharded
one bit for bit, a generator forked for the rank over more ranks, so that
the run is another, equally valid draw (the JAX package's, with global
keys, does not depend on the mesh); with hooks that draw nothing, a
sharded run equals the unsharded one on any number of ranks.
"""

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import Chain, default_chunk_steps, row_dtype, \
    run_pipelined
from mcmcpp_tpu_torch.gibbs import per_chain
from mcmcpp_tpu_torch.ops.random import AUX_STREAM, STEP_STREAM, \
    make_generator
from mcmcpp_tpu_torch.ops.random import gumbel as draw_gumbel
from mcmcpp_tpu_torch.parallel.mesh import (
    _engine_device,
    gathered,
    hook_generator,
    own_rows,
)
from mcmcpp_tpu_torch.smc import ess_from_log_weights, systematic_resample

__all__ = ["PFResult", "PMMHSampler", "PMMHState", "ParticleGibbsKernel",
           "SmootherResult", "StateSpaceModel", "particle_filter",
           "particle_forecast", "particle_smoother"]


class StateSpaceModel(NamedTuple):
    """Functional SSM spec; every hook is vectorized over the leading
    particle axis, ``t`` is the step (a Python int), ``theta`` any pytree.

    init_sample(gen, n, theta) -> (n, D)      draw x_1 ~ p(x_1 | θ)
    trans_sample(gen, x, t, theta) -> (n, D)  draw x_t ~ p(· | x_{t-1}=x)
    obs_logpdf(y, x, t, theta) -> (n,)        log p(y_t | x_t=x)
    trans_logpdf(x_next, x, t, theta) -> (n,) log p(x_next | x) (PGAS, the
        smoother and the guided filter; ``x_next`` arrives broadcast)
    trans_mean(x, t, theta) -> (n, D)         the auxiliary filter's point
        lookahead, when no ``lookahead_logpdf`` is given
    lookahead_logpdf(y, x, t, theta) -> (n,)  log p̂(y_t | x_{t-1})
    prop_sample(gen, x, y, t, theta) -> (n, D) a guided proposal
    prop_logpdf(x_next, x, y, t, theta) -> (n,) its density
    """

    init_sample: Callable
    trans_sample: Callable
    obs_logpdf: Callable
    trans_logpdf: Optional[Callable] = None
    trans_mean: Optional[Callable] = None
    lookahead_logpdf: Optional[Callable] = None
    prop_sample: Optional[Callable] = None
    prop_logpdf: Optional[Callable] = None


class PFResult(NamedTuple):
    loglik: torch.Tensor         # log p_hat(y_{1:T} | theta), one a row
    filter_means: torch.Tensor   # (…, T, D) self-normalized filtered means
    ess: torch.Tensor            # (…, T) effective sample size per step
    particles: Optional[torch.Tensor] = None    # (…, T, N, D) clouds
    log_weights: Optional[torch.Tensor] = None  # (…, T, N) normalized


def as_generator(gen, device, mesh=None):
    """``gen`` if it is a ``torch.Generator``, else a generator seeded from
    the int ``gen`` on ``device`` ("cuda" when None), or on ``mesh``'s
    device."""
    if isinstance(gen, torch.Generator):
        return gen
    return make_generator(int(gen), STEP_STREAM,
                          _engine_device(mesh, device))


class Hooks:
    """A :class:`StateSpaceModel`'s hooks on particles with leading batch
    axes ``lead`` (``()`` for one filter, ``(C,)`` for C filters).

    For one filter, or with ``batched=True``, the hooks are called as they
    are (a batched hook takes ``(C, N, D)`` particles and ``theta`` with its
    chain axis). Otherwise they are ``torch.func.vmap``ped over the chain
    axis with ``randomness="different"``; ``theta_dim`` is 0 when ``theta``
    carries the chain axis and None when every chain shares it."""

    def __init__(self, ssm, theta, lead=(), batched=False, theta_dim=0):
        self.ssm = ssm
        self.theta = theta
        self.lead = tuple(lead)
        self.direct = not self.lead or batched
        self.theta_dim = theta_dim

    def _call(self, fn, args):
        if self.direct:
            return fn(*args, self.theta)
        return torch.func.vmap(fn, in_dims=(0,) * len(args)
                               + (self.theta_dim,),
                               randomness="different")(*args, self.theta)

    def init_sample(self, gen, n):
        if self.direct:
            return self.ssm.init_sample(gen, n, self.theta)
        rows = torch.zeros(self.lead)
        return self._call(lambda _r, th: self.ssm.init_sample(gen, n, th),
                          (rows,))

    def trans_sample(self, gen, x, t):
        return self._call(lambda x_, th: self.ssm.trans_sample(gen, x_, t, th),
                          (x,))

    def obs_logpdf(self, y, x, t):
        return self._call(lambda x_, th: self.ssm.obs_logpdf(y, x_, t, th),
                          (x,))

    def trans_logpdf(self, x_next, x, t):
        return self._call(
            lambda xn, x_, th: self.ssm.trans_logpdf(xn, x_, t, th),
            (x_next, x))

    def trans_mean(self, x, t):
        return self._call(lambda x_, th: self.ssm.trans_mean(x_, t, th), (x,))

    def lookahead_logpdf(self, y, x, t):
        return self._call(
            lambda x_, th: self.ssm.lookahead_logpdf(y, x_, t, th), (x,))

    def prop_sample(self, gen, x, y, t):
        return self._call(
            lambda x_, th: self.ssm.prop_sample(gen, x_, y, t, th), (x,))

    def prop_logpdf(self, x_next, x, y, t):
        return self._call(
            lambda xn, x_, th: self.ssm.prop_logpdf(xn, x_, y, t, th),
            (x_next, x))


def _lse(x):
    return torch.logsumexp(x, -1)


def gather_rows(x, idx):
    """x (…, N, D) at particle indices idx (…, M): (…, M, D)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def weighted_mean(lw, x):
    """Σ_i exp(lw_i) x_i over the particle axis: (…, D)."""
    return (torch.exp(lw)[..., None, :] @ x)[..., 0, :]


def check_filter_hooks(ssm, auxiliary):
    if auxiliary and ssm.trans_mean is None \
            and ssm.lookahead_logpdf is None:
        raise ValueError(
            "auxiliary=True needs ssm.trans_mean or ssm.lookahead_logpdf")
    guided = ssm.prop_sample is not None
    if guided and (ssm.prop_logpdf is None or ssm.trans_logpdf is None):
        raise ValueError("a guided filter (ssm.prop_sample) needs "
                         "ssm.prop_logpdf and ssm.trans_logpdf")
    return guided


def as_series(ys):
    ys = torch.as_tensor(np.asarray(ys) if not isinstance(
        ys, torch.Tensor) else ys)
    return ys[:, None] if ys.ndim == 1 else ys


def filter_shard(mesh, gen, device, n):
    """(generator, shard) of a filter function: ``gen`` (or a generator
    seeded by the int ``gen``) on the engine's device, and None or
    ``(layout, this rank's rows of the n particles)``."""
    rows = own_rows(mesh, int(n), "n_particles")
    gen = as_generator(gen, device, mesh)
    return gen, None if mesh is None else (mesh, rows)


def run_filter(gen, hooks, ys, n, ess_frac=0.5, auxiliary=False,
               return_particles=False, resample_u=None, stats=True,
               final=False, shard=None, hook_gen=None, chains=None):
    """The filter on ``hooks.lead`` leading axes (see the module
    docstring); ``resample_u`` (T−1, *lead) replaces the drawn resampling
    uniforms. ``stats=False`` skips the filtered means and ESS trace (the
    likelihood-only path of PMMH and SMC²). ``shard``: ``(layout, rows)``
    of a single filter whose particles split over the ranks (the hooks see
    the rank's rows; the result is the whole cloud's on every rank).
    ``hook_gen``: the hooks' generator (default ``gen``, or under ``shard``
    its rank's fork); ``chains``: ``(layout, rows, C)`` when ``hooks.lead``
    is (n_local,), the rank's rows of C chains' filters split over the
    ranks: their resampling uniforms are drawn for all C (from ``gen``)
    and cut, and the log-likelihood sums every chain's increments over the
    steps (one all-gather), so that each chain's sum has the unsharded
    bits. Returns
    :class:`PFResult`, or with ``final=True`` (result, the final
    particles, their log weights)."""
    ssm = hooks.ssm
    guided = check_filter_hooks(ssm, auxiliary)
    logn = math.log(float(n))
    lead = hooks.lead
    hgen = hook_gen
    if hgen is None:
        hgen = gen if shard is None else hook_generator(shard[0], gen)
    x = hooks.init_sample(hgen, n if shard is None
                          else shard[1].stop - shard[1].start)
    dt, dev = x.dtype, x.device
    ys = ys.to(dev, dt)

    layout = None if shard is None else shard[0]

    def mine(idx):
        """The rank's particles' entries of an index over the cloud."""
        return idx if shard is None else idx[..., shard[1]]

    def propagate(x_r, y, t):
        if not guided:
            xn = hooks.trans_sample(hgen, x_r, t)
            return xn, hooks.obs_logpdf(y, xn, t)
        xn = hooks.prop_sample(hgen, x_r, y, t)
        return xn, (hooks.obs_logpdf(y, xn, t)
                    + hooks.trans_logpdf(xn, x_r, t)
                    - hooks.prop_logpdf(xn, x_r, y, t))

    def lookahead(y, x_, t):
        if ssm.lookahead_logpdf is not None:
            return hooks.lookahead_logpdf(y, x_, t)
        return hooks.obs_logpdf(y, hooks.trans_mean(x_, t), t)

    ll0 = hooks.obs_logpdf(ys[0], x, 0)
    x, ll0 = gathered(layout, x, ll0)
    norm0 = _lse(ll0)
    incr0 = norm0 - logn
    lw = ll0 - norm0[..., None]
    ess = ess_from_log_weights(lw)
    means, esss, parts, lws, incrs = [], [ess], [x], [lw], []
    if stats:
        means.append(weighted_mean(lw, x))
    for t in range(1, ys.shape[0]):
        y = ys[t]
        if resample_u is not None:
            u0 = resample_u[t - 1]
        elif chains is None:
            u0 = torch.rand(lead, generator=gen, dtype=dt, device=dev)
        else:
            u0 = torch.rand((chains[2],), generator=gen, dtype=dt,
                            device=dev)[chains[1]]
        if auxiliary:
            lam = lookahead(y, x, t)
            first = lw + lam
            norm1 = _lse(first)
            idx = mine(systematic_resample(u0, first, n))
            xn, ll = propagate(gather_rows(x, idx), y, t)
            xn, second = gathered(layout, xn,
                                  ll - torch.take_along_dim(lam, idx, -1))
            norm2 = _lse(second)
            incrs.append(norm1 + norm2 - logn)
            x, lw = xn, second - norm2[..., None]
        else:
            # the ESS of the weights in hand: the previous step's
            x, lw, incr = bootstrap_step(hgen, hooks, x, lw, ess, y, t, n,
                                         ess_frac, u0, propagate, shard)
            incrs.append(incr)
        if stats or not auxiliary:
            ess = ess_from_log_weights(lw)
        if stats:
            means.append(weighted_mean(lw, x))
            esss.append(ess)
        if return_particles:
            parts.append(x)
            lws.append(lw)
    loglik = incr0
    if incrs:
        steps = torch.stack(incrs)
        if chains is not None:
            # every chain's increments: a column sum's bits depend on how
            # many columns it has (on the CPU)
            steps = chains[0].gather(steps, 1)
        total = torch.sum(steps, 0)
        loglik = incr0 + (total if chains is None else total[chains[1]])
    k = len(lead)
    result = PFResult(
        loglik.to(dt), torch.stack(means, k) if stats else None,
        torch.stack(esss, k) if stats else None,
        torch.stack(parts, k) if return_particles else None,
        torch.stack(lws, k) if return_particles else None)
    return (result, x, lw) if final else result


def bootstrap_step(gen, hooks, x, lw, ess, y, t, n, ess_frac, u0,
                   propagate=None, shard=None):
    """One bootstrap step on ``hooks.lead`` rows: resample where the ESS of
    ``lw`` is below ``ess_frac * n`` (a device ``where``), propagate,
    weight. Returns (x', normalized lw', log-increment). ``shard``:
    ``(layout, rows)`` of a particle-sharded filter, whose ``x`` and ``lw``
    are the whole cloud's: the rank propagates its rows, and one all-gather
    returns the whole cloud with its increments."""
    logn = math.log(float(n))
    do_rs = (ess < ess_frac * n)[..., None]
    idx = torch.where(do_rs, systematic_resample(u0, lw, n),
                      torch.arange(n, device=lw.device))
    lw = torch.where(do_rs, torch.full_like(lw, -logn), lw)
    x_r = gather_rows(x, idx if shard is None else idx[..., shard[1]])
    if propagate is None:
        xn = hooks.trans_sample(gen, x_r, t)
        ll = hooks.obs_logpdf(y, xn, t)
    else:
        xn, ll = propagate(x_r, y, t)
    if shard is not None:
        xn, ll = gathered(shard[0], xn, ll)
    incr = _lse(lw + ll)
    return xn, lw + ll - incr[..., None], incr


def particle_filter(gen, ssm, theta, ys, n_particles, ess_frac=0.5,
                    auxiliary=False, return_particles=False, mesh=None,
                    resample_u=None, device=None):
    """Bootstrap particle filter with adaptive systematic resampling, or
    (``auxiliary=True``) the auxiliary particle filter, or (with
    ``ssm.prop_sample``) the guided filter.

    gen: a ``torch.Generator`` (the filter runs on its device) or an int
    seed for a generator on ``device``. ys: (T, E) ((T,) promoted).
    Resampling triggers when ESS < ``ess_frac * n_particles``; the auxiliary
    filter resamples every step from lookahead-tilted weights. Returns
    :class:`PFResult`; ``loglik`` is unbiased in exp (Del Moral 2004) and
    differentiable in ``theta`` except through the resampling indices.
    ``resample_u``: the (T−1,) resampling uniforms, for a replay.
    ``mesh``: a ``WalkerLayout`` splitting the particles over the ranks
    (the module docstring); every rank returns the whole result."""
    gen, shard = filter_shard(mesh, gen, device, n_particles)
    return run_filter(gen, Hooks(ssm, theta), as_series(ys),
                      int(n_particles), ess_frac, auxiliary,
                      return_particles, resample_u, shard=shard)


class SmootherResult(NamedTuple):
    trajectories: torch.Tensor    # (J, T, D) joint smoothing draws
    smoothed_means: torch.Tensor  # (T, D) pooled E[x_t | y_{1:T}]
    loglik: torch.Tensor          # from the forward filter


def particle_smoother(gen, ssm, theta, ys, n_particles, n_draws,
                      ess_frac=0.5, auxiliary=False, mesh=None, gumbel=None,
                      device=None):
    """Forward-filter backward-simulation smoother (Godsill, Doucet & West
    2004): ``n_draws`` joint draws from p(x_{1:T} | y_{1:T}, θ). Needs
    ``ssm.trans_logpdf``; each backward step reweights the stored cloud by a
    (J, N) ``trans_logpdf`` block and draws all J paths at once.
    ``gumbel(i)``: the (J, N) Gumbel noise of step i's draw, asked for
    i = T−1, then T−2 … 0 (drawn from ``gen`` when None). ``mesh``: the
    forward filter's particles split over the ranks; the backward pass
    runs on the gathered clouds, and every rank returns every draw."""
    if ssm.trans_logpdf is None:
        raise ValueError("particle_smoother needs ssm.trans_logpdf")
    gen, shard = filter_shard(mesh, gen, device, n_particles)
    j_n = int(n_draws)
    res = run_filter(gen, Hooks(ssm, theta), as_series(ys), int(n_particles),
                     ess_frac, auxiliary, return_particles=True,
                     shard=shard)
    xs, lws = res.particles, res.log_weights           # (T, N, D), (T, N)
    t_n, n = lws.shape
    if gumbel is None:
        gumbel = lambda i: draw_gumbel(gen, (j_n, n), lws.dtype,  # noqa: E731
                                       lws.device)
    b = torch.argmax(gumbel(t_n - 1) + lws[-1], -1)
    x_next = xs[-1][b]                                  # (J, D)
    traj = [x_next]
    for t in range(t_n - 2, -1, -1):
        x_t = xs[t]
        lp = torch.func.vmap(lambda xn, x_=x_t, t_=t: ssm.trans_logpdf(
            xn.expand(x_.shape), x_, t_ + 1, theta))(x_next)   # (J, N)
        b = torch.argmax(gumbel(t) + lws[t] + lp, -1)
        x_next = x_t[b]
        traj.append(x_next)
    traj = torch.stack(traj[::-1], 1)                   # (J, T, D)
    return SmootherResult(traj, torch.mean(traj, 0), res.loglik)


def particle_forecast(gen, ssm, theta, particles, log_weights, t0, horizon,
                      obs_sample=None, mesh=None, resample_u=None,
                      device=None):
    """k-step-ahead predictive simulation from a filter's final cloud: one
    systematic resample to equal weights, then ``horizon`` steps of
    ``trans_sample``. ``obs_sample(gen, x, t, theta) -> (n, E)`` adds
    predictive observation draws. Returns ``(x_paths (H, N, D), y_draws
    (H, N, E) | None)``. ``mesh``: every rank passes the whole cloud,
    resamples it alike and propagates (and returns) its rows of it."""
    particles = torch.as_tensor(particles)
    gen, shard = filter_shard(mesh, gen, device, particles.shape[0])
    log_weights = torch.as_tensor(log_weights, device=particles.device)
    n = particles.shape[0]
    u0 = (resample_u if resample_u is not None else torch.rand(
        (), generator=gen, dtype=log_weights.dtype, device=particles.device))
    idx = systematic_resample(u0, log_weights, n)
    if shard is not None:
        idx = idx[shard[1]]
    hgen = hook_generator(mesh, gen)
    x = particles[idx]
    xs, ys = [], []
    for t in range(int(t0), int(t0) + int(horizon)):
        x = ssm.trans_sample(hgen, x, t, theta)
        xs.append(x)
        if obs_sample is not None:
            ys.append(obs_sample(hgen, x, t, theta))
    return torch.stack(xs), (torch.stack(ys) if obs_sample is not None
                             else None)


class PMMHState(NamedTuple):
    position: torch.Tensor   # (C, P) theta
    loglik: torch.Tensor     # (C,) carried PF estimate (pseudo-marginal)
    logprior: torch.Tensor   # (C,)
    accepted: torch.Tensor   # (C,) int32


class PMMHSampler:
    """Particle marginal Metropolis–Hastings (Andrieu, Doucet & Holenstein
    2010): Gaussian random-walk MH on a flat ``(P,)`` θ whose likelihood is
    the particle filter's estimate, C chains whose filters run as one
    ``(C, N, D)`` batch (≙ ``mcmcpp_tpu/particle.py::PMMHSampler``).

    ssm hooks read θ as the flat ``(P,)`` vector (vmapped over the chains),
    or with ``batched=True`` take θ (C, P) and particles (C, N, D).
    ``log_prior`` (P,) -> scalar (or batched (C, P) -> (C,)).
    ``loglik_fn``: optional ``(gen, theta) -> scalar`` override of the
    estimator (``ssm=None, ys=None``; vmapped with ``randomness=
    "different"`` unless batched), e.g. an RBPF or the exact
    ``lgss_loglik``. ``max_chunk_steps`` caps the stored steps a host fetch
    waits for. A step makes no host sync. ``device`` defaults to "cuda".
    ``mesh``: a ``WalkerLayout`` splitting the chains over the ranks of a
    process group (the module docstring), on the layout's device.
    """

    def __init__(self, ssm, ys, log_prior, n_params, n_particles=256,
                 proposal_scale=0.1, n_chains=16, seed=0, ess_frac=0.5,
                 dtype=torch.float32, max_chain_bytes=2 << 30, mesh=None,
                 chain=None, max_chunk_steps=128, loglik_fn=None,
                 auxiliary=False, batched=False, device=None):
        if loglik_fn is None and ssm is None:
            raise ValueError("need either an ssm or a loglik_fn")
        self.mesh = mesh
        self._rows = own_rows(mesh, int(n_chains), "n_chains")
        self._n_local = self._rows.stop - self._rows.start
        self.device = _engine_device(mesh, device)
        self._loglik_fn = loglik_fn
        self.auxiliary = bool(auxiliary)
        self.batched = bool(batched)
        self.ssm = ssm
        self.ys = None if ys is None else as_series(ys).to(self.device)
        self.log_prior = log_prior
        self._log_prior = per_chain(log_prior, batched)
        self.n_params = int(n_params)
        self.n_particles = int(n_particles)
        self.dtype = dtype
        self.proposal_scale = torch.as_tensor(
            proposal_scale, dtype=dtype, device=self.device).expand(
            (self.n_params,))
        self._prop_chol = torch.diag(self.proposal_scale)
        self.n_chains = int(n_chains)
        self.ess_frac = float(ess_frac)
        self.max_chunk_steps = (None if max_chunk_steps is None
                                else max(1, int(max_chunk_steps)))
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        # the filters' generators (rule (b) of parallel/mesh.py): the step
        # and auxiliary generators themselves unsharded or in a group of one
        self._filter_gen = hook_generator(mesh, self._step_gen)
        self._init_filter_gen = hook_generator(mesh, self._aux_gen)
        self.state = None
        self._n_steps_done = 0
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (self._n_local,
                                                     self.n_params):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(n_walkers=self._n_local,
                               n_params=self.n_params,
                               max_bytes=max_chain_bytes,
                               dtype=row_dtype(dtype))

    def _pf_loglik(self, gen, hook_gen, theta, resample_u=None):
        """(C,) likelihood estimates at θ (C, P), one filter a chain (the
        rank's chains when sharded): the filters' resampling uniforms from
        ``gen`` (every chain's, cut to the rank's), the hooks' and
        ``loglik_fn``'s draws from ``hook_gen``."""
        if self._loglik_fn is not None:
            if self.batched:
                return self._loglik_fn(hook_gen, theta)
            return torch.func.vmap(lambda th: self._loglik_fn(hook_gen, th),
                                   randomness="different")(theta)
        hooks = Hooks(self.ssm, theta, (theta.shape[0],), self.batched)
        return run_filter(
            gen, hooks, self.ys, self.n_particles, self.ess_frac,
            self.auxiliary, resample_u=resample_u, stats=False,
            hook_gen=hook_gen, chains=None if self.mesh is None
            else (self.mesh, self._rows, self.n_chains)).loglik

    def _whole(self, x):
        """Every chain's rows of the rank's ``x`` (``x`` unsharded)."""
        return gathered(self.mesh, x)[0]

    @torch.no_grad()
    def init(self, positions, seed=None):
        """positions: (C, P) initial θ (or (P,) broadcast); the initial
        estimates are drawn here (one filter a chain). A sharded sampler
        keeps its rows."""
        positions = torch.as_tensor(positions, dtype=self.dtype,
                                    device=self.device)
        if positions.ndim == 1:
            positions = positions[None, :].expand(self.n_chains,
                                                  self.n_params)
        if tuple(positions.shape) != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})")
        positions = positions[self._rows].contiguous()
        if seed is None:
            gen, hook_gen = self._aux_gen, self._init_filter_gen
        else:
            gen = make_generator(seed, AUX_STREAM, self.device)
            hook_gen = hook_generator(self.mesh, gen)
        lls = self._pf_loglik(gen, hook_gen, positions).to(self.dtype)
        self.state = PMMHState(
            positions, lls, self._log_prior(positions).to(self.dtype),
            torch.zeros((self._n_local,), dtype=torch.int32,
                        device=self.device))
        self._n_steps_done = 0
        return self

    @torch.no_grad()
    def step(self, state, prop_chol, z=None, u=None, resample_u=None):
        """One transition of the whole (C, P) batch (of the rank's chains
        when sharded). ``z`` (C, P) normals, ``u`` (C,) uniforms and
        ``resample_u`` (T−1, C) replace the drawn proposal, accept and
        resampling draws (a replay; every chain's, when sharded)."""
        gen, c, rows = self._step_gen, self.n_chains, self._rows
        if z is None:
            z = torch.randn((c, self.n_params), generator=gen,
                            dtype=self.dtype, device=self.device)
        # the whole (C, P) product, then the rank's rows: a small product's
        # rows can depend on how many it has
        prop = state.position + (z @ prop_chol.mT)[rows]
        lp_new = self._log_prior(prop).to(self.dtype)
        ll_new = self._pf_loglik(
            gen, self._filter_gen, prop,
            None if resample_u is None else resample_u[:, rows]).to(
            self.dtype)
        log_acc = (lp_new + ll_new) - (state.logprior + state.loglik)
        if u is None:
            u = torch.clamp(torch.rand((c,), generator=gen, dtype=self.dtype,
                                       device=self.device), min=1e-37)
        u = u[rows]
        ok = (torch.log(u) < log_acc) & torch.isfinite(lp_new) \
            & torch.isfinite(ll_new)
        return PMMHState(
            torch.where(ok[:, None], prop, state.position),
            torch.where(ok, ll_new, state.loglik),
            torch.where(ok, lp_new, state.logprior),
            state.accepted + ok.to(torch.int32))

    def _advance(self, n, prop_chol):
        state = self.state
        for _ in range(n):
            state = self.step(state, prop_chol)
        self.state = state

    def _run_chunk(self, take, thin):
        pos = torch.empty((take, self._n_local, self.n_params),
                          dtype=self.dtype, device=self.device)
        lps = torch.empty((take, self._n_local), dtype=self.dtype,
                          device=self.device)
        for s in range(take):
            self._advance(thin, self._prop_chol)
            pos[s] = self.state.position
            lps[s] = self.state.logprior + self.state.loglik
        return pos, lps

    def run(self, n_steps, thin=1):
        """Store every thin-th θ; the stored logp column is ``log_prior +
        loglik_hat``. Leftover ``n_steps % thin`` transitions advance
        unstored. Returns False on the chain's byte cap (EndOfChain)."""
        if self.state is None:
            raise RuntimeError("call init first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        chunk = default_chunk_steps(self._n_local, self.n_params,
                                    row_dtype(self.dtype))
        if self.max_chunk_steps is not None:
            chunk = min(chunk, self.max_chunk_steps)
        ok = run_pipelined(n_store, chunk,
                           lambda take: self._run_chunk(take, thin),
                           lambda rows: self.chain.append(*rows))
        self._n_steps_done += n_store * thin
        if ok and leftover:
            self._advance(leftover, self._prop_chol)
            self._n_steps_done += leftover
        return ok

    def tune(self, n_steps=300, window=50, target_accept=0.234,
             adapt_cov=True, jitter=1e-6):
        """Adapt the random-walk proposal before sampling: ``window``-step
        spans, the global scale moved by Robbins–Monro toward
        ``target_accept``, and with ``adapt_cov`` the shape re-estimated from
        the cross-chain spread scaled by 2.38²/P once the chains have
        spread. Two host reads a span (sharded, each after a gather of every
        chain's counts or positions, so every rank adapts alike).
        Acceptance counters reset afterwards. Returns self."""
        if self.state is None:
            raise RuntimeError("call init first")
        window = max(1, int(window))
        n_spans = max(1, int(n_steps) // window)
        log_s = 0.0
        base = self._prop_chol
        for i in range(n_spans):
            acc0 = int(self._whole(self.state.accepted).sum())
            self._advance(window, math.exp(log_s) * base)
            acc = (int(self._whole(self.state.accepted).sum()) - acc0) / (
                window * self.n_chains)
            log_s += (1.0 / np.sqrt(i + 1.0)) * (acc - target_accept)
            if adapt_cov and self.n_chains > self.n_params:
                pos = self._whole(self.state.position).cpu().numpy().astype(
                    np.float64)
                cov = np.cov(pos.T).reshape(self.n_params, self.n_params)
                # adopt the cross-chain shape only once the chains have
                # spread (identical inits and a rejected first window give
                # cov ~ 0, which would collapse the proposal)
                if (np.isfinite(cov).all()
                        and np.trace(cov) > self.n_params * jitter * 100.0):
                    cov = (2.38 ** 2 / self.n_params) * cov \
                        + jitter * np.eye(self.n_params)
                    base = torch.as_tensor(np.linalg.cholesky(cov),
                                           dtype=self.dtype,
                                           device=self.device)
        self._prop_chol = math.exp(log_s) * base
        self.state = self.state._replace(accepted=torch.zeros_like(
            self.state.accepted))
        self._n_steps_done = 0
        return self

    @property
    def acceptance_fraction(self):
        """(C,) per-chain accept fraction since init (or tune); every
        chain's on every rank when sharded (one all-gather)."""
        if self.state is None or self._n_steps_done == 0:
            return np.zeros((self.n_chains,))
        return (self._whole(self.state.accepted).cpu().numpy()
                / self._n_steps_done)

    def get_samples(self, burn_in=0, thin=1, flat=False):
        """The stored θ (the rank's chains when sharded)."""
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)


class ParticleGibbsKernel:
    """Blocked-Gibbs kernel resampling a latent trajectory x_{1:T} by
    conditional SMC with ancestor sampling (PGAS, Lindsten, Jordan & Schön
    2014; invariant for any ``n_particles`` ≥ 2). Declare the trajectory as
    a flat ``(T*D,)`` block, like :class:`~mcmcpp_tpu_torch.models.lgss.
    LGSSKernel`. All chains' conditional filters run as one batch.

    theta_fn: a pytree, or a per-chain callable ``others -> theta``
    (vmapped unless ``batched=True``). ``ancestor_sampling`` needs
    ``ssm.trans_logpdf``. Noise: ``(gen, gumbel)``: the hooks draw from
    ``gen``, the categorical draws take ``gumbel(shape)`` noise, asked for
    in order: a step's ancestors (C, N, N), then its reference ancestor
    (C, N), and last the output index (C, N)."""

    def __init__(self, ssm, ys, n_particles=64, theta_fn=None,
                 ancestor_sampling=True, batched=False):
        self.ssm = ssm
        self.ys = as_series(ys)
        self.n = int(n_particles)
        if self.n < 2:
            raise ValueError("PGAS needs n_particles >= 2")
        self._theta = theta_fn
        self.batched = bool(batched)
        self.ancestor_sampling = bool(ancestor_sampling)
        if ancestor_sampling and ssm.trans_logpdf is None:
            raise ValueError(
                "ancestor_sampling=True needs ssm.trans_logpdf; pass "
                "ancestor_sampling=False for plain conditional SMC")

    def draw_noise(self, gen, x, others):
        return gen, lambda shape: draw_gumbel(gen, shape, x.dtype, x.device)

    def apply(self, noise, x, others):
        gen, gumbel = noise
        c, n = x.shape[0], self.n
        if callable(self._theta):
            theta, theta_dim = per_chain(self._theta, self.batched)(
                others), 0
        else:
            theta, theta_dim = self._theta, None
        hooks = Hooks(self.ssm, theta, (c,), self.batched, theta_dim)
        ys = self.ys.to(x.device, x.dtype)
        t_n = ys.shape[0]
        x_ref = x.reshape(c, t_n, -1)
        # t = 0: free particles from the initial law, the reference in slot
        # n-1, weights the observation densities
        xp = hooks.init_sample(gen, n).to(x.dtype)
        xp = torch.cat([xp[:, :n - 1], x_ref[:, None, 0]], 1)
        lw = hooks.obs_logpdf(ys[0], xp, 0)
        lw = lw - _lse(lw)[:, None]
        xs, ancs = [xp], []
        for t in range(1, t_n):
            xr = x_ref[:, None, t]
            # multinomial ancestors for the free particles
            anc = torch.argmax(gumbel((c, n, n)) + lw[:, None, :], -1)
            if self.ancestor_sampling:
                # the reference slot: weights tilted by the transition to it
                as_logits = lw + hooks.trans_logpdf(xr.expand(xp.shape), xp,
                                                    t)
                a_ref = torch.argmax(gumbel((c, n)) + as_logits, -1)
            else:
                a_ref = torch.full((c,), n - 1, device=x.device)
            anc = torch.cat([anc[:, :n - 1], a_ref[:, None]], 1)
            xnew = hooks.trans_sample(gen, gather_rows(xp, anc), t).to(
                x.dtype)
            xp = torch.cat([xnew[:, :n - 1], xr], 1)
            lw = hooks.obs_logpdf(ys[t], xp, t)
            lw = lw - _lse(lw)[:, None]
            xs.append(xp)
            ancs.append(anc)
        # the output path: an index at T-1, then the ancestry traced back
        b = torch.argmax(gumbel((c, n)) + lw, -1)
        idx = [b]
        for anc in reversed(ancs):
            b = torch.gather(anc, 1, b[:, None])[:, 0]
            idx.append(b)
        idx = torch.stack(idx[::-1], 1)                     # (C, T)
        traj = torch.take_along_dim(torch.stack(xs, 1),
                                    idx[:, :, None, None], 2)[:, :, 0]
        return traj.reshape(c, -1).to(x.dtype)
