"""Rao-Blackwellised particle filtering (the mixture Kalman filter) for
conditionally linear-Gaussian state-space models.

PyTorch counterpart of ``mcmcpp_tpu/rbpf.py`` (Doucet, de Freitas, Murphy
& Russell 2000; Chen & Liu 2000). The latent splits into a nonlinear
(often discrete) z_t and a linear-Gaussian x_t,

    z_t ~ p(z_t | z_{t-1})
    x_t = A(z_t) x_{t-1} + b(z_t) + N(0, Q(z_t))
    y_t = H(z_t) x_t    + c(z_t) + N(0, R(z_t)),

and the particles live on z-paths only, each carrying exact Kalman moments
(m, P) of x; the weight increment is the exact predictive density. A time
step is N small Kalman updates batched over the particle axis ((N, D, D)
matmuls, one batched (N, E, E) Cholesky, solves against it), in a Python
loop over T with no host sync. The covariance update is the Joseph form.

Hooks take a ``torch.Generator`` where JAX's take a key; a z-particle set is
a tensor, or a tuple, list or dict of tensors with the particle axis first.
:func:`switching_model`'s regime draws are argmax(log p + Gumbel), as
``jax.random.categorical`` is.

``mesh=`` (a ``WalkerLayout``) splits the particles, z-paths with their
Kalman moments, over the ranks, as :func:`~mcmcpp_tpu_torch.particle.
particle_filter` does: the Kalman algebra of a rank's rows is local, and one
all-gather a step brings every rank the whole cloud (every z leaf, the
moments and the predictive log-likelihoods, mixed dtypes as bytes), on
which the weights, the resampling (its uniform drawn whole) and the mixture
moments are the unsharded code's; every rank returns the whole result. The
forecast resamples the whole cloud once, propagates the rank's rows and
gathers them once a step for the mixture moments. ``z_init_sample`` and
``z_trans_sample`` draw from :func:`~mcmcpp_tpu_torch.parallel.mesh.
hook_generator`'s generator: the caller's in a group of one (bit for bit
the unsharded run), a rank's fork over more ranks (another, equally valid
draw).
"""

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mcmcpp_tpu_torch.models.lgss import nan_cholesky
from mcmcpp_tpu_torch.ops.random import gumbel
from mcmcpp_tpu_torch.parallel.mesh import gathered, hook_generator
from mcmcpp_tpu_torch.particle import as_series, filter_shard
from mcmcpp_tpu_torch.sampler import resolve_device
from mcmcpp_tpu_torch.smc import ess_from_log_weights, systematic_resample

__all__ = ["RBPFResult", "RaoBlackwellSSM", "rao_blackwell_filter",
           "rbpf_forecast", "switching_model"]


class RaoBlackwellSSM(NamedTuple):
    """Conditionally linear-Gaussian SSM spec (hooks vectorized over the
    particle axis; ``t`` the step's Python int).

    z_init_sample(gen, n) -> (n, ...)        draw z_1
    z_trans_sample(gen, z, t) -> (n, ...)    draw z_t | z_{t-1}
    cond_params(z, t) -> (A, b, Q, H, c, R)  per-particle matrices (n,D,D),
        (n,D), (n,D,D), (n,E,D), (n,E), (n,E,E); A/b/Q govern the transition
        INTO step t (unused at t=0), H/c/R observe step t.
    m0 (D,), P0 (D,D): x_1 ~ N(m0, P0).
    z_stat_fn(z) -> (n, S), optional: filtered statistics of z, averaged
        with the weights (default: every leaf flattened side by side).
    """

    z_init_sample: Callable
    z_trans_sample: Callable
    cond_params: Callable
    m0: torch.Tensor
    P0: torch.Tensor
    z_stat_fn: Optional[Callable] = None


class RBPFResult(NamedTuple):
    loglik: torch.Tensor       # () log p_hat(y_{1:T}); unbiased in exp
    x_means: torch.Tensor      # (T, D) weighted filtered E[x_t | y_{1:t}]
    z_stats: torch.Tensor      # (T, S) weighted z_stat_fn averages
    ess: torch.Tensor          # (T,)
    final_z: Optional[object] = None
    final_means: Optional[torch.Tensor] = None   # (N, D)
    final_covs: Optional[torch.Tensor] = None    # (N, D, D)
    final_log_weights: Optional[torch.Tensor] = None  # (N,) normalized


def _tree_map(fn, z):
    if isinstance(z, dict):
        return {k: _tree_map(fn, v) for k, v in z.items()}
    if isinstance(z, (tuple, list)):
        return type(z)(_tree_map(fn, v) for v in z)
    return fn(z)


def _leaves(z):
    if isinstance(z, dict):
        return [leaf for k in z for leaf in _leaves(z[k])]
    if isinstance(z, (tuple, list)):
        return [leaf for v in z for leaf in _leaves(v)]
    return [z]


def _unflatten(z, leaves):
    """``z``'s tree with ``leaves`` (in :func:`_leaves` order) in place of
    its own."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), z)


def _whole_cloud(shard, z, *xs):
    """Every particle's z tree and ``xs`` from the rank's rows (one
    all-gather; the arguments themselves unsharded)."""
    if shard is None:
        return (z,) + xs
    leaves = _leaves(z)
    got = gathered(shard[0], *leaves, *xs)
    return (_unflatten(z, got[:len(leaves)]),) + got[len(leaves):]


def _zstat(model, n):
    return model.z_stat_fn or (lambda z: torch.cat(
        [leaf.to(torch.float32).reshape(n, -1) for leaf in _leaves(z)], 1))


def _kalman_observe(m, P, H, c, R, y):
    """Batched measurement update and exact predictive log-likelihood:
    m (n,D), P (n,D,D); H (n,E,D), c (n,E), R (n,E,E); y (E,). Returns
    (m', P', loglik (n,)), the covariance in Joseph form."""
    e = H.shape[-2]
    S = H @ P @ H.mT + R
    fac = nan_cholesky(S)
    innov = y - (H @ m[..., None])[..., 0] - c
    quad = torch.sum(innov * torch.cholesky_solve(innov[..., None], fac)[
        ..., 0], -1)
    loglik = (-0.5 * quad
              - torch.sum(torch.log(torch.diagonal(fac, dim1=-2, dim2=-1)),
                          -1)
              - 0.5 * e * np.log(2.0 * np.pi))
    gain = torch.cholesky_solve(H @ P, fac).mT           # (n, D, E)
    m_new = m + (gain @ innov[..., None])[..., 0]
    imkh = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device) - gain @ H
    p_new = imkh @ P @ imkh.mT + gain @ R @ gain.mT
    return m_new, p_new, loglik


def rao_blackwell_filter(gen, model, ys, n_particles, ess_frac=0.5,
                         mesh=None, resample_u=None, device=None):
    """Mixture Kalman filter with adaptive systematic resampling (when the
    z-path ESS < ``ess_frac * n_particles``). ``gen``: a generator or an int
    seed for one on ``device``; ``resample_u`` (T−1,): the resampling
    uniforms, for a replay. ``mesh``: a ``WalkerLayout`` splitting the
    particles over the ranks (the module docstring). Returns
    :class:`RBPFResult`."""
    n = int(n_particles)
    gen, shard = filter_shard(mesh, gen, device, n)
    hgen = hook_generator(mesh, gen)
    n_local = n if shard is None else shard[1].stop - shard[1].start
    logn = math.log(float(n))
    zstat = _zstat(model, n)
    z = model.z_init_sample(hgen, n_local)
    m0 = torch.as_tensor(model.m0)
    dt, dev = m0.dtype, m0.device
    ys = as_series(ys).to(dev, dt)
    m = m0[None].expand((n_local,) + tuple(m0.shape))
    p0 = torch.as_tensor(model.P0, dtype=dt, device=dev)
    p = p0[None].expand((n_local,) + tuple(p0.shape))
    _, _, _, h0, c0, r0 = model.cond_params(z, 0)
    m, p, ll = _kalman_observe(m, p, h0, c0, r0, ys[0])
    z, m, p, ll = _whole_cloud(shard, z, m, p, ll)
    norm = torch.logsumexp(ll, 0)
    lw = ll - norm
    incr0 = norm - logn
    ess = ess_from_log_weights(lw)
    w = torch.exp(lw)
    means, zs, esss, incrs = [w @ m], [w @ zstat(z).to(dt)], [ess], []
    arange = torch.arange(n, device=dev)
    full = torch.full((n,), -logn, dtype=dt, device=dev)
    for t in range(1, ys.shape[0]):
        u0 = (resample_u[t - 1] if resample_u is not None
              else torch.rand((), generator=gen, dtype=dt, device=dev))
        do_rs = ess < ess_frac * n
        idx = torch.where(do_rs, systematic_resample(u0, lw, n), arange)
        if shard is not None:
            idx = idx[shard[1]]  # the rank's particles' ancestors
        z = _tree_map(lambda a: a[idx], z)
        m, p = m[idx], p[idx]
        lw = torch.where(do_rs, full, lw)
        z = model.z_trans_sample(hgen, z, t)
        a_t, b_t, q_t, h_t, c_t, r_t = model.cond_params(z, t)
        m_pred = (a_t @ m[..., None])[..., 0] + b_t
        p_pred = a_t @ p @ a_t.mT + q_t
        m, p, ll = _kalman_observe(m_pred, p_pred, h_t, c_t, r_t, ys[t])
        z, m, p, ll = _whole_cloud(shard, z, m, p, ll)
        incr = torch.logsumexp(lw + ll, 0)
        lw = lw + ll - incr
        ess = ess_from_log_weights(lw)
        w = torch.exp(lw)
        incrs.append(incr)
        means.append(w @ m)
        zs.append(w @ zstat(z).to(dt))
        esss.append(ess)
    loglik = incr0 + torch.sum(torch.stack(incrs), 0) if incrs else incr0
    return RBPFResult(loglik.to(dt), torch.stack(means), torch.stack(zs),
                      torch.stack(esss), z, m, p, lw)


def rbpf_forecast(gen, model, z, means, covs, log_weights, t0, horizon,
                  mesh=None, resample_u=None, device=None):
    """k-step-ahead predictive moments from an RBPF cloud: one resample of
    (z, m, P) to equal weights, then per step z' ~ p(z'|z) and each
    particle's exact Kalman prediction through its regime's (A, b, Q).
    Returns ``(state_means (H, D), state_covs (H, D, D), z_stats (H, S))``,
    the covariance the full mixture covariance. ``mesh``: every rank
    passes the whole cloud and propagates its rows of it; the moments are
    the whole cloud's (one all-gather a step)."""
    means = torch.as_tensor(means)
    n = means.shape[0]
    gen, shard = filter_shard(mesh, gen, device, n)
    hgen = hook_generator(mesh, gen)
    zstat = _zstat(model, n)
    lw = torch.as_tensor(log_weights, device=means.device)
    u0 = (resample_u if resample_u is not None else torch.rand(
        (), generator=gen, dtype=lw.dtype, device=means.device))
    idx = systematic_resample(u0, lw, n)
    if shard is not None:
        idx = idx[shard[1]]
    z = _tree_map(lambda a: a[idx], z)
    m, p = means[idx], torch.as_tensor(covs, device=means.device)[idx]
    ms, cs, zs = [], [], []
    for t in range(int(t0), int(t0) + int(horizon)):
        z = model.z_trans_sample(hgen, z, t)
        a_t, b_t, q_t, _, _, _ = model.cond_params(z, t)
        m_own = (a_t @ m[..., None])[..., 0] + b_t
        p_own = a_t @ p @ a_t.mT + q_t
        z_own = z
        z, m, p = _whole_cloud(shard, z, m_own, p_own)
        mbar = torch.mean(m, 0)
        dev = m - mbar
        ms.append(mbar)
        cs.append(torch.mean(p, 0) + dev.mT @ dev / float(n))
        zs.append(torch.mean(zstat(z), 0))
        z, m, p = z_own, m_own, p_own
    return torch.stack(ms), torch.stack(cs), torch.stack(zs)


def switching_model(trans_probs, A, b, Q, H, c, R, m0, P0, init_probs=None,
                    dtype=torch.float32, device="cuda"):
    """The discrete-regime (mixture Kalman) case: z_t ∈ {0..K−1} follows a
    Markov chain with row-stochastic ``trans_probs`` (K, K), and every
    conditional matrix is the z-indexed slice of a stacked (K, ...) array.
    z_stats are the filtered regime probabilities (weighted one-hots)."""
    device = resolve_device(device)

    def t_(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    trans_probs = t_(trans_probs)
    k_n = trans_probs.shape[0]
    if tuple(trans_probs.shape) != (k_n, k_n):
        raise ValueError(f"trans_probs must be (K, K), got "
                         f"{tuple(trans_probs.shape)}")
    init = (torch.full((k_n,), 1.0 / k_n, dtype=dtype, device=device)
            if init_probs is None else t_(init_probs))
    log_init = torch.log(torch.clamp(init, min=1e-37))
    log_trans = torch.log(torch.clamp(trans_probs, min=1e-37))
    stacked = [t_(x) for x in (A, b, Q, H, c, R)]
    for name, x in zip("AbQHcR", stacked):
        if x.shape[0] != k_n:
            raise ValueError(f"{name} must stack K={k_n} regime slices on "
                             f"axis 0, got shape {tuple(x.shape)}")
    a_s, b_s, q_s, h_s, c_s, r_s = stacked

    def z_init_sample(gen, n):
        g = gumbel(gen, (n, k_n), dtype, device)
        return torch.argmax(g + log_init, -1)

    def z_trans_sample(gen, z, t):
        g = gumbel(gen, (z.shape[0], k_n), dtype, device)
        return torch.argmax(g + log_trans[z], -1)

    def cond_params(z, t):
        return a_s[z], b_s[z], q_s[z], h_s[z], c_s[z], r_s[z]

    return RaoBlackwellSSM(
        z_init_sample, z_trans_sample, cond_params, t_(m0), t_(P0),
        z_stat_fn=lambda z: (z[..., None] == torch.arange(
            k_n, device=z.device)).to(dtype))
