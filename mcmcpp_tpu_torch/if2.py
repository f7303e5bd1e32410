"""IF2 iterated filtering: maximum-likelihood θ for state-space models.

PyTorch counterpart of ``mcmcpp_tpu/if2.py`` (Ionides, Nguyen, Atchadé,
Stoev & King 2015): a particle filter on the augmented state (x, θ), every
particle carrying its own θ perturbed by a random walk whose scale cools
geometrically across data passes; joint resampling concentrates the θ-swarm
on the MLE. One pass is a Python loop over T (perturb θ → propagate →
weight → joint resample, all batched over the particles, no host sync);
the M cooling passes are a host loop.

Hook contract (as in the JAX package): θ varies per particle, so the hooks
receive ``theta`` as the full ``(N, P)`` batch aligned with the particle
axis of ``x`` (write ``theta[:, k]``), and a ``torch.Generator`` where
JAX's take a key.

``mesh=`` (a ``WalkerLayout``) splits the swarm over the ranks, as
:func:`~mcmcpp_tpu_torch.particle.particle_filter` splits its particles:
the initial swarm and every perturbation are drawn whole and cut (rule (a)
of :mod:`mcmcpp_tpu_torch.parallel.mesh`), the hooks propagate and weight
the rank's rows (drawing from :func:`~mcmcpp_tpu_torch.parallel.mesh.
hook_generator`'s generator, rule (b)), and one all-gather a step brings
every rank the whole swarm with its states and weights, on which the
weights, the joint resampling and, after each pass, the swarm's mean and
spread are the unsharded code's. Every rank returns the whole result; in a
group of one it is the unsharded run's bit for bit.
"""

import math
from typing import NamedTuple

import torch

from mcmcpp_tpu_torch.parallel.mesh import gathered, hook_generator
from mcmcpp_tpu_torch.particle import as_series, filter_shard
from mcmcpp_tpu_torch.smc import ess_from_log_weights, systematic_resample

__all__ = ["IF2Result", "if2"]


class IF2Result(NamedTuple):
    theta: torch.Tensor           # (P,) final estimate (final swarm mean)
    swarm: torch.Tensor           # (N, P) final θ-swarm
    theta_trace: torch.Tensor     # (M, P) per-pass swarm means
    theta_sd_trace: torch.Tensor  # (M, P) per-pass swarm sds
    loglik_trace: torch.Tensor    # (M,) PF loglik estimate per pass


def one_pass(gen, ssm, ys, swarm, sigma, ess_frac=1.0, noise=None,
             shard=None, hook_gen=None):
    """One data pass at perturbation scale ``sigma`` (P,): returns the
    equal-weight swarm after the final joint resample and the pass's log-
    likelihood estimate. ``noise``: the pass's draws for a replay,
    ``(perturb0 (N, P), resample_u (T−1,), perturb (T−1, N, P), u_last)``
    (the hooks' own draws come from their generator, ``hook_gen`` when
    given). ``shard``: ``(layout, rows)`` of a swarm split over the ranks
    (``swarm`` and the result the whole swarm)."""
    hgen = gen if hook_gen is None else hook_gen
    layout, rows = (None, slice(None)) if shard is None else shard
    n = swarm.shape[0]
    logn = math.log(float(n))
    dt, dev = swarm.dtype, swarm.device

    def normal(i):
        if noise is not None:
            return noise[0] if i is None else noise[2][i]
        return torch.randn(swarm.shape, generator=gen, dtype=dt, device=dev)

    def uniform(i):
        if noise is not None:
            return noise[1][i] if i is not None else noise[3]
        return torch.rand((), generator=gen, dtype=dt, device=dev)

    th = swarm[rows] + sigma * normal(None)[rows]
    x = ssm.init_sample(hgen, th.shape[0], th)
    ll0 = ssm.obs_logpdf(ys[0], x, 0, th)
    x, th, ll0 = gathered(layout, x, th, ll0)
    norm0 = torch.logsumexp(ll0, 0)
    incr0 = norm0 - logn
    lw = ll0 - norm0
    arange = torch.arange(n, device=dev)
    full = torch.full((n,), -logn, dtype=lw.dtype, device=dev)
    incrs = []
    for t in range(1, ys.shape[0]):
        u0 = uniform(t - 1)
        do_rs = ess_from_log_weights(lw) < ess_frac * n
        idx = torch.where(do_rs, systematic_resample(u0, lw, n),
                          arange)[rows]
        x, th = x[idx], th[idx]
        lw = torch.where(do_rs, full, lw)
        th = th + sigma * normal(t - 1)[rows]
        x = ssm.trans_sample(hgen, x, t, th)
        ll = ssm.obs_logpdf(ys[t], x, t, th)
        x, th, ll = gathered(layout, x, th, ll)
        incr = torch.logsumexp(lw + ll, 0)
        lw = lw + ll - incr
        incrs.append(incr)
    # the final joint resample: an equal-weight swarm for the next pass
    th = th[systematic_resample(uniform(None), lw, n)]
    loglik = incr0 + torch.sum(torch.stack(incrs), 0) if incrs else incr0
    return th, loglik


def if2(gen, ssm, ys, n_particles, theta0, sigma0, n_iters=30, cooling=0.9,
        ess_frac=1.0, mesh=None, device=None):
    """Run IF2; returns :class:`IF2Result`.

    gen: a ``torch.Generator`` or an int seed for one on ``device``.
    theta0 (P,): the swarm centre (the initial swarm is θ0 + σ0·ξ); sigma0:
    scalar or (P,) initial perturbation scale, σ_m = σ0·cooling^m on pass m;
    ess_frac: the resampling trigger (1.0: every step, the paper's form).
    ``mesh``: a ``WalkerLayout`` splitting the swarm over the ranks (the
    module docstring)."""
    gen, shard = filter_shard(mesh, gen, device, n_particles)
    hgen = hook_generator(mesh, gen)
    theta0 = torch.as_tensor(theta0, device=gen.device)
    if not theta0.is_floating_point():
        theta0 = theta0.to(torch.float32)
    ys = as_series(ys).to(gen.device, theta0.dtype)
    n, p = int(n_particles), theta0.shape[0]
    sigma0 = torch.as_tensor(sigma0, dtype=theta0.dtype,
                             device=gen.device).expand((p,))
    swarm = theta0 + sigma0 * torch.randn((n, p), generator=gen,
                                          dtype=theta0.dtype,
                                          device=gen.device)
    means, sds, logliks = [], [], []
    for m in range(int(n_iters)):
        sigma = sigma0 * (float(cooling) ** (m + 1))
        swarm, loglik = one_pass(gen, ssm, ys, swarm, sigma, ess_frac,
                                 shard=shard, hook_gen=hgen)
        means.append(torch.mean(swarm, 0))
        sds.append(torch.std(swarm, 0, correction=0))
        logliks.append(loglik)
    theta_trace = torch.stack(means)
    return IF2Result(theta=theta_trace[-1], swarm=swarm,
                     theta_trace=theta_trace,
                     theta_sd_trace=torch.stack(sds),
                     loglik_trace=torch.stack(logliks))
