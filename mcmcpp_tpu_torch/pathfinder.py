"""Pathfinder: quasi-Newton variational inference along an L-BFGS path.

PyTorch counterpart of ``mcmcpp_tpu/pathfinder.py`` (Zhang, Carpenter,
Gelman & Vehtari 2022): run L-BFGS on logp, build at every iterate a
Gaussian N(θ_l, Σ_l) from the L-BFGS inverse-Hessian estimate (densely, from
the m stored (s, y) pairs), pick the iterate with the best K-draw ELBO and
return draws with importance weights. ``multi_pathfinder`` pools M paths by
truncated importance resampling with a Hill tail-index diagnostic.

The JAX package vmaps a whole path over M paths; here the M paths are one
batch from the start: the two-loop recursion, the dense inverse Hessians and
the ELBO phase are batched tensor code, and a single path is a batch of one.
The Armijo line search (at most 16 halvings, each a logp evaluation) is
masked per path; the host tests "every path done" after each evaluation, so
an L-BFGS iteration reads the device once plus once per halving any path
still needs. The ELBO phase's draws come from the generator, or from
``noise=(z (M, K, P), z_draws (M, n_draws, P))``, which is how a test hands
the port the JAX package's.

Sharded (``mesh=`` of :func:`multi_pathfinder`, a ``WalkerLayout``), the M
paths split over the ranks (``n_paths`` divisible by their count). Every
rank draws every path's start and ELBO-phase draws and keeps its rows; the
paths are independent, so the L-BFGS loop and its line search run on the
rank's paths with no collective (the line search's "every path done" test
reads only the rank's paths: a path that is done ignores further halvings,
so the test's reach changes no path's result). One all-gather brings every
rank all paths' draws and log weights for the Hill tail index and the
importance resampling, which run as unsharded: the pooled draws are the
same on every rank and equal the unsharded run's bit for bit;
``result.paths`` holds the rank's paths. No hook draws noise here.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
from mcmcpp_tpu_torch.ops.random import (
    HOST_STREAM,
    STEP_STREAM,
    make_generator,
)
from mcmcpp_tpu_torch.parallel.mesh import _engine_device, gathered, \
    own_rows
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["MultiPathfinderResult", "PathfinderResult", "multi_pathfinder",
           "pathfinder"]

LS_MAX_HALVINGS = 16


class PathfinderResult(NamedTuple):
    draws: torch.Tensor  # (n_draws, P) from the ELBO-best approximation
    logw: torch.Tensor  # (n_draws,) logp − logq importance log-weights
    elbo_history: torch.Tensor  # (L,) per-iterate ELBO (−inf invalid)
    best_iter: torch.Tensor  # () int64
    mean: torch.Tensor  # (P,) center of the selected approximation
    path_logp: torch.Tensor  # (L,) logp along the optimization path


class MultiPathfinderResult(NamedTuple):
    draws: np.ndarray  # (n_draws, P) resampled across all paths
    pareto_k: float  # Hill tail-index diagnostic of the pooled weights
    paths: PathfinderResult  # per-path results (leading axis M; sharded,
    # the rank's paths)


def _dot(a, b):
    return torch.sum(a * b, -1)


def _gamma(s_buf, y_buf, valid):
    """The initial scaling sᵀy/yᵀy of the newest pair, 1 without one."""
    s, y = s_buf[..., -1, :], y_buf[..., -1, :]
    return torch.where(valid[..., -1],
                       _dot(s, y) / torch.clamp(_dot(y, y), min=1e-30), 1.0)


def _two_loop(g, s_buf, y_buf, valid, gamma):
    """L-BFGS two-loop recursion over (M, m, P) masked histories, oldest
    to newest: H·g for each of the M rows of ``g``."""
    m = s_buf.shape[-2]
    rho = 1.0 / torch.clamp(_dot(s_buf, y_buf), min=1e-30)
    vf = valid.to(g.dtype)
    q, alphas = g, [None] * m
    for j in reversed(range(m)):
        a = torch.where(valid[:, j], rho[:, j] * _dot(s_buf[:, j], q), 0.0)
        q = q - (a * vf[:, j])[:, None] * y_buf[:, j]
        alphas[j] = a
    r = gamma[:, None] * q
    for j in range(m):
        b = torch.where(valid[:, j], rho[:, j] * _dot(y_buf[:, j], r), 0.0)
        r = r + ((alphas[j] - b) * vf[:, j])[:, None] * s_buf[:, j]
    return r


def _inv_hessian_dense(s_buf, y_buf, valid, gamma):
    """Dense inverse-Hessian estimates (..., P, P): γI, then the BFGS
    inverse update for each stored pair, oldest to newest."""
    p = s_buf.shape[-1]
    eye = torch.eye(p, dtype=s_buf.dtype, device=s_buf.device)
    sigma = gamma[..., None, None] * eye
    for j in range(s_buf.shape[-2]):
        s, y = s_buf[..., j, :], y_buf[..., j, :]
        rho = 1.0 / torch.clamp(_dot(s, y), min=1e-30)
        v = eye - rho[..., None, None] * (s[..., :, None] * y[..., None, :])
        upd = (v @ sigma @ v.transpose(-1, -2)
               + rho[..., None, None] * (s[..., :, None] * s[..., None, :]))
        sigma = torch.where(valid[..., j, None, None], upd, sigma)
    return 0.5 * (sigma + sigma.transpose(-1, -2))


def _paths(logp, starts, maxiter, history, n_elbo_draws, n_draws, init_step,
           gen, noise, rows=None, n_all=None):
    """M Pathfinder paths from the (M, P) ``starts`` as one batch: the
    fields of :class:`PathfinderResult` with a leading M axis. ``rows``:
    when ``starts`` are some of ``n_all`` paths, their slice of every
    path's draws (and of ``noise``)."""
    mp, p = starts.shape
    m, dt, dev = int(history), starts.dtype, starts.device

    def val_grad(t):
        lp, g = logp_and_grad(logp, t)
        return -lp, -g

    theta = starts
    f, g = val_grad(theta)
    s_buf = torch.zeros((mp, m, p), dtype=dt, device=dev)
    y_buf = torch.zeros_like(s_buf)
    valid = torch.zeros((mp, m), dtype=torch.bool, device=dev)
    thetas, s_snaps, y_snaps, valids, path_logp = [], [], [], [], []
    for _ in range(int(maxiter)):
        d = -_two_loop(g, s_buf, y_buf, valid, _gamma(s_buf, y_buf, valid))
        slope = _dot(g, d)
        # not a descent direction (degenerate history): fall back to −g,
        # with the slope of the direction actually taken
        descent = slope < 0
        d = torch.where(descent[:, None], d, -g)
        slope = torch.where(descent, slope, -_dot(g, g))
        alpha = torch.full((mp,), float(init_step), dtype=dt, device=dev)
        with torch.no_grad():
            f_new = -logp(theta + alpha[:, None] * d)
        for _ in range(LS_MAX_HALVINGS):
            bad = torch.isnan(f_new) | (f_new > f + 1e-4 * alpha * slope)
            if not bool(bad.any()):
                break
            alpha = torch.where(bad, alpha * 0.5, alpha)
            with torch.no_grad():
                f_try = -logp(theta + alpha[:, None] * d)
            f_new = torch.where(bad, f_try, f_new)
        theta_new = theta + alpha[:, None] * d
        f_new, g_new = val_grad(theta_new)
        # reject a non-finite or non-improving step entirely
        ok = torch.isfinite(f_new) & (f_new <= f)
        theta_new = torch.where(ok[:, None], theta_new, theta)
        f_new = torch.where(ok, f_new, f)
        g_new = torch.where(ok[:, None], g_new, g)
        s, y = theta_new - theta, g_new - g
        keep = ok & (_dot(s, y) > 1e-12)  # curvature condition
        k3 = keep[:, None, None]
        s_buf = torch.where(k3, torch.cat([s_buf[:, 1:], s[:, None]], 1),
                            s_buf)
        y_buf = torch.where(k3, torch.cat([y_buf[:, 1:], y[:, None]], 1),
                            y_buf)
        valid = torch.where(keep[:, None], torch.cat(
            [valid[:, 1:], torch.ones_like(valid[:, :1])], 1), valid)
        theta, f, g = theta_new, f_new, g_new
        thetas.append(theta)
        s_snaps.append(s_buf)
        y_snaps.append(y_buf)
        valids.append(valid)
        path_logp.append(-f)
    thetas = torch.stack(thetas, 1)  # (M, L, P)
    s_snaps, y_snaps = torch.stack(s_snaps, 1), torch.stack(y_snaps, 1)
    valids = torch.stack(valids, 1)
    path_logp = torch.stack(path_logp, 1)

    # -- ELBO phase: one Gaussian approximation per iterate ------------------
    if noise is None:
        m_all = mp if rows is None else n_all
        z = torch.randn((m_all, int(n_elbo_draws), p), generator=gen,
                        dtype=dt, device=dev)
        zf = torch.randn((m_all, int(n_draws), p), generator=gen, dtype=dt,
                         device=dev)
    else:
        z, zf = (t.to(dev, dt) for t in noise)
    if rows is not None:
        z, zf = z[rows], zf[rows]
    const = 0.5 * p * np.log(2.0 * np.pi)
    eye = torch.eye(p, dtype=dt, device=dev)
    with torch.no_grad():
        sigma = _inv_hessian_dense(s_snaps, y_snaps, valids,
                                   _gamma(s_snaps, y_snaps, valids))
        chol, info = torch.linalg.cholesky_ex(sigma + 1e-8 * eye)
        bad = (info != 0) | torch.isnan(chol).any((-1, -2))
        chol = torch.where(bad[..., None, None], eye, chol)  # (M, L, P, P)
        x = thetas[:, :, None, :] + z[:, None] @ chol.transpose(-1, -2)
        log_det = torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                     dim2=-1)), -1)
        logq = -0.5 * torch.sum(z * z, -1)[:, None] - const - log_det[..., None]
        lp = logp(x.reshape(-1, p)).reshape(x.shape[:-1])
        elbos = torch.mean(lp - logq, -1)
        elbos = torch.where(bad | torch.isnan(elbos), -torch.inf, elbos)
        best = torch.argmax(elbos, 1)
        rows = torch.arange(mp, device=dev)
        mean, chol_b = thetas[rows, best], chol[rows, best]
        draws = mean[:, None, :] + zf @ chol_b.transpose(-1, -2)
        logq_f = (-0.5 * torch.sum(zf * zf, -1) - const
                  - torch.sum(torch.log(torch.diagonal(chol_b, dim1=-2,
                                                       dim2=-1)), -1)[:, None])
        logw = logp(draws.reshape(-1, p)).reshape(draws.shape[:-1]) - logq_f
    return PathfinderResult(draws, logw, elbos, best, mean,
                            path_logp.detach())


def _setup(logp_fn, batched, device):
    device = resolve_device(device)
    return (logp_fn if batched else torch.func.vmap(logp_fn)), device


def pathfinder(logp_fn, init, maxiter=60, history=6, n_elbo_draws=30,
               n_draws=400, seed=0, init_step=1.0, dtype=torch.float32,
               batched=False, device="cuda", noise=None):
    """Single-path Pathfinder from ``init`` (P,) (≙ the JAX function;
    ``fold`` is gone: M paths are one batch, see :func:`multi_pathfinder`).
    ``logp_fn``: (P,) -> scalar, or with ``batched=True`` (n, P) -> (n,).
    ``noise``: optional (z (K, P), z_draws (n_draws, P)). Returns
    :class:`PathfinderResult` (tensors on ``device``)."""
    logp, device = _setup(logp_fn, batched, device)
    init = torch.as_tensor(np.asarray(init) if not isinstance(
        init, torch.Tensor) else init).to(device, dtype)
    gen = make_generator(seed, STEP_STREAM, device)
    res = _paths(logp, init[None], maxiter, history, n_elbo_draws, n_draws,
                 init_step, gen,
                 None if noise is None else tuple(t[None] for t in noise))
    return PathfinderResult(*(t[0] for t in res))


def _hill_khat(logw, frac=0.2):
    """Hill estimator of the importance weights' tail index (> 0.7: the
    proposal is too light-tailed to trust the weights)."""
    lw = np.sort(np.asarray(logw, np.float64))
    mtail = max(int(frac * lw.size), 5)
    tail = lw[-mtail:]
    return float(np.mean(tail[1:] - tail[0])) if mtail > 1 else np.inf


def multi_pathfinder(logp_fn, n_paths, init, init_scale=2.0, n_draws=1000,
                     seed=0, maxiter=60, history=6, n_elbo_draws=30,
                     draws_per_path=400, dtype=torch.float32, batched=False,
                     mesh=None, device=None, noise=None):
    """M Pathfinder paths from dispersed starts, as one batch, pooled by
    truncated importance resampling (cap at mean·√n, Ionides 2008).

    ``init``: (P,) center (starts ``init + init_scale·N(0, I)``) or
    (M, P) starts. ``noise``: optional (z (M, K, P), z_draws (M, n_draws,
    P)). ``mesh``: a ``WalkerLayout`` splitting the paths over the ranks
    (every path's ``init`` and ``noise`` given on every rank). Returns
    :class:`MultiPathfinderResult`; check ``pareto_k``."""
    logp = logp_fn if batched else torch.func.vmap(logp_fn)
    rows = None if mesh is None else own_rows(mesh, int(n_paths),
                                              "n_paths")
    device = _engine_device(mesh, device)
    init = torch.as_tensor(np.asarray(init) if not isinstance(
        init, torch.Tensor) else init).to(device, dtype)
    gen = make_generator(seed, STEP_STREAM, device)
    if init.ndim == 1:
        starts = init[None, :] + init_scale * torch.randn(
            (int(n_paths), init.shape[0]), generator=gen, dtype=dtype,
            device=device)
    else:
        if init.shape[0] != n_paths:
            raise ValueError("explicit starts must be (n_paths, P)")
        starts = init
    if rows is not None:
        starts = starts[rows]
    paths = _paths(logp, starts, maxiter, history, n_elbo_draws,
                   draws_per_path, 1.0, gen, noise, rows, int(n_paths))
    draws, logw = gathered(mesh, paths.draws, paths.logw)
    pooled = draws.reshape(-1, starts.shape[1]).cpu().numpy()
    logw = logw.reshape(-1).cpu().numpy().astype(np.float64)
    khat = _hill_khat(logw)
    w = np.exp(logw - logw.max())
    w = np.minimum(w, w.mean() * np.sqrt(w.size))  # truncated IS
    w = w / w.sum()
    idx = torch.multinomial(torch.from_numpy(w), int(n_draws),
                            replacement=True,
                            generator=make_generator(seed, HOST_STREAM,
                                                     "cpu")).numpy()
    return MultiPathfinderResult(pooled[idx], khat, paths)
