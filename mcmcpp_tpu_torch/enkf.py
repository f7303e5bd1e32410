"""Ensemble Kalman filter: the stochastic EnKF with perturbed observations
and the deterministic ensemble-transform (ETKF) analysis.

PyTorch counterpart of ``mcmcpp_tpu/enkf.py`` (Evensen 1994; Burgers, van
Leeuwen & Evensen 1998; Bishop et al. 2001, Hunt et al. 2007). The ensemble
is propagated through any nonlinear forecast model, and the analysis is a
linear Kalman update built from ensemble anomaly products (the (D, D) state
covariance is never formed: only (D, E) and (E, E) products). A time step
is the forecast hook plus a handful of matmuls, one (E, E) Cholesky and, for
the ETKF, one (N, N) ``eigh``; a Python loop over T, no host sync.

The ETKF's ``eigh`` returns eigenvectors whose signs are arbitrary (they
differ between packages and devices); the transform built from them is
not. Hooks take a ``torch.Generator`` where JAX's take a key; ``obs_noise``
hands a replay the stochastic analysis's normals.

``mesh=`` (a ``WalkerLayout``) splits the members over the ranks. The
forecast, the expensive part, is local: ``init_sample`` and
``trans_sample`` draw the rank's members from :func:`~mcmcpp_tpu_torch.
parallel.mesh.hook_generator`'s generator (the caller's in a group of one,
so the run equals the unsharded one bit for bit; a rank's fork over more
ranks, another equally valid draw). One all-gather a step brings every rank
the whole forecast ensemble, and the analysis (the observation operator,
the anomaly products, the Cholesky, the ETKF's ``eigh``, the perturbation
normals drawn whole) runs on the whole ensemble on every rank as
unsharded: a few small matmuls a step, next to which a second collective
would cost more. Each rank forecasts its rows of the analysis ensemble; the
result is the whole ensemble's on every rank.
"""

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.models.lgss import nan_cholesky
from mcmcpp_tpu_torch.parallel.mesh import gathered, hook_generator, own_rows
from mcmcpp_tpu_torch.particle import as_generator, as_series

__all__ = ["EnKFModel", "EnKFResult", "ensemble_kalman_filter"]


class EnKFModel(NamedTuple):
    """Forecast/observation spec, hooks vectorized over the ensemble axis:

    init_sample(gen, n) -> (n, D)      the initial ensemble
    trans_sample(gen, x, t) -> (n, D)  the forecast model, with its noise
    obs_fn(x, t) -> (n, E)             the observation operator H(x)
    obs_cov: (E, E) observation-noise covariance R
    """

    init_sample: Callable
    trans_sample: Callable
    obs_fn: Callable
    obs_cov: torch.Tensor


class EnKFResult(NamedTuple):
    loglik: torch.Tensor    # Σ_t log N(y_t; ŷ_t, S_t), the Gaussian proxy
    means: torch.Tensor     # (T, D) analysis-ensemble means
    spread: torch.Tensor    # (T, D) analysis-ensemble standard deviations
    ensemble: torch.Tensor  # (N, D) final analysis ensemble


def _tri_solve(fac, b):
    return torch.linalg.solve_triangular(fac, b, upper=False)


def ensemble_kalman_filter(gen, model, ys, n_ensemble, inflation=1.0,
                           mesh=None, variant="stochastic", obs_noise=None,
                           device=None):
    """EnKF over ``ys`` ((T, E); (T,) promoted). ``inflation`` multiplies
    the forecast anomalies; ``variant="etkf"`` is the square-root analysis
    (its analysis covariance matched exactly, one (N, N) ``eigh`` a step).
    ``loglik`` accumulates log N(y_t; mean(H x), S_t), the exact marginal
    likelihood in the linear-Gaussian limit. ``gen``: a generator or an int
    seed for one on ``device``. ``obs_noise`` (T, N, E): the stochastic
    analysis's standard normals, for a replay. ``mesh``: a ``WalkerLayout``
    splitting the members over the ranks (the module docstring)."""
    n = int(n_ensemble)
    if n < 2:
        raise ValueError("EnKF needs n_ensemble >= 2")
    if variant not in ("stochastic", "etkf"):
        raise ValueError(f"unknown variant {variant!r}")
    rows = own_rows(mesh, n, "n_ensemble")
    gen = as_generator(gen, device, mesh)
    hgen = hook_generator(mesh, gen)
    # the whole ensemble from the rank's members (one all-gather)
    x, = gathered(mesh, model.init_sample(hgen, rows.stop - rows.start))
    dt, dev = x.dtype, x.device
    ys = as_series(ys).to(dev, dt)
    r_cov = torch.as_tensor(model.obs_cov, dtype=dt, device=dev)
    if r_cov.ndim == 0:
        r_cov = r_cov[None, None]
    e_dim = r_cov.shape[0]
    if tuple(r_cov.shape) != (e_dim, e_dim) or ys.shape[1] != e_dim:
        raise ValueError(f"obs_cov {tuple(r_cov.shape)} inconsistent with ys "
                         f"{tuple(ys.shape)}")
    r_chol = nan_cholesky(r_cov)
    # the reference holds the inflation in float32 (jnp.asarray(inflation,
    # float32)) whatever the ensemble's dtype; so does the port
    infl = float(np.float32(inflation))
    eye_n = torch.eye(n, dtype=dt, device=dev)
    half_log2pi = 0.5 * e_dim * math.log(2.0 * math.pi)

    def analysis(x, y, t):
        x_mean = torch.mean(x, 0)
        xa = (x - x_mean) * infl
        x = x_mean + xa
        yf = model.obs_fn(x, t)                       # (n, E)
        y_mean = torch.mean(yf, 0)
        ya = yf - y_mean
        pyy = ya.mT @ ya / (n - 1.0) + r_cov          # (E, E)
        pxy = xa.mT @ ya / (n - 1.0)                  # (D, E)
        chol = nan_cholesky(pyy)
        innov = y - y_mean
        v = _tri_solve(chol, innov[:, None])[:, 0]
        step_ll = (-0.5 * torch.sum(v * v)
                   - torch.sum(torch.log(torch.diagonal(chol))) - half_log2pi)
        if variant == "etkf":
            # ensemble-space transform: S = R^{-1/2} Yaᵀ
            s = _tri_solve(r_chol, ya.mT)               # (E, n)
            evals, evecs = torch.linalg.eigh((n - 1.0) * eye_n + s.mT @ s)
            evals = torch.clamp(evals, min=1e-8)
            a_inv = (evecs / evals) @ evecs.mT
            w_mean = a_inv @ (s.mT @ _tri_solve(r_chol, innov[:, None])[:, 0])
            w_sqrt = (evecs * torch.sqrt((n - 1.0) / evals)) @ evecs.mT
            return x_mean + (w_mean + w_sqrt) @ xa, step_ll
        # member-wise perturbed innovations: y + eps_i − H(x_i)
        z = (obs_noise[t] if obs_noise is not None
             else torch.randn((n, e_dim), generator=gen, dtype=dt,
                              device=dev))
        resid = (y + z @ r_chol.mT) - yf              # (n, E)
        gain_t = torch.cholesky_solve(pxy.mT, chol)   # (E, D)
        return x + resid @ gain_t, step_ll

    x, ll = analysis(x, ys[0], 0)
    lls = [ll]
    means, spreads = [torch.mean(x, 0)], [torch.std(x, 0, correction=0)]
    for t in range(1, ys.shape[0]):
        x, = gathered(mesh, model.trans_sample(hgen, x[rows], t))
        x, ll = analysis(x, ys[t], t)
        lls.append(ll)
        means.append(torch.mean(x, 0))
        spreads.append(torch.std(x, 0, correction=0))
    lls = torch.stack(lls)
    return EnKFResult(lls[0] + torch.sum(lls[1:]), torch.stack(means),
                      torch.stack(spreads), x)
