"""Ensemble Kalman inversion (EKI) and the ensemble Kalman sampler (EKS).

PyTorch counterpart of ``mcmcpp_tpu/eks.py``: gradient-free inference for
``y = G(θ) + N(0, Γ)`` with a Gaussian prior ``θ ~ N(m0, C0)``, using only
forward evaluations of ``G``:

- :func:`ensemble_kalman_inversion` (Iglesias, Law & Stuart 2013), the
  adaptive-step iterative ensemble Kalman optimizer;
- :func:`ensemble_kalman_sampler` (Garbuno-Iñigo, Hoffmann, Li & Stuart
  2020), ensemble-preconditioned Langevin dynamics with the linearly
  implicit prior step and the finite-ensemble drift correction, whose
  invariant law is the posterior in the linear-G, J → ∞ limit.

An iteration is (J, E)/(J, P) matmuls and, for the EKS, one (J, J) normal
draw; a Python loop, no host sync. Hooks: ``forward`` maps (J, P) to
(J, E); randomness from a ``torch.Generator`` where JAX's takes a key, and
``noise`` hands a replay the draws.

A quirk of the reference, mirrored: ``_validate`` takes the ``forward`` map
and does not use it (``mcmcpp_tpu/eks.py:51``).

``mesh=`` (a ``WalkerLayout``) splits the ensemble's forward evaluations,
the expensive part, over the ranks: every rank holds the whole ensemble,
evaluates ``forward`` on its members, and one all-gather an iteration
brings every rank all of G(θ); the (J, J) interaction, the step and the
update (and the EKS's implicit prior step and noise, every draw made
whole) run on the whole ensemble on every rank as unsharded. No hook draws
noise, so a sharded run equals the unsharded one bit for bit on any number
of ranks (where ``forward``'s rows do not depend on how many it is
handed).
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.models.lgss import nan_cholesky, solve
from mcmcpp_tpu_torch.parallel.mesh import gathered, own_rows
from mcmcpp_tpu_torch.particle import as_generator

__all__ = ["EKIResult", "EKSResult", "ensemble_kalman_inversion",
           "ensemble_kalman_sampler"]


class EKIResult(NamedTuple):
    theta: torch.Tensor         # (P,) ensemble-mean estimate
    ensemble: torch.Tensor      # (J, P) final ensemble
    misfit_trace: torch.Tensor  # (n_iters,) mean data misfit per iteration


class EKSResult(NamedTuple):
    ensemble: torch.Tensor      # (J, P) posterior-approximating ensemble
    mean: torch.Tensor          # (P,)
    cov: torch.Tensor           # (P, P) ensemble covariance
    misfit_trace: torch.Tensor  # (n_iters,)


def _validate(forward, y, gamma, n_ensemble, device):
    y = torch.as_tensor(np.asarray(y) if not isinstance(
        y, torch.Tensor) else y, device=device)
    if not y.is_floating_point():
        y = y.to(torch.float32)
    if y.ndim != 1:
        raise ValueError("y must be a flat (E,) observation vector")
    gamma = torch.as_tensor(gamma, dtype=y.dtype, device=device)
    if gamma.ndim == 1:
        gamma = torch.diag(gamma)
    if tuple(gamma.shape) != (y.shape[0], y.shape[0]):
        raise ValueError("gamma must be (E, E) (or a (E,) diagonal)")
    if int(n_ensemble) < 3:
        raise ValueError("need n_ensemble >= 3")
    return y, gamma


def _prior(prior_mean, prior_cov, y):
    m0 = torch.as_tensor(prior_mean, dtype=y.dtype, device=y.device)
    c0 = torch.as_tensor(prior_cov, dtype=y.dtype, device=y.device)
    return m0, (torch.diag(c0) if c0.ndim == 1 else c0)


def _whiten(gamma_chol, r):
    """Γ^{-1/2} r, over rows."""
    return torch.linalg.solve_triangular(gamma_chol, r.mT, upper=False).mT


def ensemble_kalman_inversion(gen, forward, y, gamma, prior_mean, prior_cov,
                              n_ensemble=128, n_iters=30, dt0=1.0, mesh=None,
                              noise=None, device=None):
    """EKI: derivative-free MAP-style point estimation. ``forward`` (J, P)
    -> (J, E); ``y`` (E,), ``gamma`` (E, E) or (E,) diagonal; the initial
    ensemble is drawn from N(m0, C0); the step is ``dt0 / (‖D‖_F + 1e-8)``.
    ``noise`` (J, P): the initial ensemble's normals, for a replay.
    ``mesh``: a ``WalkerLayout`` splitting the forward evaluations over the
    ranks (the module docstring). Returns :class:`EKIResult`;
    ``misfit_trace`` should decrease."""
    rows = own_rows(mesh, int(n_ensemble), "n_ensemble")
    gen = as_generator(gen, device, mesh)
    y, gamma = _validate(forward, y, gamma, n_ensemble, gen.device)
    j_n = int(n_ensemble)
    m0, c0 = _prior(prior_mean, prior_cov, y)
    gamma_chol = nan_cholesky(gamma)
    z = noise if noise is not None else torch.randn(
        (j_n, m0.shape[0]), generator=gen, dtype=y.dtype, device=y.device)
    theta = m0 + z @ nan_cholesky(c0).mT
    misfits = []
    for _ in range(int(n_iters)):
        g, = gathered(mesh, forward(theta[rows]))   # (J, E), every member
        dg_w = _whiten(gamma_chol, g - torch.mean(g, 0))
        resid_w = _whiten(gamma_chol, g - y)
        # D[j, k] = <g_k − ḡ, Γ^{-1}(g_j − y)> / J, the interaction
        d_mat = resid_w @ dg_w.mT / j_n             # (J, J)
        dt = dt0 / (torch.linalg.norm(d_mat) + 1e-8)
        theta = theta - dt * d_mat @ (theta - torch.mean(theta, 0))
        misfits.append(0.5 * torch.mean(torch.sum(resid_w ** 2, 1)))
    return EKIResult(torch.mean(theta, 0), theta, torch.stack(misfits))


def ensemble_kalman_sampler(gen, forward, y, gamma, prior_mean, prior_cov,
                            n_ensemble=256, n_iters=800, dt0=0.3, mesh=None,
                            noise=None, device=None):
    """EKS: derivative-free POSTERIOR sampling (Garbuno-Iñigo et al. 2020,
    eqs. 4.3–4.6, with the Nüsken–Reich correction ``+Δt (P+1)/J (θ_j −
    θ̄)``). ``noise``: ``(z0 (J, P), xi(i) -> (J, J))``, the initial
    ensemble's and iteration i's normals, for a replay. ``mesh``: a
    ``WalkerLayout`` splitting the forward evaluations over the ranks (the
    module docstring). Returns :class:`EKSResult`."""
    rows = own_rows(mesh, int(n_ensemble), "n_ensemble")
    gen = as_generator(gen, device, mesh)
    y, gamma = _validate(forward, y, gamma, n_ensemble, gen.device)
    j_n = int(n_ensemble)
    m0, c0 = _prior(prior_mean, prior_cov, y)
    p_dim = m0.shape[0]
    dtype, dev = y.dtype, y.device
    c0_inv = torch.linalg.inv_ex(c0)[0]
    gamma_chol = nan_cholesky(gamma)
    if noise is None:
        noise = (torch.randn((j_n, p_dim), generator=gen, dtype=dtype,
                             device=dev),
                 lambda i: torch.randn((j_n, j_n), generator=gen,
                                       dtype=dtype, device=dev))
    theta = m0 + noise[0] @ nan_cholesky(c0).mT
    eye = torch.eye(p_dim, dtype=dtype, device=dev)
    c0_inv_m0 = c0_inv @ m0
    misfits = []
    for i in range(int(n_iters)):
        g, = gathered(mesh, forward(theta[rows]))
        t_bar = torch.mean(theta, 0)
        centered = theta - t_bar
        c_theta = centered.mT @ centered / j_n     # (P, P)
        dg_w = _whiten(gamma_chol, g - torch.mean(g, 0))
        resid_w = _whiten(gamma_chol, g - y)
        d_mat = resid_w @ dg_w.mT / j_n
        dt = dt0 / (torch.linalg.norm(d_mat) + 1e-8)
        drift = (theta - dt * d_mat @ centered
                 + dt * ((p_dim + 1.0) / j_n) * centered)
        # the linearly implicit prior step: (I + dt C(θ) C0⁻¹) θ* =
        # drift + dt C(θ) C0⁻¹ m0, stable in the prior's stiffness
        a_mat = eye + dt * c_theta @ c0_inv
        rhs = drift + dt * (c_theta @ c0_inv_m0)
        theta_star = solve(a_mat, rhs.mT).mT
        # ensemble-preconditioned noise N(0, 2 dt C(θ)), rank J−1
        theta = theta_star + torch.sqrt(2.0 * dt / j_n) * noise[1](i) \
            @ centered
        misfits.append(0.5 * torch.mean(torch.sum(resid_w ** 2, 1)))
    mean = torch.mean(theta, 0)
    centered = theta - mean
    return EKSResult(theta, mean, centered.mT @ centered / (j_n - 1),
                     torch.stack(misfits))
