"""Unscented Kalman filter and the unscented RTS smoother.

PyTorch counterpart of ``mcmcpp_tpu/ukf.py`` (Julier & Uhlmann 1997; Wan &
van der Merwe 2000; Särkkä 2008): 2D+1 deterministic sigma points through
the nonlinear dynamics and observation maps, moment-matched. A time step is
a (2D+1, D) batch through the user's ``f``/``h`` plus small matmuls and two
(D, D)/(E, E) Choleskys, in a Python loop over T with no host sync; every
result stays differentiable by autograd in parameters the maps close over.

A quirk of the reference, mirrored as the JAX package computes it:
``joseph_jitter`` is not the Joseph form. The filtered covariance is the
plain ``P − K S Kᵀ``, symmetrized, plus ``joseph_jitter`` on the diagonal
(``mcmcpp_tpu/ukf.py:115``).
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mcmcpp_tpu_torch.models.lgss import nan_cholesky, solve
from mcmcpp_tpu_torch.particle import as_series

__all__ = ["UKFModel", "UKFResult", "unscented_kalman_filter",
           "unscented_rts_smoother"]


class UKFModel(NamedTuple):
    """Additive-noise nonlinear SSM; ``f``/``h`` vectorized over the leading
    sigma-point axis, ``t`` the step's Python int.

    f(x (S, D), t) -> (S, D)   dynamics mean map
    h(x (S, D), t) -> (S, E)   observation mean map
    Q (D, D), R (E, E)         additive process / observation noise
    m0 (D,), P0 (D, D)         prior on x_0 (filtered at t=0 with y_0)
    """

    f: Callable
    h: Callable
    Q: torch.Tensor
    R: torch.Tensor
    m0: torch.Tensor
    P0: torch.Tensor


class UKFResult(NamedTuple):
    loglik: torch.Tensor      # predictive log p(y_{1:T})
    means: torch.Tensor       # (T, D) filtered E[x_t | y_{1:t}]
    covs: torch.Tensor        # (T, D, D)
    pred_means: torch.Tensor  # (T, D) one-step predictive means
    pred_covs: torch.Tensor   # (T, D, D)


def _sigma_points(m, p_mat, lam, d):
    """(2D+1, D) scaled sigma points around (m, P)."""
    scaled = np.sqrt(d + lam) * nan_cholesky(p_mat)  # columns: the offsets
    offsets = torch.cat([scaled.mT, -scaled.mT], 0)
    return torch.cat([m[None, :], m[None, :] + offsets], 0)


def _weights(lam, d, alpha, beta, dtype, device):
    wm = torch.full((2 * d + 1,), 0.5 / (d + lam), dtype=dtype, device=device)
    wm[0] = lam / (d + lam)
    wc = wm.clone()
    wc[0] = lam / (d + lam) + (1.0 - alpha ** 2 + beta)
    return wm, wc


def _wcov(wc, a, b):
    """Σ_s wc_s a_s b_sᵀ."""
    return (a * wc[:, None]).mT @ b


def _model_tensors(model):
    m0 = torch.as_tensor(model.m0)
    if not m0.is_floating_point():
        m0 = m0.to(torch.float32)

    def t_(x):
        return torch.as_tensor(x, dtype=m0.dtype, device=m0.device)

    return m0, t_(model.P0), t_(model.Q), t_(model.R)


def unscented_kalman_filter(model, ys, alpha=1.0, beta=2.0, kappa=0.0,
                            joseph_jitter=1e-9):
    """The UKF over ``ys`` ((T, E); (T,) promoted), on the device of
    ``model.m0``. λ = α²(D+κ) − D; α=1, κ=0 spreads the points at √D.
    ``y_0`` observes the prior (m0, P0); the loglik is
    Σ_t log N(y_t; ŷ_t, S_t). Returns :class:`UKFResult`."""
    m0, p0, q, r = _model_tensors(model)
    ys = as_series(ys).to(m0.device, m0.dtype)
    d, e = m0.shape[0], ys.shape[1]
    lam = alpha * alpha * (d + kappa) - d
    wm, wc = _weights(lam, d, alpha, beta, m0.dtype, m0.device)
    eye = torch.eye(d, dtype=m0.dtype, device=m0.device)
    half_log2pi = 0.5 * e * np.log(2.0 * np.pi)

    def observe(m, p_mat, y, t):
        sig = _sigma_points(m, p_mat, lam, d)
        ysig = model.h(sig, t)                     # (2D+1, E)
        y_hat = wm @ ysig
        dy = ysig - y_hat
        s_mat = _wcov(wc, dy, dy) + r
        c_mat = _wcov(wc, sig - m, dy)
        chol_s = nan_cholesky(s_mat)
        innov = y - y_hat
        k_gain = torch.cholesky_solve(c_mat.mT, chol_s).mT
        m_new = m + k_gain @ innov
        p_new = p_mat - k_gain @ s_mat @ k_gain.mT
        p_new = 0.5 * (p_new + p_new.mT) + joseph_jitter * eye
        z = torch.linalg.solve_triangular(chol_s, innov[:, None],
                                          upper=False)[:, 0]
        ll = (-0.5 * torch.sum(z * z)
              - torch.sum(torch.log(torch.diagonal(chol_s))) - half_log2pi)
        return m_new, p_new, ll

    def predict(m, p_mat, t):
        fsig = model.f(_sigma_points(m, p_mat, lam, d), t)
        m_pred = wm @ fsig
        dxp = fsig - m_pred
        p_pred = _wcov(wc, dxp, dxp) + q
        return m_pred, 0.5 * (p_pred + p_pred.mT)

    m, p, ll = observe(m0, p0, ys[0], 0)
    lls, ms, ps, mps, pps = [ll], [m], [p], [m0], [p0]
    for t in range(1, ys.shape[0]):
        m_pred, p_pred = predict(m, p, t)
        m, p, ll = observe(m_pred, p_pred, ys[t], t)
        lls.append(ll)
        ms.append(m)
        ps.append(p)
        mps.append(m_pred)
        pps.append(p_pred)
    lls = torch.stack(lls)
    return UKFResult(loglik=lls[0] + torch.sum(lls[1:]), means=torch.stack(ms),
                     covs=torch.stack(ps), pred_means=torch.stack(mps),
                     pred_covs=torch.stack(pps))


def unscented_rts_smoother(model, ys=None, filtered: Optional[UKFResult] = None,
                           alpha=1.0, beta=2.0, kappa=0.0):
    """Unscented RTS smoother (Särkkä 2008): a backward pass over a
    :func:`unscented_kalman_filter` result with sigma-point
    cross-covariances. Returns ``(means (T, D), covs (T, D, D))``."""
    if filtered is None:
        if ys is None:
            raise ValueError("pass ys= or filtered=")
        filtered = unscented_kalman_filter(model, ys, alpha=alpha, beta=beta,
                                           kappa=kappa)
    m0, _, q, _ = _model_tensors(model)
    d = m0.shape[0]
    lam = alpha * alpha * (d + kappa) - d
    wm, wc = _weights(lam, d, alpha, beta, m0.dtype, m0.device)
    m_s, p_s = filtered.means[-1], filtered.covs[-1]
    out_m, out_p = [m_s], [p_s]
    for t in range(filtered.means.shape[0] - 2, -1, -1):
        m_f, p_f = filtered.means[t], filtered.covs[t]
        sig = _sigma_points(m_f, p_f, lam, d)
        fsig = model.f(sig, t + 1)
        m_pred = wm @ fsig
        dxp = fsig - m_pred
        p_pred = _wcov(wc, dxp, dxp) + q
        c_mat = _wcov(wc, sig - m_f, dxp)
        gain = solve(p_pred.mT, c_mat.mT).mT
        m_s = m_f + gain @ (m_s - m_pred)
        p_s = p_f + gain @ (p_s - p_pred) @ gain.mT
        p_s = 0.5 * (p_s + p_s.mT)
        out_m.append(m_s)
        out_p.append(p_s)
    return torch.stack(out_m[::-1]), torch.stack(out_p[::-1])
