"""Mass-matrix (metric) abstraction for the gradient kernels.

PyTorch counterpart of ``mcmcpp_tpu/gradient/metric.py``. Every gradient
kernel is written against six linear-map primitives — velocity ``M⁻¹p``,
kinetic energy ``½pᵀM⁻¹p``, momentum sampling ``p ~ N(0, M)``, the
proposal-noise map ``M^{-1/2}z``, its transpose and the whitened squared norm
``dᵀMd`` — so the same kernel code runs under either metric:

- **diag** (default): ``inv_mass`` is the ``(P,)`` tensor of estimated
  posterior variances; every primitive is elementwise.
- **dense**: ``inv_mass`` is a :class:`DenseMassMatrix` holding the estimated
  posterior covariance ``Σ = M⁻¹``, its lower Cholesky factor ``L`` and
  ``L⁻ᵀ``, computed once per metric update, so the per-step cost is products.

The primitives broadcast over a leading chain axis: ``p`` is ``(P,)`` or
``(C, P)``. The products are true float32 products: if a caller has switched
``torch.backends.cuda.matmul.allow_tf32`` on, they are taken in float64
instead (as ``analysis/covariance.py`` does); no global setting is changed.
"""

from typing import NamedTuple

import torch


class DenseMassMatrix(NamedTuple):
    """Dense metric state: ``cov`` is ``Σ = M⁻¹``, ``chol`` its lower
    Cholesky factor ``L``, ``inv_chol_t = L⁻ᵀ``."""

    cov: torch.Tensor  # (P, P)
    chol: torch.Tensor  # (P, P), lower
    inv_chol_t: torch.Tensor  # (P, P)


def matmul(a, b):
    """``a @ b`` that never runs in TF32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        return (a.double() @ b.double()).to(a.dtype)
    return a @ b


def dense_mass_from_cov(cov):
    """The dense-metric state from a covariance estimate: symmetrize, factor
    (``cholesky_ex``: no host sync on CUDA), then one triangular solve
    against the identity (P right-hand sides, never a batch of them)."""
    cov = 0.5 * (cov + cov.T)  # symmetrize against accumulation drift
    chol = torch.linalg.cholesky_ex(cov)[0]
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    return DenseMassMatrix(cov=cov, chol=chol, inv_chol_t=inv_chol.T)


def is_dense(inv_mass) -> bool:
    return isinstance(inv_mass, DenseMassMatrix)


def _apply(mat, x):
    """``mat @ x`` over the last axis of ``x`` ((P,) or (C, P))."""
    return matmul(x, mat.T)


def _apply_t(mat, x):
    """``matᵀ @ x`` over the last axis of ``x``."""
    return matmul(x, mat)


def mass_velocity(inv_mass, p):
    """``M⁻¹ p`` — the dq/dt term of the leapfrog."""
    if is_dense(inv_mass):
        return _apply(inv_mass.cov, p)
    return inv_mass * p


def mass_kinetic(inv_mass, p):
    """``½ pᵀ M⁻¹ p`` over the last axis (dense: ``½‖Lᵀp‖²``)."""
    if is_dense(inv_mass):
        y = _apply_t(inv_mass.chol, p)
        return 0.5 * torch.sum(y * y, dim=-1)
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1)


def mass_momentum(inv_mass, z):
    """Map ``z ~ N(0, I)`` to ``p ~ N(0, M)`` (``p = L⁻ᵀ z`` dense)."""
    if is_dense(inv_mass):
        return _apply(inv_mass.inv_chol_t, z)
    return z * torch.rsqrt(inv_mass)


def mass_noise(inv_mass, z):
    """Map ``z ~ N(0, I)`` to ``M^{-1/2} z ~ N(0, M⁻¹)`` (``L z`` dense)."""
    if is_dense(inv_mass):
        return _apply(inv_mass.chol, z)
    return z * torch.sqrt(inv_mass)


def mass_noise_t(inv_mass, g):
    """Transpose of :func:`mass_noise`: ``M^{-1/2,T} g`` (``Lᵀ g`` dense),
    a position-space gradient in the whitened coordinates."""
    if is_dense(inv_mass):
        return _apply_t(inv_mass.chol, g)
    return g * torch.sqrt(inv_mass)


def mass_quad_inv(inv_mass, d):
    """``dᵀ Σ⁻¹ d`` with ``Σ = M⁻¹`` (``‖L⁻¹d‖²`` dense)."""
    if is_dense(inv_mass):
        y = _apply_t(inv_mass.inv_chol_t, d)
        return torch.sum(y * y, dim=-1)
    return torch.sum(d * d / inv_mass, dim=-1)
