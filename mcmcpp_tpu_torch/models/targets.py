"""Gaussian targets in precision-Cholesky form.

Every Gaussian target the JAX package benchmarks (``mcmcpp_tpu/models/
targets.py:29-64`` and the flagship of ``bench.py:63-73``) evaluates
logp(x) = −½‖x @ L‖² with L the lower-triangular Cholesky factor of the
precision matrix. :class:`GaussianTarget` is that form as a batched module;
it is also the one target the fused CUDA half-step evaluates in its own body
(``ops/fused_stretch.py``).
"""

import numpy as np
import torch
from torch import nn


class GaussianTarget(nn.Module):
    """Zero-mean Gaussian, logp(x) = −½‖x @ L‖², for x of shape (n, P)
    (or (P,)); ``prec_chol`` is L, lower-triangular, (P, P)."""

    def __init__(self, prec_chol, device="cuda", dtype=torch.float32):
        super().__init__()
        prec_chol = torch.as_tensor(prec_chol, dtype=dtype, device=device)
        if prec_chol.ndim != 2 or prec_chol.shape[0] != prec_chol.shape[1]:
            raise ValueError(f"prec_chol must be (P, P), got {prec_chol.shape}")
        self.register_buffer("prec_chol", prec_chol.contiguous())

    @classmethod
    def from_numpy(cls, prec_chol, device="cuda"):
        """Build from the numpy L that the JAX package's target closes over."""
        return cls(np.asarray(prec_chol, np.float32), device=device)

    @classmethod
    def from_cov(cls, cov, device="cuda"):
        """L = cholesky(inv(cov)), computed in float64."""
        cov = np.asarray(cov, np.float64)
        return cls(np.linalg.cholesky(np.linalg.inv(cov)), device=device)

    @property
    def dim(self):
        return self.prec_chol.shape[0]

    def forward(self, x):
        y = x @ self.prec_chol
        return -0.5 * torch.sum(y * y, dim=-1)


def skewed_gaussian(eps=0.13, device="cuda"):
    """The reference's flagship test target
    (``test/sequential/SkewedGaussian/Common/SkewedGaussian.h:52-57``):
    logp = −½[(x/2 − y)²/eps + (x/2 + y)²], true covariance
    [[1+eps, (1−eps)/2], [(1−eps)/2, (1+eps)/4]]."""
    cov = np.array([[1 + eps, (1 - eps) / 2], [(1 - eps) / 2, (1 + eps) / 4]])
    return GaussianTarget.from_cov(cov, device=device)


def correlated_gaussian(dim=10, rho=0.5, device="cuda"):
    """AR(1)-correlated standardized Gaussian: Σ_ij = rho^|i−j|."""
    idx = np.arange(dim)
    return GaussianTarget.from_cov(
        rho ** np.abs(idx[:, None] - idx[None, :]), device=device
    )


def equicorrelated_gaussian(dim=10, rho=0.5, device="cuda"):
    """Σ = rho·11ᵀ + (1−rho)·I: the flagship benchmark target
    (``bench.py:63-73``, 10-D at rho = 0.5)."""
    return GaussianTarget.from_cov(
        rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim), device=device
    )
