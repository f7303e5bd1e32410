"""Covariance / correlation matrices over chain samples.

Counterpart of ``mcmcpp_tpu/analysis/covariance.py`` (the reference's
``MCMCpp/Analysis/CovarianceMatrix.h``: a single Kahan-compensated pass over
step iterators, :233-260, with an optional slice interval to de-correlate
samples, :154-174). Here the mean, the centring and one ``Xc.T @ Xc`` run in
torch on the device; float64 input stays on the host.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.sampler import resolve_device


def covariance_matrix(samples, thin=1, burn_in=0, device=None):
    """Covariance over all (step, walker) rows, as float64 numpy.

    samples: (S, W, P) or (N, P), a numpy array or a tensor. ``thin``/
    ``burn_in`` subsample steps before accumulating (≙
    CovarianceMatrix.h:154-174). A tensor is reduced on the device it lies
    on; a numpy array on ``device`` (default "cuda"; CUDA without a GPU
    raises). float64 input goes through ``np.cov`` on the host.

    The product is a true float32 product (the JAX package asks for
    ``Precision.HIGHEST``): it never runs in TF32. If a caller has switched
    ``torch.backends.cuda.matmul.allow_tf32`` on, the product is taken in
    float64 instead; no global setting is changed.
    """
    if isinstance(samples, torch.Tensor):
        x = samples
    else:
        arr = np.asarray(samples)
        if arr.dtype == np.float64:
            x = arr
        else:
            x = torch.from_numpy(np.ascontiguousarray(arr)).to(
                resolve_device("cuda" if device is None else device))
    if x.ndim == 3:
        x = x[burn_in::thin].reshape(-1, x.shape[-1])
    elif x.ndim == 2:
        x = x[burn_in::thin]
    else:
        raise ValueError("samples must be (S, W, P) or (N, P)")
    p = x.shape[1]
    if x.dtype in (np.float64, torch.float64):
        # keep full precision on host rather than silently truncating
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.cov(x.T, ddof=1).reshape(p, p)
    n = x.shape[0]
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        x = x.to(torch.float64)
    xc = x - x.mean(dim=0)[None, :]
    cov = (xc.T @ xc) / (n - 1)
    return cov.cpu().numpy().astype(np.float64)


def correlation_matrix(samples, thin=1, burn_in=0, device=None):
    """Correlation matrix (≙ CovarianceMatrix.h:177-215 normalization)."""
    cov = covariance_matrix(samples, thin=thin, burn_in=burn_in,
                            device=device)
    d = np.sqrt(np.diag(cov))
    return cov / np.outer(d, d)
