"""The Goodman–Weare stretch distribution g(z) ∝ 1/√z on [1/a, a].

PyTorch counterpart of ``mcmcpp_tpu/ops/gw.py`` (the reference's inverse-CDF
functor, ``MCMCpp/Utility/GwDistribution.h:40-58``): given u ~ U[0,1),

    z = ((√a − 1/√a) · u + 1/√a)²

The scalar constants are computed in the input's dtype on the host, as the
JAX version computes them in the array's dtype, so no device scalar is made.
"""

import functools
import math

import torch


def _scalars(a, dtype):
    a_t = torch.tensor(a, dtype=dtype)
    sqrt_a = torch.sqrt(a_t)
    return a_t, sqrt_a, 1.0 / sqrt_a


@functools.lru_cache(maxsize=64)
def _sample_consts(a, dtype):
    """(√a − 1/√a, 1/√a) as Python floats holding the ``dtype`` values; one
    computation per (a, dtype), off the half-step's host path."""
    _, sqrt_a, lo = _scalars(a, dtype)
    return float(sqrt_a - lo), float(lo)


def gw_sample(u, a=2.0):
    """Map uniform samples ``u`` in [0,1) to z ~ g(z) with scale ``a``."""
    span, lo = _sample_consts(float(a), u.dtype)
    return torch.square(span * u + lo)


def gw_logpdf(z, a=2.0):
    """log g(z) (unnormalized up to the support constant); -inf outside
    [1/a, a]."""
    a_t, sqrt_a, lo = _scalars(a, z.dtype)
    norm = 2.0 * (sqrt_a - lo)
    inside = (z >= float(1.0 / a_t)) & (z <= float(a_t))
    logp = -0.5 * torch.log(z) - float(torch.log(norm))
    return torch.where(inside, logp, torch.full_like(z, -math.inf))
