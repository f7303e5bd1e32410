"""Proper scoring rules for predictive evaluation: CRPS and the energy
score, from ensemble (sample-based) forecasts.

PyTorch counterpart of ``mcmcpp_tpu/analysis/scores.py`` (Gneiting &
Raftery 2007), computed on the draws' device: a tensor gives a tensor on its
device, numpy gives numpy (computed in its dtype on ``device``, default
"cuda", as the JAX package puts it on its accelerator).

    CRPS(F, y) = E_F|X − y| − ½ E_F|X − X'|        (univariate)
    ES(F, y)   = E_F‖X − y‖ − ½ E_F‖X − X'‖        (multivariate)

The univariate pairwise term is the exact sorted identity
``Σ_{i≠j}|x_i − x_j| = 2 Σ_i (2i − n + 1) x_(i)`` (one sort per location);
the energy score's pairwise distances come from one (n, n) Gram product,
never in TF32.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.models.gp import matmul
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["crps_ensemble", "energy_score"]


def _tensors(*xs, device=None):
    """Tensors on one device, one dtype; and whether to hand back numpy. The
    device: the first tensor's off the CPU, else the CPU; with no tensor
    among ``xs``, ``device`` (default "cuda")."""
    as_numpy = not any(isinstance(x, torch.Tensor) for x in xs)
    ts = [x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
          for x in xs]
    if as_numpy:
        dev = resolve_device("cuda" if device is None else device)
    else:
        dev = next((t.device for t in ts if t.device.type != "cpu"),
                   torch.device("cpu"))
    dtype = torch.promote_types(ts[0].dtype, ts[1].dtype)
    if not dtype.is_floating_point:
        dtype = torch.float32
    return [t.to(device=dev, dtype=dtype) for t in ts], as_numpy


def _out(t, as_numpy):
    return t.cpu().numpy() if as_numpy else t


def crps_ensemble(samples, observations, device=None):
    """CRPS per location from ensemble draws.

    samples : (..., N) predictive draws (trailing axis = ensemble).
    observations : (...,) realized outcomes, broadcast against the leading
        axes.

    Returns the (...,) per-location CRPS (lower is better) in the FAIR form
    (Ferro 2014): the pairwise term is the without-replacement mean
    Σ_{i≠j}|x_i − x_j| / (n(n−1)).

    device: where numpy inputs are computed (default "cuda"); a tensor
    input keeps its own.
    """
    (x, y), as_numpy = _tensors(samples, observations, device=device)
    n = x.shape[-1]
    if n < 2:
        raise ValueError("crps_ensemble needs at least 2 draws")
    term1 = torch.mean(torch.abs(x - y[..., None]), dim=-1)
    xs = torch.sort(x, dim=-1).values
    i = torch.arange(n, dtype=x.dtype, device=x.device)
    pair = (2.0 / (n * (n - 1.0))) * torch.sum((2.0 * i - n + 1.0) * xs,
                                               dim=-1)
    return _out(term1 - 0.5 * pair, as_numpy)


def energy_score(samples, observation, device=None):
    """Energy score (multivariate CRPS) from ensemble draws.

    samples : (N, D) joint predictive draws.
    observation : (D,) realized outcome.

    Returns a scalar (lower is better), in the fair form (the pairwise term
    averages over the n(n−1) distinct pairs); equal to the fair CRPS at
    D = 1. ``device`` as in :func:`crps_ensemble`.
    """
    (x, y), as_numpy = _tensors(samples, observation, device=device)
    n = x.shape[0]
    if n < 2:
        raise ValueError("energy_score needs at least 2 draws")
    term1 = torch.mean(torch.linalg.vector_norm(x - y[None, :], dim=-1))
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * matmul(x, x.T),
                     min=0.0)
    term2 = torch.sum(torch.sqrt(d2)) / (n * (n - 1.0))
    return _out(term1 - 0.5 * term2, as_numpy)
