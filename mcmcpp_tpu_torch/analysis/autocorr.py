"""Integrated autocorrelation time (ACT) via FFT autocovariance.

PyTorch counterpart of ``mcmcpp_tpu/analysis/autocorr.py`` (the reference's
``MCMCpp/Analysis/AutoCorrCalc.h`` + ``Detail/AutoCov.h``): the per-walker
autocovariance is one batched ``torch.fft`` on the input's device (a tensor's
own; numpy goes to ``device``, default "cuda", as the JAX package puts it on
its accelerator), zero-padded to 2·next_pow2(n) (linear, not circular,
≙ ``AutoCov.h:286-290``); the Sokal and Geyer windows run on the host in numpy on the walker-averaged ρ(t). As in
the reference, a Sokal estimate whose window never closes is returned
**negative** (``AutoCorrCalc.h:204-206``).
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.sampler import resolve_device


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def _norm_autocov_fft(series):
    """Normalized autocovariance per walker; series (walkers, n) float
    tensor. Returns (walkers, n) with ρ(0) = 1, on series' device."""
    n = series.shape[1]
    centered = series - series.mean(dim=1, keepdim=True)
    npad = 2 * _next_pow2(n)
    f = torch.fft.rfft(centered, n=npad, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=npad, dim=1)[:, :n]
    return acov / acov[:, :1]


def _as_float32(x, device=None):
    """float32 ``x``: a tensor stays on its device, numpy goes to ``device``
    (default "cuda"; CUDA without a GPU raises)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        resolve_device("cuda" if device is None else device))


def normalized_autocov(series, device=None):
    """Normalized autocovariance ρ(t). ``series``: (n,) or (walkers, n), a
    tensor (on its device) or numpy (on ``device``, default "cuda");
    returns numpy."""
    arr = _as_float32(series, device)
    out = _norm_autocov_fft(torch.atleast_2d(arr)).cpu().numpy()
    return out[0] if arr.ndim == 1 else out


def _sokal_window_tau(rho, window_scaling):
    """Windowed Sokal estimate from the walker-averaged ρ(t):
    τ(M) = −1 + 2·Σ_{t=0..M} ρ(t) at the smallest M with M ≥ c·τ(M);
    −τ(last) if the window never closes. A closed window's estimate is
    floored at 1e-3 (see the JAX module for why)."""
    taus = 2.0 * np.cumsum(rho) - 1.0
    m = np.arange(len(rho))
    closed = m >= window_scaling * taus
    closed[0] = False  # need at least one lag
    if not np.any(closed):
        return -float(taus[-1])
    return float(max(taus[np.argmax(closed)], 1e-3))


def _geyer_tau(rho):
    """Geyer (1992) initial monotone sequence estimator: truncate the pair
    sums ρ(2m) + ρ(2m+1) at the first nonpositive one and enforce a
    monotone envelope. Always finite and positive."""
    n = (len(rho) // 2) * 2
    gam = rho[0:n:2] + rho[1:n:2]
    pos = gam > 0
    m_stop = int(np.argmin(pos)) if not pos.all() else len(gam)
    g = np.minimum.accumulate(gam[:max(m_stop, 1)])
    return float(max(2.0 * g.sum() - 1.0, 1e-3))


def autocorr_time(samples, window_scaling=4.0, walkers_to_use=None,
                  generator=None, walker_chunk=None, method="sokal",
                  device=None):
    """Integrated ACT per parameter.

    samples: (S, W) or (S, W, P) chain, numpy or a tensor. The FFT runs on
    a tensor's own device; numpy goes to ``device`` (default "cuda"; CUDA
    without a GPU raises), one walker chunk at a time.
    walkers_to_use: estimate from a uniform random subset of walkers
    (≙ ``AutoCorrCalc.h:276-305``), drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 if None).
    walker_chunk: process walkers in chunks of this size to bound the FFT
    working set.
    method: "sokal" (adaptive window, c = ``window_scaling``, NEGATIVE when
    the window never closes) or "geyer".

    Returns a float (for (S, W)) or a (P,) numpy array.
    """
    if isinstance(samples, torch.Tensor):
        arr, dev = samples.to(torch.float32), samples.device
    else:
        # the host copy stays on the host; each block crosses on its own,
        # so walker_chunk bounds the card's working set too
        arr = np.asarray(samples, np.float32)
        dev = resolve_device("cuda" if device is None else device)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("samples must be (S, W) or (S, W, P)")
    if method not in ("sokal", "geyer"):
        raise ValueError(f"unknown method {method!r}")
    estimate = (
        (lambda r: _sokal_window_tau(r, window_scaling))
        if method == "sokal" else _geyer_tau
    )
    s, w, p = arr.shape
    if walkers_to_use is not None and walkers_to_use < w:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        idx = torch.randperm(w, generator=generator)[:int(walkers_to_use)]
        arr = (arr[:, idx.to(dev), :] if isinstance(arr, torch.Tensor)
               else arr[:, idx.numpy(), :])
        w = arr.shape[1]
    rho = np.empty((p, s))
    chunk = int(walker_chunk) if walker_chunk else w
    for param in range(p):
        acc = np.zeros((s,), np.float64)
        for lo in range(0, w, chunk):
            blk = torch.as_tensor(arr[:, lo:lo + chunk, param]).to(dev).T
            acc += _norm_autocov_fft(blk).double().sum(dim=0).cpu().numpy()
        rho[param] = acc / w
    taus = np.array([estimate(rho[param]) for param in range(p)])
    return float(taus[0]) if squeeze else taus
