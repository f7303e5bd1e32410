"""Bridge sampling: log evidence from ANY sampler's posterior draws.

PyTorch counterpart of ``mcmcpp_tpu/analysis/bridge.py``: the Meng & Wong
(1996) optimal-bridge estimator with its iterative update in log space (the
numerics of the bridgesampling R package, Gronau et al. 2017). A
post-processor: hand it the draws of NUTS, an ensemble or any engine and the
unnormalized log posterior, and it returns log Z. The proposal is a Gaussian
fitted to HALF the draws (the other half feeds the bridge; Overstall &
Forster 2010). ``rel_ess`` in the result is the overlap diagnostic.

The split and the proposal's draws come from a CPU ``torch.Generator``
seeded by ``seed`` (JAX's module draws them from numpy's generator, so the
two packages' estimates differ by their Monte-Carlo error); the log
posterior runs on ``device`` in ``dtype`` (the draws' device; "cuda" for
numpy draws unless ``device`` says otherwise), the rest in float64 numpy.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.sampler import resolve_device


class BridgeResult(NamedTuple):
    logz: float
    n_iter: int
    converged: bool
    rel_ess: float  # relative ESS of q1/q2 weights on proposal draws


def bridge_log_evidence(logpost_fn, draws, n_proposal=None, seed=0,
                        tol=1e-10, max_iter=1000, batched=True,
                        dtype=torch.float32, device=None):
    """log Z = log ∫ exp(logpost) from posterior draws.

    logpost_fn: the UNNORMALIZED log posterior the sampler targeted, batched
        (n, P) -> (n,) (``batched=False``: per-θ (P,) -> scalar, vmapped
        here), in torch ops.
    draws: (N, P) approximately independent posterior draws, numpy or a
        tensor (thin past the autocorrelation time first).
    n_proposal: Gaussian proposal draws (default: half of N).
    dtype, device: where ``logpost_fn`` runs (device: the draws' own for
        a tensor; for numpy, "cuda" unless given).

    Returns :class:`BridgeResult`. ``converged=False`` or a tiny
    ``rel_ess`` (≪ 1/√N) means the proposal overlaps the posterior poorly.
    """
    if device is None:
        device = (draws.device if isinstance(draws, torch.Tensor)
                  else "cuda")
    device = resolve_device(device)
    draws = (draws.detach().cpu().double().numpy()
             if isinstance(draws, torch.Tensor)
             else np.asarray(draws, np.float64))
    if draws.ndim != 2 or draws.shape[0] < 8:
        raise ValueError("draws must be (N >= 8, P)")
    n, p = draws.shape
    gen = torch.Generator().manual_seed(int(seed))
    perm = torch.randperm(n, generator=gen).numpy()
    fit, keep = draws[perm[: n // 2]], draws[perm[n // 2:]]
    n1 = keep.shape[0]
    n2 = int(n_proposal) if n_proposal is not None else n1

    mu = fit.mean(axis=0)
    cov = np.cov(fit, rowvar=False).reshape(p, p)
    cov += 1e-10 * np.eye(p) * max(np.trace(cov) / p, 1e-30)
    chol = np.linalg.cholesky(cov)
    z = torch.randn((n2, p), generator=gen, dtype=torch.float64).numpy()
    prop = mu[None, :] + z @ chol.T

    logdet = 2.0 * np.sum(np.log(np.diagonal(chol)))

    def logq2(x):
        w = np.linalg.solve(chol, (x - mu[None, :]).T)
        return (-0.5 * np.sum(w * w, axis=0)
                - 0.5 * (p * math.log(2 * math.pi) + logdet))

    fn = logpost_fn if batched else torch.func.vmap(logpost_fn)

    def logpost(x):
        t = torch.as_tensor(x, device=device).to(dtype)
        with torch.no_grad():
            return fn(t).detach().cpu().double().numpy()

    l1 = logpost(keep) - logq2(keep)  # log l on posterior draws
    l2 = logpost(prop) - logq2(prop)  # log l on proposal draws
    finite2 = np.isfinite(l2)
    if not finite2.all():
        # proposal mass outside the posterior support contributes 0 to the
        # numerator sum but still counts in n2
        l2 = l2[finite2]
    if not np.isfinite(l1).all():
        raise ValueError(
            "logpost is non-finite at posterior draws — wrong function?"
        )

    log_s1 = math.log(n1 / (n1 + n2))
    log_s2 = math.log(n2 / (n1 + n2))
    # overlap diagnostic: relative ESS of the importance weights q1/q2
    w = l2 - _lse(l2)
    rel_ess = float(np.exp(-_lse(2.0 * w)) / n2)

    log_r = float(np.median(l2)) if l2.size else float(np.median(l1))
    converged = False
    it = 0
    for it in range(1, int(max_iter) + 1):
        num = (_lse(l2 - np.logaddexp(log_s1 + l2, log_s2 + log_r))
               - math.log(n2)) if l2.size else -np.inf
        den = (_lse(-np.logaddexp(log_s1 + l1, log_s2 + log_r))
               - math.log(n1))
        new = num - den
        if abs(new - log_r) < tol:
            log_r = new
            converged = True
            break
        log_r = new
    return BridgeResult(float(log_r), it, converged, rel_ess)


def _lse(x):
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return -np.inf
    m = np.max(x)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.sum(np.exp(x - m))))
