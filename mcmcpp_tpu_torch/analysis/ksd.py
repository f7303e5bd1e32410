"""Kernelized Stein discrepancy (KSD): a sample-quality measure that detects
*bias*, not just autocorrelation (Gorham & Mackey 2017).

PyTorch counterpart of ``mcmcpp_tpu/analysis/ksd.py``. ESS and R-hat cannot
see a stationary distribution that is simply wrong (a stochastic-gradient
sampler's O(ε) bias); the KSD measures the discrepancy between the draws'
empirical measure and the target using only the score ∇log p:

    KSD²(q, p) = E_{x,y~q}[ k_0(x, y) ]
    k_0(x,y) = s(x)ᵀs(y) k + s(x)ᵀ∇_y k + s(y)ᵀ∇_x k + tr ∇_x∇_y k

with the inverse multiquadric base kernel ``k(x,y) = (c² + ‖x−y‖²)^β``, β ∈
(−1, 0), which detects non-convergence. The O(n²) sum runs over blocks of
rows on the draws' device (JAX's ``lax.map`` over ``dynamic_slice`` blocks
becomes a loop over row slices), so memory stays O(block · n); its pieces
are three (B, n) products per block, never in TF32, summed in float64.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.models.gp import matmul
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["ksd", "ksd_curve"]

BLOCK = 2048


def _ksd_sum(x, scores, c2, beta, u_statistic, block=BLOCK):
    """Σ_{ij} k_0(x_i, x_j) (the diagonal dropped for the U-statistic),
    row block by row block; a float64 0-d tensor on x's device."""
    n, p = x.shape
    sq = torch.sum(x * x, dim=1)
    diag_xs = torch.sum(x * scores, dim=1)  # x_j·s_j
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        xb, sb = x[start:stop], scores[start:stop]
        # pairwise pieces, all (B, n): r² = ‖x_i − x_j‖², u = c² + r²
        r2 = torch.clamp(sq[start:stop, None] + sq[None, :]
                         - 2.0 * matmul(xb, x.T), min=0.0)
        u = c2 + r2
        ub = u ** beta
        ub1 = beta * u ** (beta - 1.0)
        ss = matmul(sb, scores.T)  # s(x_i)ᵀs(x_j)
        # dᵀ(s_j − s_i) with d = x_i − x_j:
        # x_i·s_j − x_j·s_j − x_i·s_i + x_j·s_i
        d_ds = (matmul(xb, scores.T) - diag_xs[None, :]
                - diag_xs[start:stop, None] + matmul(sb, x.T))
        trace = (-(4.0 * beta * (beta - 1.0)) * u ** (beta - 2.0) * r2
                 - 2.0 * beta * p * u ** (beta - 1.0))
        k0 = ub * ss + 2.0 * ub1 * d_ds + trace
        if u_statistic:
            rows = torch.arange(stop - start, device=x.device)
            k0[rows, start + rows] = 0.0
        total = total + torch.sum(k0, dtype=torch.float64)
    return total


def _scores_of(score_fn, x, batched):
    """∇log p at each row of x, by autograd of the summed batched logp (the
    rows are independent, so the gradient of the sum is each row's)."""
    fn = score_fn if batched else torch.func.vmap(score_fn)
    with torch.enable_grad():
        q = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(q).sum(), q)
    return g.detach()


def ksd(samples, score_fn=None, scores=None, c=1.0, beta=-0.5,
        u_statistic=True, batched=True, block=BLOCK, device=None):
    """KSD between the empirical measure of ``samples`` and the target whose
    log-density is ``score_fn``: a batched logp (n, P) -> (n,) as the
    engines take (``batched=False``: a per-θ logp, vmapped here); its
    gradient, the score, is taken by autograd. Or pass the (n, P) scores
    ``scores`` themselves.

    samples: (n, P) draws, numpy or a tensor (the sum runs on a tensor's
    device; numpy goes to ``device``, default "cuda"). Thin first: the cost
    is O(n²P). Returns the scalar KSD, the square root of the V- or
    U-statistic (the U-statistic is unbiased and may dip below 0 under the
    root: clipped at 0). Compare runs
    at matched n: smaller is closer to the target.
    """
    x = (samples if isinstance(samples, torch.Tensor)
         else torch.as_tensor(np.asarray(samples)).to(
             resolve_device("cuda" if device is None else device)))
    x = torch.atleast_2d(x)
    if scores is None:
        if score_fn is None:
            raise ValueError("provide score_fn or scores")
        scores = _scores_of(score_fn, x, batched)
    scores = (scores if isinstance(scores, torch.Tensor)
              else torch.as_tensor(np.asarray(scores)))
    scores = scores.to(device=x.device, dtype=x.dtype)
    if scores.shape != x.shape:
        raise ValueError(
            f"scores shape {tuple(scores.shape)} != samples shape "
            f"{tuple(x.shape)}"
        )
    n = x.shape[0]
    total = float(_ksd_sum(x, scores, float(c * c), float(beta),
                           bool(u_statistic), int(block)))
    denom = n * (n - 1) if u_statistic else n * n
    return float(np.sqrt(max(total / denom, 0.0)))


def ksd_curve(samples_by_setting, score_fn, n=2048, seed=0, **kw):
    """For step-size or temperature sweeps: subsample each entry of
    ``{setting: (n_i, P) draws}`` to a common ``n`` (numpy's generator of
    ``seed``, as the JAX package does) and return ``{setting: ksd}``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, draws in samples_by_setting.items():
        d = draws if isinstance(draws, torch.Tensor) else np.asarray(draws)
        d = d.reshape(-1, d.shape[-1])
        if d.shape[0] > n:
            idx = rng.choice(d.shape[0], size=n, replace=False)
            d = d[torch.as_tensor(idx, device=d.device)
                  if isinstance(d, torch.Tensor) else idx]
        out[name] = ksd(d, score_fn=score_fn, **kw)
    return out
