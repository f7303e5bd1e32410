"""DRAM: delayed-rejection adaptive Metropolis (Haario et al. 2006).

PyTorch counterpart of ``mcmcpp_tpu/movers/dram.py``: on a stage-1 rejection
a second, shrunk proposal is tried from the same point and accepted with
Mira's (2001) delayed-rejection ratio. Both stages are computed for every
walker, with a branchless three-way select (Y1 / Y2 / X), so no half-step
branches on the device's data.

With ``adapt="ensemble"`` (the default) the proposal covariance comes from
the complementary half each half-step, 2.38²/P·cov(other) + eps·I; the
active half's proposal depends only on the fixed other half, so π^W
invariance holds exactly. Sharded (``parallel/sharded.py``), the other half
is the whole gathered half on every rank, so the ensemble mean and
covariance need no collective of their own. The (P, P) factor is
``torch.linalg.cholesky_ex``, which leaves its ``info`` on the device
(``torch.linalg.cholesky`` would read it back on the host every half-step); a
failed factorisation proposes NaN and so rejects, as JAX's NaN factor does.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.random import neg_exponential, normal


def _log1m_exp(a):
    """log(1 − e^a) for a ≤ 0, branchless; −inf at a == 0."""
    a_safe = torch.clamp(a, max=-1e-10)
    return torch.where(a < -1e-10, torch.log1p(-torch.exp(a_safe)),
                       -torch.inf)


class DRAMMove(Mover):
    """Delayed-rejection (adaptive) Metropolis mover; the parameters are
    those of the JAX ``DRAMMove``: ``covariance`` (static mode only),
    ``scale``, the stage-2 shrink ``gamma``, ``adapt`` ("ensemble" or None)
    and the adaptive floor ``eps``. ``noise`` is
    ``(xi1 (n, P), xi2 (n, P), log_u1 (n,), log_u2 (n,))``."""

    def __init__(self, covariance=None, scale=1.0, gamma=0.35,
                 adapt="ensemble", eps=1e-6):
        if adapt not in ("ensemble", None):
            raise ValueError(f"unknown adapt mode {adapt!r}")
        if not 0.0 < float(gamma):
            raise ValueError("gamma must be positive")
        self.scale = float(scale)
        self.gamma = float(gamma)
        self.adapt = adapt
        self.eps = float(eps)
        self.covariance = None if covariance is None else np.asarray(covariance)

    def init_state(self, n_params, dtype, device):
        if self.adapt == "ensemble":
            return ()
        cov = self.covariance
        if cov is None:
            chol = np.eye(n_params)
        elif cov.ndim == 1:
            if cov.shape[0] != n_params or np.any(cov <= 0):
                raise ValueError("diagonal covariance must be positive, (P,)")
            chol = np.diag(np.sqrt(cov))
        else:
            if cov.shape != (n_params, n_params):
                raise ValueError("covariance must be (P, P)")
            chol = np.linalg.cholesky(cov)  # raises if not SPD
        return {"chol": torch.as_tensor(chol, dtype=dtype, device=device)}

    def _chol(self, other, state, n_params):
        if self.adapt != "ensemble":
            return state["chol"]
        centered = other - torch.mean(other, dim=0, keepdim=True)
        m = other.shape[0]
        cov = centered.T @ centered / float(max(m - 1, 1))
        sd = 2.38 * 2.38 / n_params
        eye = torch.eye(n_params, dtype=other.dtype, device=other.device)
        chol, info = torch.linalg.cholesky_ex(sd * cov + self.eps * eye)
        return torch.where(info == 0, chol, torch.nan)

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        return (normal(gen, (n, p), dtype, device),
                normal(gen, (n, p), dtype, device),
                neg_exponential(gen, n, dtype, device),
                neg_exponential(gen, n, dtype, device))

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0, row0=0, layout=None):
        xi1, xi2, log_u1, log_u2 = noise
        chol = self._chol(other, state, active.shape[1])

        # stage 1 (plain Metropolis, symmetric Gaussian proposal)
        y1 = active + self.scale * (xi1 @ chol.T)
        l1 = logp_fn(y1)
        d1 = beta * (l1 - active_logp)
        accept1 = log_u1 < d1

        # stage 2 (shrunk proposal from the same point)
        y2 = active + (self.gamma * self.scale) * (xi2 @ chol.T)
        l2 = logp_fn(y2)

        # Mira's DR ratio: ||L^{-1}(y1 − x)||²/scale² is ||xi1||² by
        # construction; only y1 − y2 needs L^{-1}. The triangular solve
        # runs on the (P, P) identity and the n rows take one product:
        # solving against the (P, n) right-hand side directly goes, on
        # CUDA, through cuBLAS's batched trsm (torch's path for factors up
        # to 512), which serialises the n columns (seconds at n = 2^20)
        eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
        chol_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
        z = (y1 - y2) @ chol_inv.T / self.scale
        lq_num = -0.5 * torch.sum(z * z, dim=-1)
        lq_den = -0.5 * torch.sum(xi1 * xi1, dim=-1)
        a1_fwd = torch.clamp(d1, max=0.0)                 # log α1(x → y1)
        a1_rev = torch.clamp(beta * (l1 - l2), max=0.0)   # log α1(y2 → y1)
        log_num = beta * l2 + lq_num + _log1m_exp(a1_rev)
        log_den = beta * active_logp + lq_den + _log1m_exp(a1_fwd)
        # a NaN difference compares False, so nothing leaks (see JAX module)
        accept2 = ~accept1 & (log_u2 < log_num - log_den)

        new_active = torch.where(
            accept1[:, None], y1, torch.where(accept2[:, None], y2, active)
        )
        new_logp = torch.where(accept1, l1,
                               torch.where(accept2, l2, active_logp))
        return new_active, new_logp, accept1 | accept2
