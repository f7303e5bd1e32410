"""Classic Metropolis–Hastings with a multivariate-normal proposal.

PyTorch counterpart of ``mcmcpp_tpu/movers/mh.py``
(``MCMCpp/Movers/MetropolisHastings.h``): the user covariance is validated
in numpy at construction (symmetry, positive diagonal, diagonal detection,
:218-237), factorised with numpy's Cholesky, and an invalid matrix falls
back to the identity with a warning (:314-333). Sampling is one
``normals @ L.T`` product, or ``normals * diag`` on the diagonal fast path.
Symmetric proposal, so the Metropolis factor is 0.
"""

import warnings

import numpy as np
import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.random import normal


class MetropolisHastingsMove(Mover):
    """MH mover. ``covariance`` may be None (identity), a 1-D array
    (diagonal), or a full (P, P) SPD matrix. Invalid matrices fall back to
    the identity with a warning, as the reference does. ``noise`` is
    ``(normals (n, P), log_u)``."""

    def __init__(self, covariance=None, scale=1.0):
        self.scale = float(scale)
        self.covariance = None if covariance is None else np.asarray(covariance)
        self._diag = None  # filled by _validate
        self._full = None
        self.fell_back_to_identity = False
        self._validate()

    def _validate(self):
        cov = self.covariance
        if cov is None:
            return
        if cov.ndim == 1:
            if np.all(cov > 0):
                self._diag = np.sqrt(cov)
            else:
                self._fallback("diagonal covariance has non-positive entries")
            return
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            self._fallback("covariance must be square")
            return
        if not np.allclose(cov, cov.T, rtol=1e-8, atol=1e-12):
            self._fallback("covariance is not symmetric")
            return
        if np.any(np.diag(cov) <= 0):
            self._fallback("covariance has non-positive diagonal")
            return
        off_diag = cov - np.diag(np.diag(cov))
        if np.count_nonzero(off_diag) == 0:
            self._diag = np.sqrt(np.diag(cov))  # diagonal fast path (:203-211)
            return
        try:
            self._full = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            self._fallback("covariance is not positive definite")

    def _fallback(self, reason):
        warnings.warn(
            f"MetropolisHastingsMove: {reason}; falling back to identity "
            "proposal covariance (cf. MetropolisHastings.h:314-333)"
        )
        self.fell_back_to_identity = True
        self._diag = None
        self._full = None

    def init_state(self, n_params, dtype, device):
        def tensor(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        if self._full is not None:
            if self._full.shape[0] != n_params:
                raise ValueError("covariance dimension != n_params")
            return {"chol": tensor(self._full)}
        if self._diag is not None:
            if self._diag.shape[0] != n_params:
                raise ValueError("covariance dimension != n_params")
            return {"diag": tensor(self._diag)}
        return {"diag": tensor(np.ones(n_params))}

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        return (normal(gen, (n, p), dtype, device),)

    def propose(self, active, other, state, normals, row0=0):
        if "chol" in state:
            step = normals @ state["chol"].T
        else:
            step = normals * state["diag"][None, :]
        return active + self.scale * step, torch.zeros_like(active[:, 0])
