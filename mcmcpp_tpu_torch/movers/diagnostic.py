"""Diagnostic movers: the framework's statistical and deterministic oracles.

PyTorch counterpart of ``mcmcpp_tpu/movers/diagnostic.py``
(``MCMCpp/Movers/Diagnostic/``):

- :class:`AutoRegressiveMove` (AutoRegressiveMove.h:103-131): an AR(1)
  process per parameter, xₜ₊₁ = off + φ·xₜ + σ√(1−φ²)·N(0,1), whose
  integrated autocorrelation time is (1+φ)/(1−φ): ground truth for the ACT
  estimator (test/sequential/AcTime).
- :class:`SequenceMove` (SequenceMove.h:102-122): deterministic fixed-step
  increments, the InnerBenchmark harness.

Both always accept and ignore the complementary half and the logp. As in
JAX, they draw no log u: AR's noise is ``(normals (n, P),)`` and the
sequence's is ``()``.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.random import normal


class AutoRegressiveMove(Mover):
    """AR(1) diagnostic oracle: xₜ₊₁ = off + φxₜ + σ√(1−φ²)·N(0,1) per
    parameter, always accepted; analytic ACT τ = (1+φ)/(1−φ)
    (≙ ``MCMCpp/Movers/Diagnostic/AutoRegressiveMove.h:103-112``)."""

    always_accept = True

    def __init__(self, offsets, phis, variances):
        self.offsets = np.asarray(offsets, dtype=np.float64)
        self.phis = np.asarray(phis, dtype=np.float64)
        self.variances = np.asarray(variances, dtype=np.float64)
        if not (self.offsets.shape == self.phis.shape == self.variances.shape):
            raise ValueError("offsets, phis, variances must have equal shapes")
        if np.any(np.abs(self.phis) >= 1.0):
            raise ValueError("|phi| must be < 1 for stationarity")

    @property
    def true_act(self):
        """Analytic integrated autocorrelation time (1+φ)/(1−φ) per param."""
        return (1.0 + self.phis) / (1.0 - self.phis)

    def init_state(self, n_params, dtype, device):
        if self.phis.shape[0] != n_params:
            raise ValueError("AR parameter arrays must have length n_params")

        def tensor(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return {
            "off": tensor(self.offsets),
            "phi": tensor(self.phis),
            "sig": tensor(np.sqrt(self.variances * (1.0 - self.phis ** 2))),
        }

    def initial_positions(self, gen, n_walkers, dtype=torch.float32,
                          device="cuda"):
        """Walkers drawn from the stationary distribution
        (≙ AutoRegressiveMove.h:119-131)."""
        p = self.phis.shape[0]
        mean = torch.as_tensor(self.offsets / (1.0 - self.phis), dtype=dtype,
                               device=device)
        std = torch.as_tensor(np.sqrt(self.variances), dtype=dtype,
                              device=device)
        z = normal(gen, (n_walkers, p), dtype, device)
        return mean[None, :] + std[None, :] * z

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        return (normal(gen, (n, p), dtype, device),)

    def propose(self, active, other, state, z, row0=0):
        nxt = state["off"][None, :] + state["phi"][None, :] * active
        nxt = nxt + state["sig"][None, :] * z
        return nxt, torch.zeros_like(active[:, 0])


class SequenceMove(Mover):
    """Deterministic diagnostic oracle: adds fixed ``step_sizes`` each
    update, always accepted
    (≙ ``MCMCpp/Movers/Diagnostic/SequenceMove.h:102-122``)."""

    always_accept = True

    def __init__(self, step_sizes):
        self.step_sizes = np.asarray(step_sizes, dtype=np.float64)

    def init_state(self, n_params, dtype, device):
        if self.step_sizes.shape[0] != n_params:
            raise ValueError("step_sizes must have length n_params")
        return {"steps": torch.as_tensor(self.step_sizes, dtype=dtype,
                                         device=device)}

    def initial_positions(self, gen, n_walkers, dtype=torch.float32,
                          device="cuda"):
        """Zero-init, matching SequenceMove.h:122."""
        del gen
        return torch.zeros((n_walkers, self.step_sizes.shape[0]),
                           dtype=dtype, device=device)

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        return ()

    def propose(self, active, other, state, row0=0):
        return (active + state["steps"][None, :],
                torch.zeros_like(active[:, 0]))
