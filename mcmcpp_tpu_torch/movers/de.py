"""Ter Braak differential-evolution (DE-MC) move.

PyTorch counterpart of ``mcmcpp_tpu/movers/de.py``
(``MCMCpp/Movers/DifferentialEvolution.h:113-149``):
Y = X + γ·(X₁ − X₂) + U(−b, b)^P with distinct complementary walkers
X₁ ≠ X₂, γ = 2.38/√(2P) by default, b = 1e-4. Symmetric proposal, so the
factor is 0. The jitter is drawn as U[0, 1) and mapped to [−b, b) as
``jax.random.uniform(minval, maxval)`` maps it: max(−b, u·(b − (−b)) + (−b)).
"""

import functools

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.partner import (
    check_mode,
    draw_partner_noise,
    select_partners,
)
from mcmcpp_tpu_torch.ops.random import uniform


@functools.lru_cache(maxsize=64)
def _default_gamma(p):
    """2.38/√(2P) in float32, as JAX evaluates 2.38 / jnp.sqrt(2.0 * p)."""
    return float(torch.tensor(2.38) / torch.sqrt(torch.tensor(2.0 * p)))


class DifferentialEvolutionMove(Mover):
    """``partner_mode``: "roll" (two distinct shared shifts), "block" or
    "gather" (a distinct pair per walker); see ``ops/partner.py``.
    ``noise`` is ``(partners, u (n, P), log_u)``."""

    def __init__(self, gamma=None, jitter=1e-4, partner_mode="roll"):
        self.gamma = None if gamma is None else float(gamma)
        self.jitter = float(jitter)
        self.partner_mode = check_mode(partner_mode)
        # the jitter's span in float32, as JAX's maxval − minval
        self._span = float(torch.tensor(self.jitter)
                           - torch.tensor(-self.jitter))

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        return (draw_partner_noise(gen, n, m, 2, self.partner_mode, device),
                uniform(gen, (n, p), dtype, device))

    def propose(self, active, other, state, partners, u, row0=0):
        n, p = active.shape
        gamma = self.gamma if self.gamma is not None else _default_gamma(p)
        x1, x2 = select_partners(other, n, partners, self.partner_mode, row0)
        lo = -self.jitter
        noise = torch.clamp(u * self._span + lo, min=lo)
        proposal = active + gamma * (x1 - x2) + noise
        return proposal, torch.zeros_like(active[:, 0])
