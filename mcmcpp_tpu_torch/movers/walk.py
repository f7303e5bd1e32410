"""Goodman–Weare walk move.

PyTorch counterpart of ``mcmcpp_tpu/movers/walk.py``
(``MCMCpp/Movers/WalkMove.h:101-186``): choose S complementary walkers
without replacement, then propose Y = X + Σⱼ Nⱼ·(Xⱼ − X̄_S) with one scalar
normal Nⱼ per selected walker. The proposal is symmetric, so the Metropolis
factor is 0.

The S partners come from ``ops/partner.py`` in any mode. Their center X̄_S
is taken over partners from the other half, which a sharded half-step
gathers whole (``parallel/sharded.py``), so it needs no collective. Nothing
of size (n, m) is ever built: in gather mode the subsets are S
sorted-insertion draws per walker, O(n·S) memory (an (n, m) score matrix
would be 68 GB at W = 2^18, ``tests/test_movers.py:59-73``).
"""

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.partner import (
    check_mode,
    draw_partner_noise,
    select_partners,
)
from mcmcpp_tpu_torch.ops.random import normal


class WalkMove(Mover):
    """Walk move drawing ``n_samples`` complementary walkers (default 6,
    matching the reference tests, e.g.
    ``test/sequential/SkewedGaussian/WalkMove/src/main.cpp:35``).
    ``noise`` is ``(partners, normals (n, S), log_u)``."""

    def __init__(self, n_samples=6, partner_mode="roll"):
        if n_samples < 2:
            raise ValueError("WalkMove requires n_samples >= 2")
        self.n_samples = int(n_samples)
        self.partner_mode = check_mode(partner_mode)

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        s = self.n_samples
        if s > m:
            raise ValueError(
                f"WalkMove n_samples={s} exceeds complementary half size {m}"
            )
        return (draw_partner_noise(gen, n, m, s, self.partner_mode, device),
                normal(gen, (n, s), dtype, device))

    def propose(self, active, other, state, partners, normals, row0=0):
        n = active.shape[0]
        xs = select_partners(other, n, partners, self.partner_mode,
                             row0).transpose(0, 1)  # (n, S, P)
        center = torch.mean(xs, dim=1, keepdim=True)
        # one scalar normal per selected walker ≙ WalkMove.h:155-186
        step = torch.einsum("ns,nsp->np", normals, xs - center)
        return active + step, torch.zeros_like(active[:, 0])
