"""Goodman–Weare stretch move, batched over the half-ensemble.

PyTorch counterpart of ``mcmcpp_tpu/movers/stretch.py``
(``MCMCpp/Movers/StretchMove.h:100-117``): each active walker X pairs with a
complementary walker Xk, draws z ~ g(z), proposes Y = Xk + z·(X − Xk) and
accepts with probability min(1, z^{P-1}·p(Y)/p(X)). Plain torch: the JAX
version is plain XLA.
"""

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.gw import gw_sample
from mcmcpp_tpu_torch.ops.partner import (
    check_mode,
    distinct_batch,
    draw_partner_noise,
    select_partners,
)
from mcmcpp_tpu_torch.ops.random import neg_exponential, uniform


class StretchMove(Mover):
    """Affine-invariant stretch move with scale ``a`` (default 2).

    ``partner_mode``: "roll" (default, one shared shift), "block" or
    "gather" (see ``ops/partner.py``). ``noise`` is ``(partners, u, log_u)``:
    the partner draws (in roll mode a (1,) int32 shift), (n,) uniforms for z
    and (n,) −Exp(1) draws for the accept test.
    """

    def __init__(self, a=2.0, partner_mode="roll"):
        self.a = float(a)
        self.partner_mode = check_mode(partner_mode)

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        return (draw_partner_noise(gen, n, m, 1, self.partner_mode, device),
                uniform(gen, n, dtype, device))

    def draw_rung_noise(self, gen, k, n, m, p, device, dtype=torch.float32,
                        host_gen=None):
        """In roll mode, each plane for all k rungs in one draw: shifts
        (k, 1), u and log u (k, n)."""
        if self.partner_mode != "roll":
            return super().draw_rung_noise(gen, k, n, m, p, device, dtype,
                                           host_gen)
        if n != m:
            raise ValueError(f"roll mode requires equal halves (n={n}, m={m})")
        return (distinct_batch(gen, k, m, 1, device, torch.int32),
                uniform(gen, (k, n), dtype, device),
                neg_exponential(gen, (k, n), dtype, device))

    def propose(self, active, other, state, partners, u, row0=0):
        n, p = active.shape
        partner = select_partners(other, n, partners, self.partner_mode,
                                  row0)[0]
        z = gw_sample(u, self.a)
        proposal = partner + z[:, None] * (active - partner)
        # (P-1)·log z term ≙ StretchMove.h:110
        return proposal, (p - 1) * torch.log(z)
