"""Goodman–Weare stretch move, batched over the half-ensemble.

PyTorch counterpart of ``mcmcpp_tpu/movers/stretch.py`` in its default roll
mode (``MCMCpp/Movers/StretchMove.h:100-117``): each active walker X pairs
with the complementary walker Xk of one shared shift, draws z ~ g(z),
proposes Y = Xk + z·(X − Xk) and accepts with probability
min(1, z^{P-1}·p(Y)/p(X)). Plain torch: the JAX version is plain XLA.
"""

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.gw import gw_sample
from mcmcpp_tpu_torch.ops.partner import distinct_shifts, select_partners
from mcmcpp_tpu_torch.ops.random import uniform


class StretchMove(Mover):
    """Affine-invariant stretch move with scale ``a`` (default 2).

    ``noise`` is ``(shift, u, log_u)``: a (1,) int32 shift, (n,) uniforms
    for z and (n,) −Exp(1) draws for the accept test.
    """

    def __init__(self, a=2.0, partner_mode="roll"):
        self.a = float(a)
        if partner_mode != "roll":
            raise NotImplementedError(
                f"partner mode {partner_mode!r} is not ported yet; use 'roll'"
            )
        self.partner_mode = partner_mode

    def draw_proposal_noise(self, gen, n, m, dtype, device):
        return (distinct_shifts(gen, m, 1, device),
                uniform(gen, n, dtype, device))

    def propose(self, active, other, state, shift, u):
        n, p = active.shape
        partner = select_partners(other, n, shift, self.partner_mode)[0]
        z = gw_sample(u, self.a)
        proposal = partner + z[:, None] * (active - partner)
        # (P-1)·log z term ≙ StretchMove.h:110
        return proposal, (p - 1) * torch.log(z)
