"""DE-Snooker move (ter Braak & Vrugt 2008).

PyTorch counterpart of ``mcmcpp_tpu/movers/snooker.py``. For each active
walker X pick three distinct complementary walkers Z, Z1, Z2 and move along
the line through X and Z:

    e = (X − Z)/‖X − Z‖,   Y = X + γ_s·((Z1 − Z2)·e)·e,   γ_s = 2.38/√2

with the radial Jacobian factor (P−1)·(log‖Y − Z‖ − log‖X − Z‖). A
degenerate anchor (X == Z) proposes no move with factor 0, through guarded
``where``s so that no NaN is ever formed.
"""

import math

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.partner import (
    check_mode,
    draw_partner_noise,
    select_partners,
)


class DESnookerMove(Mover):
    """``gamma``: line-jump scale (paper default 2.38/√2 ≈ 1.683).
    ``partner_mode``: "roll", "block" or "gather"; see ``ops/partner.py``.
    ``noise`` is ``(partners, log_u)``."""

    def __init__(self, gamma=2.38 / math.sqrt(2.0), partner_mode="roll"):
        self.gamma = float(gamma)
        self.partner_mode = check_mode(partner_mode)

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        return (draw_partner_noise(gen, n, m, 3, self.partner_mode, device),)

    def propose(self, active, other, state, partners, row0=0):
        n, p = active.shape
        z, z1, z2 = select_partners(other, n, partners, self.partner_mode,
                                    row0)
        d = active - z
        norm2 = torch.sum(d * d, dim=1)
        safe = norm2 > 0
        inv_norm2 = torch.where(safe, 1.0 / torch.where(safe, norm2, 1.0),
                                0.0)
        proj = torch.sum((z1 - z2) * d, dim=1) * inv_norm2
        proposal = active + self.gamma * proj[:, None] * d
        ynorm2 = torch.sum((proposal - z) ** 2, dim=1)
        log_factor = torch.where(
            safe & (ynorm2 > 0),
            0.5 * (p - 1) * (torch.log(torch.where(ynorm2 > 0, ynorm2, 1.0))
                             - torch.log(torch.where(safe, norm2, 1.0))),
            0.0,
        )
        return proposal, log_factor
