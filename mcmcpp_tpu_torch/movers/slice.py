"""Ensemble slice sampling (zeus-style differential slice move).

PyTorch counterpart of ``mcmcpp_tpu/movers/slice.py`` (Karamanis & Beutler
2021): each walker slice-samples along ``eta = mu·(X1 − X2)`` from a
distinct complementary pair, with Neal (2003) stepping-out and shrinking.
Every finished walker moves; a walker that hits the ``max_steps`` /
``max_shrink`` caps stays put.

JAX's two ``lax.while_loop``s are Python loops here, over whole-half
batches with per-walker masks: each iteration is one (stepping out: two)
batched logp evaluation, and the loop's test ``mask.any()`` is one host
sync per iteration. This is the one mover whose half-step waits on the
device. The shrink uniforms come one plane per iteration from the noise's
``shrink_uniforms(j) -> (n,)``, so only the planes a run needs are drawn
(all ``max_shrink`` planes up front would be 256 MB at n = 2^20); a walker
that is done ignores its later draws. ``loop_iterations`` counts the
iterations run, for a per-half-step average.

Sharded (``parallel/sharded.py``), a rank updates its rows only, and each
loop test is a MAX all-reduce of the rank's flag across the ranks
(``layout.any``): every rank runs the iterations the unsharded loop runs and
draws the same shrink planes, so the generators stay in step. A rank whose
rows are all done runs its extra iterations masked, which keeps their bits.
"""

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.partner import (
    check_mode,
    draw_partner_noise,
    select_partners,
)
from mcmcpp_tpu_torch.ops.random import exponential, uniform


class EnsembleSliceMove(Mover):
    """Differential-direction ensemble slice sampler.

    ``mu``: direction scale (1.0, the paper's default); ``max_steps``:
    stepping-out cap per side; ``max_shrink``: shrinking cap;
    ``partner_mode``: "roll", "block" or "gather". ``noise`` is
    ``(partners, exp (n,), u (n,), shrink_uniforms)``: the slice height is
    β·logp(X) − exp, the initial interval [−u, 1 − u).
    """

    def __init__(self, mu=1.0, max_steps=64, max_shrink=64,
                 partner_mode="roll"):
        self.mu = float(mu)
        self.max_steps = int(max_steps)
        self.max_shrink = int(max_shrink)
        self.partner_mode = check_mode(partner_mode)
        #: half-steps applied and loop iterations run (stepping out plus
        #: shrinking) since construction
        self.half_steps = 0
        self.loop_iterations = 0

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        def shrink_uniforms(j):
            return uniform(gen, n, dtype, device)

        return (draw_partner_noise(gen, n, m, 2, self.partner_mode, device),
                exponential(gen, n, dtype, device),
                uniform(gen, n, dtype, device),
                shrink_uniforms)

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0, row0=0, layout=None):
        partners, height_exp, u, shrink_uniforms = noise
        n = active.shape[0]
        x1, x2 = select_partners(other, n, partners, self.partner_mode, row0)
        any_row = ((lambda flag: bool(torch.any(flag))) if layout is None
                   else layout.any)
        eta = self.mu * (x1 - x2)

        def offset_logp(t):
            """Raw logp at ``active + t·eta`` for per-walker offsets t."""
            return logp_fn(active + t[:, None] * eta)

        y = beta * active_logp - height_exp

        # stepping out (Neal 2003), both ends, batched
        lo, hi = -u, 1.0 - u
        grow_lo = torch.ones((n,), dtype=torch.bool, device=active.device)
        grow_hi = grow_lo.clone()
        i = 0
        while i < self.max_steps and any_row(grow_lo | grow_hi):
            grow_lo = grow_lo & (beta * offset_logp(lo) > y)
            grow_hi = grow_hi & (beta * offset_logp(hi) > y)
            lo = torch.where(grow_lo, lo - 1.0, lo)
            hi = torch.where(grow_hi, hi + 1.0, hi)
            i += 1

        # shrinking
        z = torch.zeros_like(u)
        z_logp = active_logp
        done = torch.zeros((n,), dtype=torch.bool, device=active.device)
        j = 0
        while j < self.max_shrink and any_row(~done):
            xi = lo + (hi - lo) * shrink_uniforms(j)
            cand_logp = offset_logp(xi)
            ok = beta * cand_logp > y
            take = ~done & ok
            z = torch.where(take, xi, z)
            z_logp = torch.where(take, cand_logp, z_logp)
            # failed draws shrink their own side of the interval
            fail = ~done & ~ok
            lo = torch.where(fail & (xi < 0.0), xi, lo)
            hi = torch.where(fail & (xi >= 0.0), xi, hi)
            done = done | ok
            j += 1
        self.half_steps += 1
        self.loop_iterations += i + j

        new_active = torch.where(done[:, None], active + z[:, None] * eta,
                                 active)
        new_logp = torch.where(done, z_logp, active_logp)
        return new_active, new_logp, done
