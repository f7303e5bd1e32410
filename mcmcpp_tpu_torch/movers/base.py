"""Mover interface: batched propose + Metropolis accept over one half-ensemble.

PyTorch counterpart of ``mcmcpp_tpu/movers/base.py``. The JAX
``update_half(key, ...)`` is split in two:

    noise = mover.draw_noise(gen, n, m, p, device)   # all random draws
    mover.apply(active, active_logp, other, logp_fn, state, noise, beta)
        -> (new_active, new_logp, accept_mask)       # deterministic

so a test can hand the port the JAX package's own random numbers. For movers
built on :meth:`propose`, ``noise`` is ``(*proposal_noise, log_u)`` with
log u = −Exp(1) (≙ ``getNegExponentialReal()``,
``MCMCpp/Utility/MultiSampler.h:86``); the walker moves iff
``log_u < log_ratio`` (strict), with the branchless select that replaces
``Walker::jumpToNewPointSwap`` / ``stayAtCurrentPoint``
(``MCMCpp/Walker/Walker.h:105,173``). Movers that always accept (the
diagnostic oracles) draw no log u, as in JAX, so their noise is
``proposal_noise`` alone.

``draw_noise`` also takes ``host_gen``, a CPU generator for the draws that
decide host-side control flow (the mixture's branch); movers that make none
ignore it.

``draw_rung_noise`` draws the noise of k independent half-steps at once,
stacked on a leading axis: what parallel tempering's ``torch.func.vmap`` of
``apply`` over the ladder takes (one partner draw, one z and one log u per
rung, as the JAX package's vmap over one key per rung has them).
"""

import torch

from mcmcpp_tpu_torch.ops.random import neg_exponential


class Mover:
    """Base class: subclasses implement ``draw_proposal_noise`` and
    ``propose`` (or override ``draw_noise`` and ``apply``)."""

    #: movers that ignore the Metropolis test (diagnostic oracles) set this
    always_accept = False

    def init_state(self, n_params, dtype, device):
        """Optional per-mover static state (e.g. an MH Cholesky factor)."""
        return ()

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        """Tuple of the random tensors ``propose`` consumes, for n active
        walkers of dimension p against m others."""
        raise NotImplementedError

    def propose(self, active, other, state, *proposal_noise):
        """Return ``(proposal, extra_log_factor)`` for the active half.

        active: (n, P); other: (m, P); extra_log_factor: (n,) added to the
        log accept ratio (the stretch move's (P−1)·log z).
        """
        raise NotImplementedError

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        """Every random draw of one half-step, in a fixed order."""
        prop = self.draw_proposal_noise(gen, n, m, p, dtype, device)
        if self.always_accept:
            return tuple(prop)
        return (*prop, neg_exponential(gen, n, dtype, device))

    def draw_rung_noise(self, gen, k, n, m, p, device, dtype=torch.float32,
                        host_gen=None):
        """``draw_noise`` for k independent half-steps, each tensor stacked
        on a new leading axis of length k. This default draws them one after
        another; a mover may draw each plane for all k at once."""
        draws = [self.draw_noise(gen, n, m, p, device, dtype=dtype,
                                 host_gen=host_gen) for _ in range(k)]
        return stack_noise(draws)

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0):
        """One Metropolis update of the active half against the other half.

        ``beta`` tempers the target to π^β: log-probs stay raw and only the
        Δlogp term of the acceptance ratio is scaled.
        """
        if self.always_accept:
            proposal, _ = self.propose(active, other, state, *noise)
            ones = torch.ones(active.shape[:1], dtype=torch.bool,
                              device=active.device)
            return proposal, logp_fn(proposal), ones
        *prop_noise, log_u = noise
        proposal, log_factor = self.propose(active, other, state, *prop_noise)
        prop_logp = logp_fn(proposal)
        log_ratio = log_factor + beta * (prop_logp - active_logp)
        accept = log_u < log_ratio
        new_active = torch.where(accept[:, None], proposal, active)
        new_logp = torch.where(accept, prop_logp, active_logp)
        return new_active, new_logp, accept


def stack_noise(draws):
    """A list of equally laid out noise tuples (tensors, nested tuples) as
    one tuple of tensors stacked on a new leading axis."""
    first = draws[0]
    if isinstance(first, (tuple, list)):
        return tuple(stack_noise([d[i] for d in draws])
                     for i in range(len(first)))
    return torch.stack(draws)
