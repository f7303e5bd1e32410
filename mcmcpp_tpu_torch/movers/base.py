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

Sharded half-steps (``parallel/sharded.py``): each rank updates only its
rows of the active half, global rows row0…row0+n_local−1, against the whole
gathered other half. The noise is always drawn for the whole half, in the
unsharded order, from generators seeded alike on every rank, and
:meth:`Mover.noise_rows` cuts it to the rank's rows; ``apply(...,
row0=row0, layout=layout)`` then updates those rows. A row gets the draws it
gets unsharded, whatever the rank count, so a sharded run equals the
unsharded one bit for bit (where the logp's bits do not depend on the
batch). ``layout`` (a :class:`~mcmcpp_tpu_torch.parallel.mesh.WalkerLayout`)
is for movers whose number of draws depends on the data (the slice move's
loops): their loop tests are taken across the ranks.

``draw_rung_noise`` draws the noise of k independent half-steps at once,
stacked on a leading axis: what parallel tempering's ``torch.func.vmap`` of
``apply`` over the ladder takes (one partner draw, one z and one log u per
rung, as the JAX package's vmap over one key per rung has them).
"""

import torch

from mcmcpp_tpu_torch.ops.partner import partner_rows
from mcmcpp_tpu_torch.ops.random import neg_exponential


class Mover:
    """Base class: subclasses implement ``draw_proposal_noise`` and
    ``propose`` (or override ``draw_noise`` and ``apply``)."""

    #: movers that ignore the Metropolis test (diagnostic oracles) set this
    always_accept = False
    #: movers whose noise starts with partner draws set their partner mode
    partner_mode = None

    def init_state(self, n_params, dtype, device):
        """Optional per-mover static state (e.g. an MH Cholesky factor)."""
        return ()

    def draw_proposal_noise(self, gen, n, m, p, dtype, device):
        """Tuple of the random tensors ``propose`` consumes, for n active
        walkers of dimension p against m others."""
        raise NotImplementedError

    def propose(self, active, other, state, *proposal_noise, row0=0):
        """Return ``(proposal, extra_log_factor)`` for the active half.

        active: (n, P), global rows row0… of its half; other: (m, P);
        extra_log_factor: (n,) added to the log accept ratio (the stretch
        move's (P−1)·log z).
        """
        raise NotImplementedError

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        """Every random draw of one half-step, in a fixed order."""
        prop = self.draw_proposal_noise(gen, n, m, p, dtype, device)
        if self.always_accept:
            return tuple(prop)
        return (*prop, neg_exponential(gen, n, dtype, device))

    def noise_rows(self, noise, row0, n):
        """The noise of rows row0…row0+n−1 of a half-step from ``noise``,
        drawn for the whole half: each per-walker plane cut to the rows
        (a plane drawn per loop iteration, as a callable, too); the partner
        draws as :func:`~mcmcpp_tpu_torch.ops.partner.partner_rows` cuts
        them."""
        if self.partner_mode is None:
            return rows_of(noise, row0, n)
        partners, *rest = noise
        return (partner_rows(partners, self.partner_mode, row0, n),
                *rows_of(tuple(rest), row0, n))

    def draw_rung_noise(self, gen, k, n, m, p, device, dtype=torch.float32,
                        host_gen=None):
        """``draw_noise`` for k independent half-steps, each tensor stacked
        on a new leading axis of length k. This default draws them one after
        another; a mover may draw each plane for all k at once."""
        draws = [self.draw_noise(gen, n, m, p, device, dtype=dtype,
                                 host_gen=host_gen) for _ in range(k)]
        return stack_noise(draws)

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0, row0=0, layout=None):
        """One Metropolis update of the active half against the other half.

        ``beta`` tempers the target to π^β: log-probs stay raw and only the
        Δlogp term of the acceptance ratio is scaled. ``row0``: the active
        rows are global rows row0… of their half (a rank's shard; ``noise``
        cut to them by :meth:`noise_rows`); ``layout``: the ranks' layout of
        a sharded half-step (see the module docstring).
        """
        if self.always_accept:
            proposal, _ = self.propose(active, other, state, *noise,
                                       row0=row0)
            ones = torch.ones(active.shape[:1], dtype=torch.bool,
                              device=active.device)
            return proposal, logp_fn(proposal), ones
        *prop_noise, log_u = noise
        proposal, log_factor = self.propose(active, other, state, *prop_noise,
                                            row0=row0)
        prop_logp = logp_fn(proposal)
        log_ratio = log_factor + beta * (prop_logp - active_logp)
        accept = log_u < log_ratio
        new_active = torch.where(accept[:, None], proposal, active)
        new_logp = torch.where(accept, prop_logp, active_logp)
        return new_active, new_logp, accept


def rows_of(noise, row0, n):
    """Every tensor of a noise tree cut to rows row0…row0+n−1 of its
    leading axis; a callable ``f(j)`` giving a plane per loop iteration is
    wrapped to cut its plane; anything else (a Python int) as it is."""
    if isinstance(noise, (tuple, list)):
        return type(noise)(rows_of(x, row0, n) for x in noise)
    if isinstance(noise, torch.Tensor):
        return noise[row0:row0 + n]
    if callable(noise):
        return lambda j: noise(j)[row0:row0 + n]
    return noise


def stack_noise(draws):
    """A list of equally laid out noise tuples (tensors, nested tuples) as
    one tuple of tensors stacked on a new leading axis."""
    first = draws[0]
    if isinstance(first, (tuple, list)):
        return tuple(stack_noise([d[i] for d in draws])
                     for i in range(len(first)))
    return torch.stack(draws)
