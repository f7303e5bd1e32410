"""No-U-Turn Sampler: iterative, multinomial, fixed max depth, in lockstep.

PyTorch counterpart of ``mcmcpp_tpu/gradient/nuts.py``: an outer loop over
tree doublings and an inner loop over the 2^depth leapfrog leaves of each new
subtree, with U-turn checks against O(log n) stored checkpoints. For leaf
``n`` the active-subtree left endpoints live at checkpoint slots
[idx_min, idx_max] with

    idx_max = popcount(n >> 1)
    idx_min = idx_max - popcount(n & ~(n+1)) + 1   (trailing ones)

even leaves store slot ``idx_max``; odd leaves test every slot in that range.
Proposals are drawn progressively with multinomial weights exp(H − H0) and
the outer merge is biased (Betancourt 2017).

JAX vmaps two ``while_loop``s over the chains: the batch runs until every
chain has stopped, and a stopped chain's carry is frozen. Here the whole
batch runs in lockstep the same way, with the per-chain stop flags as masks.
The leaf counter and the depth are equal across the chains still running,
so they (and the checkpoint slots) are host ints; each loop's "is any chain
still running" test waits for the device, once per doubling after the first
and once before each even leaf after a subtree's first (U-turns stop chains
at odd leaves; a leaf run after every chain has stopped is a masked no-op):
:attr:`NUTSKernel.host_syncs` counts them.

Noise of one transition: the momentum's normals ``z (C, P)``, the direction
bits ``(C, D)``, the merge uniforms ``(C, D)`` and the leaf uniforms
``(C, D, 2^(D-1))``: doubling d, leaf j of chain c uses ``[c, d, j]``, which
is where JAX's key chain of that chain puts them (``nuts.py:103``, ``:162``).

Sharded (``mesh=``), each rank's loops test "any chain running" over every
rank's chains (a MAX all-reduce, ``layout.any``), so all ranks run the
doublings and leaves the unsharded batch runs, a rank whose chains have all
stopped running them masked.
"""

import torch

from mcmcpp_tpu_torch.gradient.hmc import (
    GradientKernel,
    GradientSampler,
    HMCState,
    _logaddexp,
    logp_and_grad,
)
from mcmcpp_tpu_torch.gradient.metric import (
    mass_kinetic,
    mass_momentum,
    mass_velocity,
)
from mcmcpp_tpu_torch.ops.random import bernoulli, normal, uniform


def _uturn(dq, p_a, p_b, inv_mass):
    """Generalized U-turn test on a segment with displacement dq (time
    order a→b), over the last axis: dq·(M⁻¹p) < 0 at either end."""
    return ((torch.sum(dq * mass_velocity(inv_mass, p_a), dim=-1) < 0.0)
            | (torch.sum(dq * mass_velocity(inv_mass, p_b), dim=-1) < 0.0))


def _where(mask, a, b):
    """Per-chain ``where`` over tuples of (C, ...) tensors."""
    return tuple(torch.where(mask.view(-1, *([1] * (x.ndim - 1))), x, y)
                 for x, y in zip(a, b))


class NUTSKernel(GradientKernel):
    """Multinomial NUTS with checkpointed U-turns (≙ ``nuts.py:51-211``).

    ``apply`` returns ``(state, (accept_stat, moved, diverging, energy))``:
    ``accept_stat`` is the mean Metropolis statistic over visited leaves
    (it drives dual averaging), ``diverging`` flags a tree whose build
    stopped on an energy error beyond ``max_delta_energy``, ``energy`` the
    post-refresh Hamiltonian.
    """

    def __init__(self, logp_fn, max_depth=10, max_delta_energy=1000.0):
        super().__init__(logp_fn)
        self.max_depth = int(max_depth)
        self.max_delta_energy = float(max_delta_energy)
        #: host syncs taken by ``apply`` so far (the loops' "any chain
        #: running" tests); leapfrog steps (gradients) taken so far
        self.host_syncs = 0
        self.leapfrogs = 0

    def draw_noise(self, gen, state, host_gen=None):
        q = state.position
        c, d, dev = q.shape[0], self.max_depth, q.device
        return (normal(gen, q.shape, q.dtype, dev),
                bernoulli(gen, (c, d), dev),
                uniform(gen, (c, d), q.dtype, dev),
                uniform(gen, (c, d, 1 << (d - 1)), q.dtype, dev))

    def _any(self, mask):
        """"Is any chain still running", of every rank's chains when
        sharded (so that all ranks take the same iterations)."""
        self.host_syncs += 1
        if self.shard is not None:
            return self.shard[0].any(mask)
        return bool(mask.any())

    def apply(self, noise, state, step_size, inv_mass):
        z, go_right_all, merge_u, leaf_u = noise
        q0, lp0, g0 = state
        dtype = q0.dtype
        p0 = mass_momentum(inv_mass, z)
        h0 = lp0 - mass_kinetic(inv_mass, p0)
        # the logs of every uniform of the transition, in two launches
        log_merge_u, log_leaf_u = torch.log(merge_u), torch.log(leaf_u)
        left = right = (q0, p0, lp0, g0)  # phase-space points (q, p, lp, g)
        prop = (q0, lp0, g0)
        logw = torch.zeros_like(lp0)  # the initial point has weight exp(0)
        sum_acc = torch.zeros_like(lp0)
        n_leaf = torch.zeros_like(lp0)
        turning = torch.zeros_like(lp0, dtype=torch.bool)
        diverging = torch.zeros_like(turning)
        active = ~turning
        for depth in range(self.max_depth):
            if depth and not self._any(active):
                break
            go_right = go_right_all[:, depth]
            direction = torch.where(go_right, 1.0, -1.0).to(dtype)
            edge = _where(go_right, right, left)
            (far, sub_prop, sub_logw, sub_acc, sub_n, sub_turn,
             sub_div) = self._subtree(edge, direction, step_size, inv_mass,
                                      h0, depth, log_leaf_u[:, depth], active)
            # the outer body, for the chains still building their tree
            valid = ~sub_turn & ~sub_div
            take = valid & (log_merge_u[:, depth] < sub_logw - logw)
            new_left = _where(valid & ~go_right, far, left)
            new_right = _where(valid & go_right, far, right)
            tree_turn = _uturn(new_right[0] - new_left[0], new_left[1],
                               new_right[1], inv_mass)
            (sum_acc, n_leaf, prop, logw, left, right, turning,
             diverging) = (
                torch.where(active, sum_acc + sub_acc, sum_acc),
                torch.where(active, n_leaf + sub_n, n_leaf),
                _where(active & take, sub_prop, prop),
                torch.where(active & valid,
                            _logaddexp(logw, sub_logw), logw),
                _where(active, new_left, left),
                _where(active, new_right, right),
                torch.where(active, sub_turn | (valid & tree_turn), turning),
                torch.where(active, sub_div, diverging))
            active = active & ~turning & ~diverging
        accept_stat = sum_acc / torch.clamp_min(n_leaf, 1.0)
        moved = torch.any(prop[0] != q0, dim=-1)
        return HMCState(*prop), (accept_stat, moved, diverging, -h0)

    def _subtree(self, edge, direction, step_size, inv_mass, h0, depth,
                 log_leaf_u, live):
        """Add up to 2^depth leaves from ``edge`` in ``direction`` for the
        ``live`` chains. Returns (far point, proposal, log weight, summed
        accept statistic, leaves taken, turning, diverging).

        A chain that stops early (a U-turn or a divergence) keeps
        integrating, masked: only its accept statistic, leaf count and stop
        flags are frozen, since the outer merge reads nothing else of a
        subtree that turned or diverged. Every other launch a leaf saves is
        host time, which bounds a leaf at small batches."""
        q, p, lp, g = edge
        c, n_params = q.shape
        eps = (direction * step_size)[:, None]
        half = 0.5 * eps
        prop = (q, lp, g)  # placeholder: its weight is exp(-inf)
        logw = torch.full_like(lp, -torch.inf)
        sum_acc = torch.zeros_like(lp)
        n_leaf = torch.zeros_like(lp)
        turning = torch.zeros_like(live)
        diverging = torch.zeros_like(live)
        ckpt_q = q.new_zeros((c, self.max_depth + 1, n_params))
        ckpt_p = q.new_zeros((c, self.max_depth + 1, n_params))
        for leaf in range(1 << depth):
            # U-turns stop chains at odd leaves only, so the "any chain
            # still running" test waits for the device before even ones; a
            # leaf run after every chain stopped changes nothing
            if leaf and leaf % 2 == 0 and not self._any(live):
                break
            # one leapfrog step
            p = torch.addcmul(p, half, g)
            q = torch.addcmul(q, eps, mass_velocity(inv_mass, p))
            lp, g = logp_and_grad(self.logp_fn, q)
            p = torch.addcmul(p, half, g)
            self.leapfrogs += 1
            # the leaf's log weight H − H0, a NaN as −inf
            logw_leaf = torch.nan_to_num(
                (lp - mass_kinetic(inv_mass, p)) - h0, nan=-torch.inf,
                posinf=torch.inf, neginf=-torch.inf)
            div_leaf = logw_leaf < -self.max_delta_energy
            # progressive multinomial sampling within the subtree
            logw_new = _logaddexp(logw, logw_leaf)
            take = live & (log_leaf_u[:, leaf] < logw_leaf - logw_new)
            prop = _where(take, (q, lp, g), prop)
            # checkpoint store (even leaf) / U-turn test (odd leaf) against
            # the slots in [idx_min, idx_max], the range mask as a slice
            idx_max = bin(leaf >> 1).count("1")
            if leaf % 2 == 0:
                ckpt_q[:, idx_max] = q
                ckpt_p[:, idx_max] = p
                stop = div_leaf
            else:
                idx_min = idx_max - bin(leaf & ~(leaf + 1)).count("1") + 1
                span = slice(idx_min, idx_max + 1)
                dq = direction[:, None, None] * (q[:, None, :]
                                                 - ckpt_q[:, span])
                turn = torch.any(_uturn(dq, ckpt_p[:, span], p[:, None, :],
                                        inv_mass), dim=-1)
                turning = turning | (live & turn)
                stop = turn | div_leaf
            sum_acc = sum_acc + torch.where(
                live, torch.clamp_max(torch.exp(logw_leaf), 1.0), 0.0)
            n_leaf = n_leaf + live
            logw = logw_new
            diverging = torch.where(live, div_leaf, diverging)
            live = live & ~stop
        return (q, p, lp, g), prop, logw, sum_acc, n_leaf, turning, diverging


def nuts_kernel(logp_fn, max_depth=10, max_delta_energy=1000.0):
    """The batched NUTS transition (≙ ``mcmcpp_tpu.gradient.nuts_kernel``)."""
    return NUTSKernel(logp_fn, max_depth, max_delta_energy)


class NUTSSampler(GradientSampler):
    """NUTS with dual-averaged step size + mass adaptation
    (``metric="diag"`` or ``"dense"``, see GradientSampler)."""

    def __init__(self, *args, max_depth=10, **kwargs):
        self.max_depth = int(max_depth)
        super().__init__(*args, **kwargs)

    def _make_kernel(self):
        return nuts_kernel(self.logp_fn, self.max_depth)
