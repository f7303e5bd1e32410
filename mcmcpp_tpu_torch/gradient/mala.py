"""Metropolis-adjusted Langevin algorithm (MALA).

PyTorch counterpart of ``mcmcpp_tpu/gradient/mala.py``. Proposal
Y = X + (ε²/2)·M⁻¹∇logp(X) + ε·M^{-1/2}·ξ, ξ ~ N(0, I), with the
asymmetric-proposal Hastings correction; one gradient per step.
"""

from mcmcpp_tpu_torch.gradient.hmc import (
    GradientKernel,
    GradientSampler,
    HMCState,
    column,
    logp_and_grad,
    metropolis,
    select_state,
)
from mcmcpp_tpu_torch.gradient.metric import (
    mass_noise,
    mass_quad_inv,
    mass_velocity,
)
from mcmcpp_tpu_torch.ops.random import neg_exponential, normal


class MALAKernel(GradientKernel):
    """Noise ``(z (C, P), log_u (C,))`` (≙ ``mala.py:28-58``). ``energy`` is
    a pseudo-Hamiltonian with the whitened proposal noise as momentum."""

    def draw_noise(self, gen, state, host_gen=None):
        q = state.position
        return (normal(gen, q.shape, q.dtype, q.device),
                neg_exponential(gen, q.shape[0], q.dtype, q.device))

    def apply(self, noise, state, step_size, inv_mass):
        z, log_u = noise
        eps2 = step_size ** 2
        half = 0.5 * column(eps2)
        position, logp, grad = state
        # q(x_to | x_from) ∝ exp(−‖x_to − x_from − (ε²/2)M⁻¹g‖²_M / (2ε²))
        fwd_mean = position + half * mass_velocity(inv_mass, grad)
        proposal = fwd_mean + column(step_size) * mass_noise(inv_mass, z)
        lp_new, g_new = logp_and_grad(self.logp_fn, proposal)
        rev_mean = proposal + half * mass_velocity(inv_mass, g_new)
        # log q(x | y) − log q(y | x)
        log_ratio = (
            lp_new - logp
            - mass_quad_inv(inv_mass, position - rev_mean) / (2.0 * eps2)
            + mass_quad_inv(inv_mass, proposal - fwd_mean) / (2.0 * eps2))
        accept_prob, accept, diverging = metropolis(log_ratio, log_u)
        energy = 0.5 * (z * z).sum(dim=-1) - logp
        return (select_state(accept, HMCState(proposal, lp_new, g_new), state),
                (accept_prob, accept, diverging, energy))


def mala_kernel(logp_fn):
    """The batched MALA transition (≙ ``mcmcpp_tpu.gradient.mala_kernel``)."""
    return MALAKernel(logp_fn)


class MALASampler(GradientSampler):
    """MALA with dual-averaged step size (target accept ≈ 0.574 optimal)."""

    def __init__(self, *args, target_accept=0.574, **kwargs):
        kwargs["target_accept"] = target_accept
        super().__init__(*args, **kwargs)

    def _make_kernel(self):
        return mala_kernel(self.logp_fn)
