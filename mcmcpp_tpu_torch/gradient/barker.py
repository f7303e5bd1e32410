"""Barker proposal MCMC (Livingstone & Zanella 2022, JRSS-B).

PyTorch counterpart of ``mcmcpp_tpu/gradient/barker.py``. A whitened increment
``z ~ N(0, ε²I)`` keeps the sign of coordinate ``i`` with probability
``σ(z_i · (Cᵀg)_i)``, ``C`` the noise map of the metric, so moves aligned with
the gradient are favoured; the increment density ``2·N(w; 0, ε²)·σ(w·g_w)``
gives the exact Hastings correction (the Gaussian factors cancel). Its
robustness to a too-large step is what makes unattended step-size
adaptation converge from almost any start.

Softplus is ``logaddexp(x, 0)`` as in JAX: ``torch.nn.functional.softplus``
turns linear above its threshold of 20 and would differ.
"""

import torch

from mcmcpp_tpu_torch.gradient.hmc import (
    GradientKernel,
    GradientSampler,
    HMCState,
    column,
    logp_and_grad,
    metropolis,
    select_state,
)
from mcmcpp_tpu_torch.gradient.metric import mass_noise, mass_noise_t
from mcmcpp_tpu_torch.ops.random import neg_exponential, normal, uniform


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class BarkerKernel(GradientKernel):
    """Noise ``(z (C, P), u (C, P), log_u (C,))``: the increment's standard
    normals, the sign-flip uniforms and −Exp(1) (≙ ``barker.py:42-75``)."""

    def draw_noise(self, gen, state, host_gen=None):
        q = state.position
        return (normal(gen, q.shape, q.dtype, q.device),
                uniform(gen, tuple(q.shape), q.dtype, q.device),
                neg_exponential(gen, q.shape[0], q.dtype, q.device))

    def apply(self, noise, state, step_size, inv_mass):
        z_std, u, log_u = noise
        eps = column(step_size)
        position, logp, grad = state
        z = eps * z_std
        g_w = mass_noise_t(inv_mass, grad)  # gradient in whitened coords
        # P(keep sign of z_i) = sigmoid(z_i * g_w_i)
        w = torch.where(u < torch.sigmoid(z * g_w), 1.0, -1.0) * z
        proposal = position + mass_noise(inv_mass, w)
        lp_new, g_new = logp_and_grad(self.logp_fn, proposal)
        g_w_new = mass_noise_t(inv_mass, g_new)
        # log q(x'|x) = Σ[log 2 + log N(w_i) − softplus(−w_i·g_w_i)]; the
        # reverse move is −w with the gradient at x'
        log_ratio = lp_new - logp + torch.sum(
            _softplus(-w * g_w) - _softplus(w * g_w_new), dim=-1)
        accept_prob, accept, diverging = metropolis(log_ratio, log_u)
        # pseudo-Hamiltonian with the whitened increment as momentum
        energy = 0.5 * torch.sum((w / eps) ** 2, dim=-1) - logp
        return (select_state(accept, HMCState(proposal, lp_new, g_new), state),
                (accept_prob, accept, diverging, energy))


def barker_kernel(logp_fn):
    """The batched Barker transition (≙ ``mcmcpp_tpu.gradient.
    barker_kernel``)."""
    return BarkerKernel(logp_fn)


class BarkerSampler(GradientSampler):
    """Barker proposal with dual-averaged step size; ``target_accept=0.4``,
    the efficiency plateau of Vogrinc, Livingstone & Zanella (2022)."""

    def __init__(self, *args, target_accept=0.4, **kwargs):
        kwargs["target_accept"] = target_accept
        super().__init__(*args, **kwargs)

    def _make_kernel(self):
        return barker_kernel(self.logp_fn)
