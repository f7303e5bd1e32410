"""ChEES-HMC: adapted trajectory lengths, one trajectory for the whole batch.

PyTorch counterpart of ``mcmcpp_tpu/gradient/chees.py`` (Hoffman, Radul &
Sountsov 2021): plain fixed-length HMC whose trajectory length T is adapted by
Adam ascent on log T of the ChEES criterion
``¼ E[(‖q' − E q'‖² − ‖q − E q‖²)²]``. Every chain shares the same jittered
trajectory time ``2·u·T``, so the leapfrog count ``ceil(2·u·T/ε)`` is one
number for the batch.

Here that count is a host int: u comes from the sampler's CPU generator (the
Halton sequence during warmup), and ε and T are host floats. During warmup
they are adapted each step from the harmonic-mean acceptance and the ChEES
gradient, which are device values: warmup takes one host sync per step (both
fetched together), and the scalar adaptation (dual averaging on ε, Adam on
log T, both in float32 as in JAX) runs on the host. Sampling with a fixed T
takes none; ``continuous_adapt`` takes one per transition for the same reason.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.hmc import (
    GradientKernel,
    GradientSampler,
    HMCState,
    scalar,
    da_init,
    da_update,
    leapfrog,
    metropolis,
    select_state,
    welford_update_batch,
)
from mcmcpp_tpu_torch.gradient.metric import (
    mass_kinetic,
    mass_momentum,
    mass_velocity,
)
from mcmcpp_tpu_torch.ops.random import neg_exponential, normal


class AdamState(NamedTuple):
    """CPU float32 scalars ``m``, ``v`` and the step ``count``, a host int."""

    m: torch.Tensor
    v: torch.Tensor
    count: int


def adam_init():
    return AdamState(m=scalar(0.0), v=scalar(0.0), count=0)


def adam_step(a, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step; returns (delta to ADD for ascent, new state)."""
    count = a.count + 1
    m = b1 * a.m + (1 - b1) * grad
    v = b2 * a.v + (1 - b2) * grad ** 2
    tf = scalar(count)
    mhat = m / (1 - b1 ** tf)
    vhat = v / (1 - b2 ** tf)
    return lr * mhat / (torch.sqrt(vhat) + eps), AdamState(m, v, count)


def halton2(i):
    """Base-2 van der Corput radical inverse of the int ``i`` (or an int
    array) as float32 in (0, 1), offset half an ulp so that i = 0 does not
    give a zero-length trajectory (≙ ``chees.py:69-78``)."""
    b = np.asarray(i).astype(np.uint32)
    b = ((b & 0x55555555) << 1) | ((b >> 1) & 0x55555555)
    b = ((b & 0x33333333) << 2) | ((b >> 2) & 0x33333333)
    b = ((b & 0x0F0F0F0F) << 4) | ((b >> 4) & 0x0F0F0F0F)
    b = ((b & 0x00FF00FF) << 8) | ((b >> 8) & 0x00FF00FF)
    b = ((b & 0x0000FFFF) << 16) | ((b >> 16) & 0x0000FFFF)
    return (b.astype(np.float32) + np.float32(0.5)) * np.float32(2.0 ** -32)


def n_leapfrog(eps, traj_len, u, cap):
    """``clip(int32(ceil(2·u·T/ε)), 1, cap)`` in float32 arithmetic, a host
    int. The conversion saturates as XLA's does (NaN → 0, ±inf → the int32
    limits), so a NaN trajectory early in warmup takes one leapfrog step, as
    in JAX, instead of raising."""
    t = np.float32(2.0) * np.float32(u) * np.float32(traj_len)
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.ceil(t / np.float32(eps))
    r = 0.0 if np.isnan(r) else float(np.clip(r, -2.0 ** 31, 2.0 ** 31 - 1))
    return int(np.clip(r, 1, cap))


class CheesKernel(GradientKernel):
    """The whole-batch ChEES-HMC transition (≙ ``chees_batch_step``,
    ``chees.py:81-147``). Noise ``(z (C, P), log_u (C,))``; ``apply(noise,
    state, eps, inv_mass, traj_len, u)`` with ε, T and u host floats returns
    ``(state, (accept_prob, accepted, traj_grad, n_leap, diverging,
    energy))``, ``traj_grad`` the acceptance-weighted ChEES gradient
    estimate (a device scalar) and ``n_leap`` the leapfrog count."""

    def __init__(self, logp_fn, max_leapfrog=1024):
        super().__init__(logp_fn)
        self.max_leapfrog = int(max_leapfrog)

    def draw_noise(self, gen, state, host_gen=None):
        q = state.position
        return (normal(gen, q.shape, q.dtype, q.device),
                neg_exponential(gen, q.shape[0], q.dtype, q.device))

    def apply(self, noise, state, eps, inv_mass, traj_len, u):
        z, log_u = noise
        q0, lp0, g0 = state
        p0 = mass_momentum(inv_mass, z)
        kin0 = mass_kinetic(inv_mass, p0)
        n_leap = n_leapfrog(eps, traj_len, u, self.max_leapfrog)
        eps = float(np.float32(eps))
        q1, p1, lp1, g1 = leapfrog(self.logp_fn, q0, p0, g0, inv_mass, eps,
                                   n_leap)
        log_ratio = (lp1 - mass_kinetic(inv_mass, p1)) - (lp0 - kin0)
        accept_prob, accept, diverging = metropolis(log_ratio, log_u)
        energy = kin0 - lp0  # post-refresh Hamiltonian (E-BFMI statistic)
        # ChEES dT gradient estimate (paper eq. 6, acceptance-weighted):
        # centered squared-radius change x end-point velocity projection
        d0 = q0 - torch.mean(q0, dim=0)[None, :]
        d1 = q1 - torch.mean(q1, dim=0)[None, :]
        delta = torch.sum(d1 ** 2, dim=1) - torch.sum(d0 ** 2, dim=1)
        vel_proj = torch.sum(d1 * mass_velocity(inv_mass, p1), dim=1)
        wsum = torch.sum(accept_prob)
        per_chain = accept_prob * float(np.float32(u)) * delta * vel_proj
        traj_grad = torch.where(wsum > 0,
                                torch.sum(per_chain) / (wsum + 1e-20), 0.0)
        return (select_state(accept, HMCState(q1, lp1, g1), state),
                (accept_prob, accept, traj_grad, n_leap, diverging, energy))


def chees_batch_step(logp_fn, max_leapfrog=1024):
    """The whole-batch ChEES-HMC transition (≙ ``mcmcpp_tpu.gradient.
    chees_batch_step``)."""
    return CheesKernel(logp_fn, max_leapfrog)


class CheesHMCSampler(GradientSampler):
    """HMC with ChEES-adapted trajectory length and jittered trajectories.

    Warmup jointly adapts a SHARED step size by dual averaging on the
    harmonic-mean acceptance (default target 0.651), log T by Adam ascent on
    the ChEES gradient, and the mass matrix by Welford. Sampling then runs
    fixed-``traj_length`` jittered HMC, or, with ``continuous_adapt=True``,
    keeps adapting log T at a diminishing Adam rate
    ``adam_lr·(1 + t/adapt_t0)^-adapt_kappa`` (Roberts & Rosenthal 2007).
    """

    def __init__(self, logp_fn, n_chains, n_params, seed=0,
                 target_accept=0.651, init_traj_length=None,
                 max_leapfrog=1024, adam_lr=0.025, continuous_adapt=False,
                 adapt_kappa=0.6, adapt_t0=100.0, **kwargs):
        self.max_leapfrog = int(max_leapfrog)
        self.adam_lr = float(adam_lr)
        self.continuous_adapt = bool(continuous_adapt)
        self.adapt_kappa = float(adapt_kappa)
        self.adapt_t0 = float(adapt_t0)
        self._init_traj = init_traj_length
        self.traj_length = None  # set by warmup (or defaulted at first run)
        self._sadapt = None  # (log_traj, AdamState) when continuous_adapt
        super().__init__(logp_fn, n_chains, n_params, seed=seed,
                         target_accept=target_accept, **kwargs)

    def _make_kernel(self):
        return chees_batch_step(self.logp_fn, self.max_leapfrog)

    def _eps(self):
        """The shared step size, a host float (the mean of a per-chain one
        set by hand or by a checkpoint)."""
        return float(torch.mean(torch.as_tensor(self.step_size,
                                                dtype=torch.float32)))

    def _traj_or_default(self):
        if self.traj_length is not None:
            return self.traj_length
        if self._init_traj is not None:
            return float(self._init_traj)
        # one ~16-step trajectory at the current step size
        return 16.0 * self._eps()

    def _jitter(self):
        """u ~ U(0, 1) from the host generator, as float32."""
        return float(torch.rand((), generator=self._host_gen,
                                dtype=torch.float32))

    # -- warmup: joint (eps, T, mass) adaptation -----------------------------

    def warmup(self, n_steps, adapt_mass=True):
        self._require_state()
        adapt_mass = bool(adapt_mass and self.needs_mass)
        da = da_init(scalar(self._eps()))
        adam = adam_init()
        log_traj = torch.log(scalar(self._traj_or_default()))
        log_traj_avg = log_traj
        log_cap = float(torch.log(scalar(float(self.max_leapfrog))))
        wf = self._welford_init()
        state = self.state
        for i in range(int(n_steps)):
            inv_mass = (self._mass_from_welford(wf) if adapt_mass
                        else self.inv_mass)
            noise = self._kernel.draw_noise(self._step_gen, state)
            state, (ap, _, traj_grad, _, _, _) = self._kernel.apply(
                noise, state, float(torch.exp(da.log_step)), inv_mass,
                float(torch.exp(log_traj)), float(halton2(i)))
            if adapt_mass:
                wf = welford_update_batch(wf, state.position)
            # harmonic-mean acceptance (dominated by the worst chains) and
            # the ChEES gradient: the step's one host sync
            hm_accept, traj_grad = torch.stack([
                1.0 / torch.mean(1.0 / torch.clamp_min(ap, 1e-10)),
                traj_grad]).cpu().float().unbind()
            da = da_update(da, hm_accept, target=self.target_accept)
            # Adam ascent on log T, then iterate-average like dual averaging
            delta, adam = adam_step(adam, traj_grad * torch.exp(log_traj),
                                    lr=self.adam_lr)
            # T below one step is meaningless
            log_traj = torch.clamp(log_traj + delta, da.log_step,
                                   da.log_step + log_cap)
            eta = float(scalar(adam.count) ** -0.75)
            log_traj_avg = eta * log_traj + (1 - eta) * log_traj_avg
        self.state = state
        self.step_size = float(torch.exp(da.log_step_avg))  # shared scalar
        self.traj_length = float(torch.exp(log_traj_avg))
        self._sadapt = None  # continuous adaptation restarts from here
        if adapt_mass:
            self.inv_mass = self._mass_from_welford(wf)
        return self

    # -- sampling ------------------------------------------------------------

    def current_traj_length(self):
        """Trajectory length in effect now (tracks ``continuous_adapt``)."""
        if self.continuous_adapt and self._sadapt is not None:
            return float(torch.exp(self._sadapt[0]))
        return self._traj_or_default()

    def _run_chunk(self, take, thin, step_size):
        if self.continuous_adapt and self._sadapt is None:
            self._sadapt = (torch.log(scalar(self._traj_or_default())),
                            adam_init())
        return super()._run_chunk(take, thin, step_size)

    def _run_step(self, state, step_size, inv_mass):
        eps = self._eps()
        u = self._jitter()
        noise = self._kernel.draw_noise(self._step_gen, state)
        if not self.continuous_adapt:
            state, (ap, acc, _, _, div, en) = self._kernel.apply(
                noise, state, eps, inv_mass, self._traj_or_default(), u)
            return state, (ap, acc, div, en)
        log_traj, adam = self._sadapt
        state, (ap, acc, traj_grad, _, div, en) = self._kernel.apply(
            noise, state, eps, inv_mass, float(torch.exp(log_traj)), u)
        # diminishing Adam ascent on log T (one host sync: the gradient);
        # the t0 horizon keeps the early rate near adam_lr while t^-kappa
        # still drives it to zero
        lr_t = self.adam_lr * float(
            (1.0 + scalar(adam.count) / self.adapt_t0) ** (-self.adapt_kappa))
        delta, adam = adam_step(adam, traj_grad.cpu().float()
                                * torch.exp(log_traj), lr=lr_t)
        lo = torch.log(scalar(eps))
        log_traj = torch.clamp(
            log_traj + delta, lo,
            lo + float(torch.log(scalar(float(self.max_leapfrog)))))
        self._sadapt = (log_traj, adam)
        return state, (ap, acc, div, en)
