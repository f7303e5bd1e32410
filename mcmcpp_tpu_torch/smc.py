"""Sequential Monte Carlo with adaptive tempering.

PyTorch counterpart of ``mcmcpp_tpu/smc.py``. Particles are annealed from a
prior sample to the posterior along p_β ∝ prior · like^β (β: 0 → 1); per
stage:

1. the next β by 32 bisection steps on the ESS of the incremental weights
   (device-side ``torch.where`` steps, no host read),
2. systematic resampling (cumsum + searchsorted; the cumsum blocked so that
   its bits, and so a resumed run, do not vary between runs on CUDA),
3. mutation by ``n_mcmc`` red/black steps targeting p_β: ``"ensemble"``
   (any port mover; with :class:`~mcmcpp_tpu_torch.movers.fused.
   FusedStretchMove` each half-step runs the split CUDA kernels around the
   tempered logp), ``"mala"``, ``"hmc"`` (U(0.5, 1.5) step jitter) or
   ``"flow"`` (a forward-KL refit of a flow, warm-started across stages, then
   independence Metropolis from it).

Waste-free mode (``waste_free_k=K``, Dau & Chopin 2022) resamples M =
N/(K+1) seeds and keeps every ensemble their K mutation steps visit.

A stage is ``draw_stage_noise()`` (every random draw, in a fixed order)
and ``apply_stage(state, noise)`` (deterministic), so a test can hand the
port the JAX package's draws. The only host read a stage makes is β, for
``run()``'s stopping test. ``mesh=`` is not ported.
"""

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
from mcmcpp_tpu_torch.movers.stretch import StretchMove
from mcmcpp_tpu_torch.neutra import RealNVP, gaussian_logq
from mcmcpp_tpu_torch.optim import adam_init, adam_step
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    HOST_STREAM,
    STEP_STREAM,
    make_generator,
    neg_exponential,
)
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["SMCSampler", "SMCState", "StageNoise", "ess_from_log_weights",
           "systematic_resample"]

BISECTION_STEPS = 32
SCAN_BLOCK = 1024


class SMCState(NamedTuple):
    particles: torch.Tensor  # (N, P)
    log_prior: torch.Tensor  # (N,)
    log_like: torch.Tensor  # (N,)
    beta: torch.Tensor  # ()
    log_evidence: torch.Tensor  # ()


class StageNoise(NamedTuple):
    """Every draw of one stage: ``u0`` () the resampling offset, ``steps``
    one (red, black) pair of half-step draws per mutation step, ``fit`` the
    flow refit's (steps, batch) row indices (flow mutation only)."""

    u0: torch.Tensor
    steps: list
    fit: torch.Tensor = None


def ess_from_log_weights(log_w):
    """Effective sample size of normalized weights, in particles."""
    log_w = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2.0 * log_w, 0))


def _cumsum(x):
    """Inclusive prefix sum of the (n,) ``x`` whose bits do not vary from run
    to run. On CUDA, torch's cumsum of a 1-D float tensor is CUB's scan, whose
    float result can differ between runs (and a resumed SMC run would then
    resample other particles); the rows of a 2-D tensor are scanned by a
    fixed pattern. So: rows of SCAN_BLOCK, then the rows' totals, each as a
    2-D scan (a zero row keeps even one row off the 1-D path)."""

    def rows_cumsum(a):
        return torch.cat([a, torch.zeros_like(a[:1])]).cumsum(1)[:-1]

    n = x.shape[0]
    nb = -(-n // SCAN_BLOCK)
    padded = torch.cat([x, x.new_zeros(nb * SCAN_BLOCK - n)])
    inner = rows_cumsum(padded.view(nb, SCAN_BLOCK))
    totals = rows_cumsum(inner[None, :, -1])[0]
    offsets = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (inner + offsets[:, None]).reshape(-1)[:n]


def systematic_resample(u0, log_w, n):
    """Systematic resampling: (n,) int64 indices drawn ∝ weights, from the
    one uniform ``u0`` (≙ the JAX function's ``uniform(key, ())``)."""
    w = torch.exp(log_w - torch.logsumexp(log_w, 0))
    cum = _cumsum(w)
    cum = cum / cum[-1]
    pts = (u0 + torch.arange(n, dtype=cum.dtype, device=cum.device)) / n
    idx = torch.searchsorted(cum, pts, side="left")
    return torch.clamp(idx, max=cum.shape[0] - 1)


def _find_next_beta(log_like, beta, target_ess_frac, n):
    """Largest β' (32 bisection steps) keeping the incremental ESS at
    least target·N; 1 when β' = 1 keeps it."""
    target = target_ess_frac * n
    one = torch.ones_like(beta)

    def ess_at(b_new):
        return ess_from_log_weights((b_new - beta) * log_like)

    full = ess_at(one) >= target
    lo, hi = beta, one
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full, one, lo)


def _accept(log_u, log_ratio, new, old):
    """Per-row select of ``new`` where log u < log ratio, for each pair."""
    acc = log_u < log_ratio
    return tuple(torch.where(acc[:, None] if a.ndim == 2 else acc, a, b)
                 for a, b in zip(new, old))


class SMCSampler:
    """Adaptive-tempering SMC from prior to posterior (≙
    ``mcmcpp_tpu/smc.py::SMCSampler``; the options are the JAX package's).

    log_prior_fn, log_like_fn : (P,) -> scalar, or with ``batched=True``
        (n, P) -> (n,).
    prior_sample_fn : (gen, n) -> (n, P) prior draws, ``gen`` a generator
        on the sampler's device.
    mover : the ensemble mutation's mover (default StretchMove).
    flow : the flow mutation's flow (default ``RealNVP(n_params)``).
    device : default "cuda" (CUDA without a GPU raises).
    """

    def __init__(self, log_prior_fn, log_like_fn, prior_sample_fn, n_particles,
                 n_params, n_mcmc=5, target_ess=0.5, seed=0,
                 dtype=torch.float32, mover=None, waste_free_k=None,
                 mutation="ensemble", mala_scale=1.0, flow=None,
                 flow_fit_steps=150, flow_batch=256, flow_lr=1e-3,
                 hmc_steps=8, hmc_scale=0.5, batched=False, device="cuda"):
        if mutation not in ("ensemble", "mala", "flow", "hmc"):
            raise ValueError(f"unknown mutation {mutation!r}")
        self.device = resolve_device(device)
        self.mutation = mutation
        self.mala_scale = float(mala_scale)
        self.hmc_steps = int(hmc_steps)
        self.hmc_scale = float(hmc_scale)
        if self.hmc_steps < 1:
            raise ValueError("hmc_steps must be >= 1")
        self.log_prior_fn = log_prior_fn
        self.log_like_fn = log_like_fn
        self._log_prior = (log_prior_fn if batched
                           else torch.func.vmap(log_prior_fn))
        self._log_like = (log_like_fn if batched
                          else torch.func.vmap(log_like_fn))
        self.prior_sample_fn = prior_sample_fn
        self.n = int(n_particles)
        self.n_params = int(n_params)
        self.n_mcmc = int(n_mcmc)
        self.target_ess = float(target_ess)
        self.waste_free_k = None if waste_free_k is None else int(waste_free_k)
        if self.waste_free_k is not None:
            k = self.waste_free_k
            if k < 1:
                raise ValueError("waste_free_k must be >= 1")
            if self.n % (k + 1):
                raise ValueError(f"n_particles={self.n} not divisible by "
                                 f"waste_free_k+1={k + 1}")
            if (self.n // (k + 1)) % 2:
                raise ValueError(
                    f"waste-free seed count {self.n // (k + 1)} must be even "
                    "(stretch mutation uses halves)")
        self.dtype = dtype
        self.mover = mover if mover is not None else StretchMove()
        self._mover_state = self.mover.init_state(self.n_params, dtype,
                                                  self.device)
        self._flow = None
        self._flow_opt_state = None
        if mutation == "flow":
            self._flow = (flow if flow is not None
                          else RealNVP(self.n_params, dtype=dtype))
            self._flow.to(self.device)
            self._flow_fit_steps = int(flow_fit_steps)
            self._flow_batch = int(flow_batch)
            self._flow_lr = float(flow_lr)
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self._host_gen = make_generator(seed, HOST_STREAM, "cpu")
        self.state = None
        self.n_stages = 0
        self.beta_ladder = []

    @property
    def _flow_carry(self):
        """(flow parameters, Adam state), as the JAX package's carry."""
        if self._flow is None:
            return None
        return self._flow.param_list(), self._flow_opt_state

    def init(self):
        if self._flow is not None:
            params = self._flow.init(self._aux_gen)
            self._flow_opt_state = adam_init(params)
        particles = torch.as_tensor(
            self.prior_sample_fn(self._aux_gen, self.n)).to(self.device,
                                                            self.dtype)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        self.state = SMCState(particles, self._log_prior(particles),
                              self._log_like(particles), zero, zero.clone())
        return self

    # -- one stage: its draws, then the deterministic update ----------------

    def _seed_count(self):
        return (self.n if self.waste_free_k is None
                else self.n // (self.waste_free_k + 1))

    def _draw_half(self, n):
        gen, dev, dt, p = self._step_gen, self.device, self.dtype, self.n_params
        if self.mutation == "ensemble":
            return self.mover.draw_noise(gen, n, n, p, dev, dtype=dt,
                                         host_gen=self._host_gen)
        z = torch.randn((n, p), generator=gen, dtype=dt, device=dev)
        if self.mutation == "hmc":
            jitter = 0.5 + torch.rand((n,), generator=gen, dtype=dt,
                                      device=dev)
            return z, jitter, neg_exponential(gen, n, dt, dev)
        return z, neg_exponential(gen, n, dt, dev)

    def draw_stage_noise(self):
        """Every random draw of the next stage (:class:`StageNoise`)."""
        u0 = torch.rand((), generator=self._step_gen, dtype=self.dtype,
                        device=self.device)
        m = self._seed_count()
        fit = None
        if self.mutation == "flow":
            batch = min(self._flow_batch, m)
            fit = torch.randint(0, m, (self._flow_fit_steps, batch),
                                generator=self._step_gen, device=self.device)
        n_steps = (self.n_mcmc if self.waste_free_k is None
                   else self.waste_free_k)
        steps = [(self._draw_half(m // 2), self._draw_half(m - m // 2))
                 for _ in range(n_steps)]
        return StageNoise(u0, steps, fit)

    def _fit_flow(self, particles, idx):
        """The per-stage forward-KL refit on the resampled cloud, warm from
        the previous stage's parameters and Adam state."""
        params = self._flow.param_list()
        state = self._flow_opt_state
        with torch.enable_grad():
            for rows in idx:
                obj = torch.mean(gaussian_logq(self._flow, particles[rows],
                                               self.n_params))
                grads = torch.autograd.grad(obj, params)
                state = adam_step(params, [-g for g in grads], state,
                                  self._flow_lr)
        self._flow_opt_state = state

    def _mutation(self, resampled, beta_new, fit_idx):
        """(half_update, init_carry) of this stage's mutation:
        ``half_update(x, carry, noise) -> (x, carry)``, the carry holding
        the tempered logp first."""

        def tempered(x):
            return self._log_prior(x) + beta_new * self._log_like(x)

        if self.mutation == "ensemble":
            def ensemble_half(x, carry, noise, other):
                x, lp, _ = self.mover.apply(x, carry[0], other, tempered,
                                            self._mover_state, noise)
                return x, (lp,)

            return ensemble_half, lambda x, lp: (lp,)

        if self.mutation == "flow":
            self._fit_flow(resampled, fit_idx)
            flow, p = self._flow, self.n_params
            const = -0.5 * p * np.log(2.0 * np.pi)

            def flow_half(x, carry, noise, other):
                (lp0, lq0), (z, log_u) = carry, noise
                y, logdet = flow(z)
                lq1 = const - 0.5 * torch.sum(z * z, 1) - logdet
                lp1 = tempered(y)
                x, lp, lq = _accept(log_u, lp1 - lp0 + lq0 - lq1,
                                    (y, lp1, lq1), (x, lp0, lq0))
                return x, (lp, lq)

            return flow_half, lambda x, lp: (lp, gaussian_logq(flow, x, p))

        def vg(x):
            return logp_and_grad(tempered, x)

        init_grad = lambda x, lp: (lp, vg(x)[1])  # noqa: E731
        if self.mutation == "hmc":
            sd = torch.clamp(torch.std(resampled, 0, correction=0), min=1e-6)
            eps0 = self.hmc_scale * self.n_params ** (-0.25)
            ell = self.hmc_steps

            def hmc_half(x, carry, noise, other):
                (lp0, g0), (u0, jitter, log_u) = carry, noise
                es = (eps0 * jitter)[:, None] * sd[None, :]
                xq, uq = x, u0 + 0.5 * es * g0
                lp1, g1 = lp0, g0
                for i in range(ell):
                    xq = xq + es * uq
                    lp1, g1 = vg(xq)
                    uq = uq + (1.0 if i < ell - 1 else 0.5) * es * g1
                log_ratio = lp1 - lp0 + 0.5 * (torch.sum(u0 * u0, 1)
                                               - torch.sum(uq * uq, 1))
                x, lp, g = _accept(log_u, log_ratio, (xq, lp1, g1),
                                   (x, lp0, g0))
                return x, (lp, g)

            return hmc_half, init_grad

        s = (self.mala_scale * self.n_params ** (-1.0 / 6.0)
             * torch.clamp(torch.std(resampled, 0, correction=0), min=1e-6))
        drift = 0.5 * (s ** 2)[None, :]

        def mala_half(x, carry, noise, other):
            (lp0, g0), (z, log_u) = carry, noise
            y = x + drift * g0 + s[None, :] * z
            lp1, g1 = vg(y)
            fwd = -0.5 * torch.sum(((y - x - drift * g0) / s[None, :]) ** 2, 1)
            rev = -0.5 * torch.sum(((x - y - drift * g1) / s[None, :]) ** 2, 1)
            x, lp, g = _accept(log_u, lp1 - lp0 + rev - fwd, (y, lp1, g1),
                               (x, lp0, g0))
            return x, (lp, g)

        return mala_half, init_grad

    @torch.no_grad()
    def apply_stage(self, state, noise):
        """One adaptive stage from ``noise`` (:meth:`draw_stage_noise`):
        the next β, the evidence increment, resampling, mutation, and the
        log prior and likelihood of the new particles."""
        beta_new = _find_next_beta(state.log_like, state.beta,
                                   self.target_ess, self.n)
        log_w = (beta_new - state.beta) * state.log_like
        log_evidence = state.log_evidence + (
            torch.logsumexp(log_w, 0) - math.log(float(self.n)))
        m = self._seed_count()
        idx = systematic_resample(noise.u0, log_w, m)
        seeds = state.particles[idx]
        logp_t = state.log_prior[idx] + beta_new * state.log_like[idx]
        half_update, init_carry = self._mutation(seeds, beta_new, noise.fit)
        half = m // 2
        red, black = seeds[:half], seeds[half:]
        cr, cb = init_carry(red, logp_t[:half]), init_carry(black,
                                                            logp_t[half:])
        visited = [seeds]
        for nr, nb in noise.steps:
            red, cr = half_update(red, cr, nr, black)
            black, cb = half_update(black, cb, nb, red)
            if self.waste_free_k is not None:
                visited.append(torch.cat([red, black], 0))
        particles = (torch.cat([red, black], 0) if self.waste_free_k is None
                     else torch.cat(visited, 0))
        return SMCState(particles, self._log_prior(particles),
                        self._log_like(particles), beta_new, log_evidence)

    def run(self, max_stages=100):
        """Anneal β: 0 → 1. Returns self. Warns (and stops) if the adaptive
        step stalls or ``max_stages`` runs out before β reaches 1."""
        if self.state is None:
            self.init()
        beta_before = float(self.state.beta)
        for _ in range(max_stages):
            if beta_before >= 1.0:
                break
            self.state = self.apply_stage(self.state, self.draw_stage_noise())
            self.n_stages += 1
            beta_now = float(self.state.beta)
            self.beta_ladder.append(beta_now)
            if beta_now <= beta_before:
                warnings.warn(
                    f"SMC tempering stalled at beta={beta_now:.6g} (ESS "
                    f"target unreachable within float precision); particles "
                    f"target the INTERMEDIATE distribution, log_evidence is "
                    f"partial. Lower target_ess or increase n_particles.")
                return self
            beta_before = beta_now
        if beta_before < 1.0:
            warnings.warn(
                f"SMC exhausted max_stages={max_stages} at beta="
                f"{beta_before:.4g} < 1; increase max_stages.")
        return self

    @property
    def particles(self):
        """The current particle set (numpy)."""
        return self.state.particles.cpu().numpy()

    @property
    def log_evidence(self):
        """log Z estimate (the likelihood's normalizing constant)."""
        return float(self.state.log_evidence)
