"""MEADS: tuning-free generalized HMC with cross-fold ensemble adaptation.

PyTorch counterpart of ``mcmcpp_tpu/gradient/meads.py`` (Hoffman & Sountsov
2022). The chains are split into ``n_folds`` folds; each fold takes one
generalized HMC step (partial momentum refresh, one leapfrog step, Metropolis
accept with a momentum flip on rejection) whose preconditioner, step size and
refresh rate come from the current states of the previous fold, so every
fold's kernel leaves the target invariant and there is no warmup phase:

- preconditioner ``sd``: per-parameter std over the previous fold;
- step size ``eps = step_factor / sqrt(lmax(cov(sd * grad)))``;
- refresh rate ``delta = clip(2 * eps / sqrt(lmax(cov(q / sd))), 1e-3, 1)``.

Largest eigenvalues come from a fixed-iteration power method on the centered
data matrix (two (C, P) products an iteration). Momentum is stored in
whitened units.
"""

from typing import NamedTuple

import torch

from mcmcpp_tpu_torch.gradient.hmc import (
    GradientKernel,
    GradientSampler,
    logp_and_grad,
    metropolis,
)
from mcmcpp_tpu_torch.gradient.metric import matmul
from mcmcpp_tpu_torch.ops.random import neg_exponential, normal


class MEADSState(NamedTuple):
    position: torch.Tensor  # (n, P)
    momentum: torch.Tensor  # (n, P), whitened units
    logp: torch.Tensor  # (n,)
    grad: torch.Tensor  # (n, P)


def max_eig_cov(x, n_iter=12):
    """Largest eigenvalue of the sample covariance of ``x`` (C, P): a
    deterministic power iteration ``Σv = Xᵀ(Xv)/(C − 1)``, O(C·P) each."""
    c, p = x.shape
    xc = x - torch.mean(x, dim=0)
    denom = float(max(c - 1, 1))

    def matvec(v):
        return matmul(xc.T, matmul(xc, v[:, None]))[:, 0] / denom

    # fixed full-support start; power iteration amplifies the top mode
    v = torch.full((p,), 1.0 / p ** 0.5, dtype=x.dtype, device=x.device)
    for _ in range(n_iter):
        w = matvec(v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    return torch.clamp_min(torch.dot(v, matvec(v)), 0.0)


def fold_parameters(q, g, step_factor):
    """Tuning parameters (sd (P,), eps, delta) from one fold's states."""
    sd = torch.clamp_min(torch.std(q, dim=0, correction=0), 1e-8)
    lam_g = max_eig_cov(g * sd)
    eps = step_factor * torch.rsqrt(torch.clamp_min(lam_g, 1e-12))
    sigma_max = torch.sqrt(torch.clamp_min(max_eig_cov(q / sd), 1e-12))
    delta = torch.clamp(2.0 * eps / sigma_max, 1e-3, 1.0)
    return sd, eps, delta


class GHMCFoldStep:
    """One generalized-HMC step for a whole fold under fixed (sd, eps,
    delta) (≙ ``ghmc_fold_step``, ``meads.py:92-125``): noise ``(xi (C, P),
    log_u (C,))``, the refresh normals and −Exp(1)."""

    def __init__(self, logp_fn):
        self.logp_fn = logp_fn

    def draw_noise(self, gen, q):
        return (normal(gen, q.shape, q.dtype, q.device),
                neg_exponential(gen, q.shape[0], q.dtype, q.device))

    def apply(self, noise, q, p, lp, g, sd, eps, delta):
        """-> (q, p, lp, g, accept_prob, accepted, diverging, energy)."""
        xi, log_u = noise
        p = torch.sqrt(1.0 - delta) * p + torch.sqrt(delta) * xi
        kinetic = 0.5 * torch.sum(p ** 2, dim=1)
        energy = kinetic - lp  # post-refresh Hamiltonian
        p_half = p + 0.5 * eps * (sd[None, :] * g)
        q_new = q + eps * (sd[None, :] * p_half)
        lp_new, g_new = logp_and_grad(self.logp_fn, q_new)
        p_new = p_half + 0.5 * eps * (sd[None, :] * g_new)
        log_ratio = ((lp_new - 0.5 * torch.sum(p_new ** 2, dim=1))
                     - (lp - kinetic))
        accept_prob, accept, diverging = metropolis(log_ratio, log_u)
        a = accept[:, None]
        return (torch.where(a, q_new, q),
                torch.where(a, p_new, -p),  # flip on rejection: reversibility
                torch.where(accept, lp_new, lp), torch.where(a, g_new, g),
                accept_prob, accept, diverging, energy)


def ghmc_fold_step(logp_fn):
    """The fold step (≙ ``mcmcpp_tpu.gradient.ghmc_fold_step``), built on the
    batched logp itself, which supplies its own batch axis."""
    return GHMCFoldStep(logp_fn)


class MEADSKernel(GradientKernel):
    """The sequential sweep over the folds: fold k is tuned by fold k−1's
    current state (already updated this sweep for k ≥ 1). Noise: one fold
    step's noise per fold."""

    def __init__(self, logp_fn, n_folds, step_factor):
        super().__init__(logp_fn)
        self.n_folds = int(n_folds)
        self.step_factor = float(step_factor)
        self.fold_step = ghmc_fold_step(logp_fn)

    def draw_noise(self, gen, state, host_gen=None):
        folds = state.position.chunk(self.n_folds)
        return tuple(self.fold_step.draw_noise(gen, q) for q in folds)

    def apply(self, noise, state, step_size=None, inv_mass=None):
        # (step_size, inv_mass) come from the shared sampler: MEADS tunes itself
        k_folds = self.n_folds
        q, p, lp, g = (list(x.chunk(k_folds)) for x in state)
        infos = []
        for k in range(k_folds):
            prev = (k - 1) % k_folds
            sd, eps, delta = fold_parameters(q[prev], g[prev],
                                             self.step_factor)
            q[k], p[k], lp[k], g[k], *info = self.fold_step.apply(
                noise[k], q[k], p[k], lp[k], g[k], sd, eps, delta)
            infos.append(info)
        new = MEADSState(*(torch.cat(x) for x in (q, p, lp, g)))
        return new, tuple(torch.cat(x) for x in zip(*infos))


class MEADSSampler(GradientSampler):
    """MEADS: no warmup phase — ``warmup(n)`` runs ``n`` unstored burn-in
    steps (the adaptation is continuous and exact throughout).
    ``n_chains`` must split into ``n_folds`` folds of at least 4 chains."""

    needs_mass = False

    def __init__(self, logp_fn, n_chains, n_params, seed=0, n_folds=4,
                 step_factor=0.5, **kwargs):
        self.n_folds = int(n_folds)
        self.step_factor = float(step_factor)
        if int(n_chains) % self.n_folds:
            raise ValueError(
                f"n_chains={n_chains} not divisible by n_folds={self.n_folds}")
        if int(n_chains) // self.n_folds < 4:
            raise ValueError(
                "need >= 4 chains per fold for cross-fold statistics "
                f"(got {int(n_chains) // self.n_folds})")
        super().__init__(logp_fn, n_chains, n_params, seed=seed, **kwargs)

    def _make_kernel(self):
        return MEADSKernel(self.logp_fn, self.n_folds, self.step_factor)

    def init(self, positions):
        """Positions, their logp and gradient, and a N(0, I) momentum from
        the auxiliary generator."""
        positions = self._positions(positions)
        momentum = normal(self._aux_gen, positions.shape, self.dtype,
                          self.device)
        lp, g = logp_and_grad(self.logp_fn, positions)
        self.state = MEADSState(positions, momentum, lp, g)
        return self

    def warmup(self, n_steps, adapt_mass=None):
        """Burn-in only: ``n_steps`` unstored transitions (``adapt_mass`` is
        accepted for API parity and ignored)."""
        self._require_state()
        for _ in range(int(n_steps)):
            self.state, _ = self._step(self.state, None, None)
        return self
