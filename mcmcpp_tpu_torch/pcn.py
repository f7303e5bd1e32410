"""Preconditioned Crank–Nicolson (pCN) for Gaussian-prior targets.

PyTorch counterpart of ``mcmcpp_tpu/pcn.py`` (Cotter, Roberts, Stuart &
White 2013): for ``π(f) ∝ N(f; mu, Sigma) · L(f)`` the proposal

    f' = mu + sqrt(1 − β²)·(f − mu) + β·ν,   ν ~ N(0, Sigma)

is reversible with respect to the prior, so the Metropolis ratio is the
likelihood's alone: accept iff log u < log L(f') − log L(f). The acceptance
rate stays flat as the discretization P grows.

Chains are a (C, P) batch: one (C, P) × (P, P) prior product (float32, no
TF32) and one batched likelihood a step, with a branchless accept and no
host sync. β is a plain float read at each step, so ``tune()`` changes it
without rebuilding anything (the JAX package compiles one program per β).
Every transition is ``draw_noise`` (z (C, P), log u (C,)) and a
deterministic ``apply``.

Sharded (``mesh=``), every rank draws every chain's noise and keeps its
rows; a step has no collective, and the accept counts are summed over the
ranks when read (one all-gather), so ``acceptance_fraction`` and ``tune``'s
β are the same on every rank. A rank's prior product has fewer rows than
the unsharded one; where the matmul's blocking depends on the row count its
rows can differ from the unsharded product's in the last bits.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import default_chunk_steps, row_dtype, \
    run_pipelined
from mcmcpp_tpu_torch.elliptical import as_tensor, check_chain, \
    gaussian_prior
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    STEP_STREAM,
    make_generator,
    neg_exponential,
    normal,
)
from mcmcpp_tpu_torch.parallel.mesh import _engine_rows


class PCNState(NamedTuple):
    position: torch.Tensor  # (C, P)
    loglike: torch.Tensor  # (C,)
    accepted: torch.Tensor  # (C,) int32 per-chain accept counters


class PCNSampler:
    """``log_like_fn``: (P,) -> scalar log-likelihood (or, with
    ``batched=True``, (C, P) -> (C,)). The Gaussian prior is given by
    ``prior_mean`` (P,) and either ``prior_chol`` (P, P) lower Cholesky or
    ``prior_scale`` (P,). ``beta`` in (0, 1] is the pCN step size (β = 1 is
    an independence sampler from the prior; tune for ~20–40% acceptance,
    which stays flat in P). ``device`` defaults to "cuda"; ``mesh`` (a
    ``WalkerLayout``) splits the chains over the ranks of a process group,
    on the layout's device."""

    def __init__(self, log_like_fn, prior_mean, prior_chol=None,
                 prior_scale=None, beta=0.2, n_chains=32, seed=0,
                 dtype=torch.float32, max_chain_bytes=2 << 30, mesh=None,
                 chain=None, batched=False, device=None):
        if not 0.0 < float(beta) <= 1.0:
            raise ValueError("beta must be in (0, 1]")
        self.mesh = mesh
        self.device, self._row0, self._n_local = _engine_rows(
            mesh, device, int(n_chains), "n_chains")
        self.beta = float(beta)
        self.dtype = dtype
        self.prior_mean, self.prior_chol = gaussian_prior(
            prior_mean, prior_chol, prior_scale, dtype, self.device)
        self.n_params = int(self.prior_mean.shape[0])
        self.n_chains = int(n_chains)
        self._batched_loglike = (log_like_fn if batched
                                 else torch.func.vmap(log_like_fn))
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self.state = None
        self.total_steps = 0
        self.chain = check_chain(chain, self._n_local, self.n_params,
                                 max_chain_bytes, dtype)

    def init(self, positions):
        """Every chain's (C, P) positions (a sharded sampler keeps its
        rows)."""
        positions = as_tensor(positions, self.dtype, self.device)
        if tuple(positions.shape) != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})")
        positions = positions[self._row0:self._row0 + self._n_local]
        self.state = PCNState(
            positions, self._batched_loglike(positions),
            torch.zeros((self._n_local,), dtype=torch.int32,
                        device=self.device))
        self.total_steps = 0
        return self

    def init_prior(self, seed=None):
        """Start every chain at an independent prior draw (from the
        auxiliary generator, or one seeded by ``seed``)."""
        gen = (self._aux_gen if seed is None
               else make_generator(seed, AUX_STREAM, self.device))
        z = normal(gen, (self.n_chains, self.n_params), self.dtype,
                   self.device)
        return self.init(self.prior_mean[None, :] + z @ self.prior_chol.T)

    def _accepted_total(self):
        """Accepted moves of every chain (of every rank's, when sharded)."""
        acc = self.state.accepted
        if self.mesh is not None:
            acc = self.mesh.gather(acc)
        return int(acc.sum())

    @property
    def acceptance_fraction(self):
        """Mean accept rate since init (or since ``tune`` ended)."""
        if self.state is None or self.total_steps == 0:
            return 0.0
        return float(self._accepted_total()
                     / (self.total_steps * self.n_chains))

    # -- one transition for the whole (C, P) batch ---------------------------

    def draw_noise(self):
        """(z (C, P) standard normals, log u (C,) = −Exp(1)), of every
        chain (cut to the rank's rows when sharded)."""
        rows = slice(self._row0, self._row0 + self._n_local)
        return (normal(self._step_gen, (self.n_chains, self.n_params),
                       self.dtype, self.device)[rows],
                neg_exponential(self._step_gen, self.n_chains, self.dtype,
                                self.device)[rows])

    def apply(self, noise, state, beta=None):
        """One pCN step of every chain on the draws ``noise``, at step size
        ``beta`` (default ``self.beta``)."""
        beta = self.beta if beta is None else float(beta)
        z, log_u = noise
        mu = self.prior_mean[None, :]
        nu = z @ self.prior_chol.T
        rho = float(np.sqrt(1.0 - beta * beta))
        prop = mu + rho * (state.position - mu) + beta * nu
        ll = self._batched_loglike(prop)
        # prior-reversible proposal => likelihood-only Metropolis ratio
        accept = log_u < (ll - state.loglike)
        return PCNState(torch.where(accept[:, None], prop, state.position),
                        torch.where(accept, ll, state.loglike),
                        state.accepted + accept.to(torch.int32))

    def _advance(self, n_steps):
        state = self.state
        for _ in range(int(n_steps)):
            state = self.apply(self.draw_noise(), state)
        self.state = state

    def tune(self, n_steps=400, target=0.3, window=20, rate=2.0,
             beta_min=1e-4):
        """Robbins–Monro adaptation of β toward ``target`` acceptance, then
        FREEZE (the sampled chain that follows is exactly π-invariant).

        Runs ``n_steps`` unstored transitions in ``window``-step blocks,
        updating log β by ``rate/k^0.6 · (acc − target)`` per block, clamped
        to (beta_min, 1]; one host sync a block reads the accepts. Tuning
        steps do not count toward ``acceptance_fraction``. Returns self;
        read the result off ``self.beta``.
        """
        if self.state is None:
            raise RuntimeError("call init/init_prior first")
        if not 0.0 < float(target) < 1.0:
            raise ValueError("target must be in (0, 1)")
        window = int(window)
        prev = self._accepted_total()
        for k in range(max(1, int(n_steps) // window)):
            self._advance(window)
            total = self._accepted_total()
            acc = (total - prev) / (window * self.n_chains)
            prev = total
            log_beta = np.log(self.beta) + rate / (k + 1.0) ** 0.6 * (
                acc - float(target))
            self.beta = float(np.clip(np.exp(log_beta), beta_min, 1.0))
        # freeze: acceptance_fraction reflects the fixed-kernel phase only
        self.state = self.state._replace(
            accepted=torch.zeros_like(self.state.accepted))
        self.total_steps = 0
        return self

    # -- driver --------------------------------------------------------------

    def _run_chunk(self, take, thin):
        pos = torch.empty((take, self._n_local, self.n_params),
                          dtype=self.dtype, device=self.device)
        lls = torch.empty((take, self._n_local), dtype=self.dtype,
                          device=self.device)
        for s in range(take):
            self._advance(thin)
            pos[s], lls[s] = self.state.position, self.state.loglike
        self.total_steps += take * thin
        return pos, lls

    def run(self, n_steps, thin=1):
        """Store every thin-th state; the stored "logp" column is the
        LOG-LIKELIHOOD. ``n_steps % thin`` leftover transitions still
        advance the state. Returns False on chain byte-cap (EndOfChain)."""
        if self.state is None:
            raise RuntimeError("call init/init_prior first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        chunk = default_chunk_steps(self._n_local, self.n_params,
                                    row_dtype(self.dtype))
        ok = run_pipelined(n_store, chunk,
                           lambda take: self._run_chunk(take, thin),
                           lambda rows: self.chain.append(*rows))
        if ok and leftover:
            self._advance(leftover)
            self.total_steps += leftover
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_likes(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)
