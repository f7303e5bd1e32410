"""Variational inference: mean-field and full-rank ADVI.

PyTorch counterpart of ``mcmcpp_tpu/vi.py``. Fits q(θ) = N(μ, Σ), Σ
diagonal (mean-field) or dense through a Cholesky factor (full-rank), by
Adam ascent on the reparameterized ELBO

    E_q[logp(θ)] + H[q],  θ = μ + L·ε, ε ~ N(0, I).

The Monte-Carlo batch of a step is one batched logp call. The full-rank
factor is the JAX package's: L = tril(raw, −1) + diag(exp(diag(raw))). The
optimizer is :mod:`mcmcpp_tpu_torch.optim`'s Adam (optax's numbers and
state). Each step's ε come from the ADVI's generator, or from ``noise=``
(an (n_steps, n_mc, P) tensor), which is how a test hands the port the JAX
package's draws. ``mesh=`` is not ported.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.optim import adam_init, adam_step
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    STEP_STREAM,
    make_generator,
)
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["ADVI", "FullRankParams", "MeanFieldParams"]


class MeanFieldParams(NamedTuple):
    mu: torch.Tensor  # (P,)
    log_sigma: torch.Tensor  # (P,)


class FullRankParams(NamedTuple):
    mu: torch.Tensor  # (P,)
    chol_raw: torch.Tensor  # (P, P): strict lower triangle + log diagonal


def _chol(params):
    tril = torch.tril(params.chol_raw, -1)
    return tril + torch.diag(torch.exp(torch.diagonal(params.chol_raw)))


def _sample(params, eps):
    """(n, P) draws μ + L·ε for the (n, P) ε."""
    if isinstance(params, FullRankParams):
        return params.mu + eps @ _chol(params).T
    return params.mu + torch.exp(params.log_sigma) * eps


def _entropy(params):
    p = params.mu.shape[0]
    log_det = (torch.sum(torch.diagonal(params.chol_raw))
               if isinstance(params, FullRankParams)
               else torch.sum(params.log_sigma))
    return log_det + 0.5 * p * (1.0 + math.log(2 * math.pi))


class ADVI:
    """Automatic differentiation VI on a torch logp.

    logp_fn : (P,) -> scalar, or with ``batched=True`` (n, P) -> (n,).
    n_params : dimension P.
    full_rank : fit a dense covariance (default mean-field).
    n_mc : Monte-Carlo draws per ELBO gradient (default 16).
    device : default "cuda" (CUDA without a GPU raises).
    """

    def __init__(self, logp_fn, n_params, full_rank=False, n_mc=16,
                 learning_rate=1e-2, seed=0, dtype=torch.float32,
                 batched=False, device="cuda"):
        self.device = resolve_device(device)
        self.logp_fn = logp_fn
        self._logp = logp_fn if batched else torch.func.vmap(logp_fn)
        self.n_params = int(n_params)
        self.full_rank = bool(full_rank)
        self.n_mc = int(n_mc)
        self.learning_rate = float(learning_rate)
        self.dtype = dtype
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        p = self.n_params

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.params = (FullRankParams(zeros(p), zeros(p, p)) if full_rank
                       else MeanFieldParams(zeros(p), zeros(p)))
        self.opt_state = adam_init(list(self.params))
        self.elbo_trace = []

    def neg_elbo(self, params, eps):
        """−ELBO at ``params`` on the (n_mc, P) draws ``eps``."""
        thetas = _sample(params, eps)
        return -(torch.mean(self._logp(thetas)) + _entropy(params))

    def fit(self, n_steps=1000, noise=None):
        """``n_steps`` Adam updates; appends each step's ELBO to
        ``elbo_trace`` (read from the device once, at the end). ``noise``:
        optional (n_steps, n_mc, P) draws in place of the generator's."""
        params = [p.detach().requires_grad_() for p in self.params]
        state = self.opt_state
        losses = torch.empty(int(n_steps), dtype=self.dtype,
                             device=self.device)
        for i in range(int(n_steps)):
            eps = (noise[i].to(self.device, self.dtype) if noise is not None
                   else torch.randn((self.n_mc, self.n_params),
                                    generator=self._step_gen,
                                    dtype=self.dtype, device=self.device))
            loss = self.neg_elbo(type(self.params)(*params), eps)
            grads = torch.autograd.grad(loss, params)
            state = adam_step(params, grads, state, self.learning_rate)
            losses[i] = loss.detach()
        self.params = type(self.params)(*(p.detach() for p in params))
        self.opt_state = state
        self.elbo_trace.extend((-losses.cpu().numpy()).tolist())
        return self

    # -- posterior access ---------------------------------------------------

    @property
    def mean(self):
        return self.params.mu.cpu().numpy()

    @property
    def cov(self):
        if self.full_rank:
            L = _chol(self.params).cpu().numpy()
            return L @ L.T
        sig = np.exp(self.params.log_sigma.cpu().numpy())
        return np.diag(sig ** 2)

    def sample(self, n, seed=None):
        """(n, P) draws of the approximation (numpy). Successive calls draw
        afresh from the auxiliary generator; ``seed`` draws from a
        generator of its own."""
        gen = (self._aux_gen if seed is None
               else make_generator(seed, AUX_STREAM, self.device))
        eps = torch.randn((int(n), self.n_params), generator=gen,
                          dtype=self.dtype, device=self.device)
        return _sample(self.params, eps).cpu().numpy()
