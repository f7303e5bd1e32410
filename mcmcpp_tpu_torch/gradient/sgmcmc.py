"""Stochastic-gradient MCMC: SGLD and SGHMC over minibatched data.

PyTorch counterpart of ``mcmcpp_tpu/gradient/sgmcmc.py``. The likelihood
gradient is estimated from one random minibatch per step, shared by every
chain and scaled by ``N/B`` (unbiased): Welling & Teh (2011) SGLD and Chen,
Fox & Guestrin (2014) SGHMC. There is no Metropolis correction; the bias is
O(step_size), kept small by a small constant step or the polynomial decay
``step_size_decay``. The stored "logp" is the minibatch estimate
``logprior + (N/B)·loglike(batch)`` at the stored position.

Both functions are batched: ``logprior_fn(theta (C, P)) -> (C,)`` and
``loglike_fn(theta (C, P), batch) -> (C,)``, the SUM of the log-likelihood
terms over the minibatch rows, ``batch`` being ``data`` (a tensor, or a
tuple, list or dict of tensors sharing the leading axis N) at the drawn
rows. The data live on the sampler's device, floating leaves at its
dtype. The step counter of the decay
schedule is a host int, so each step's eps is a host float.
"""

from typing import NamedTuple

import torch

from mcmcpp_tpu_torch.chain import (
    Chain,
    default_chunk_steps,
    row_dtype,
    run_pipelined,
)
from mcmcpp_tpu_torch.gradient.hmc import (
    as_positions,
    ball,
    logp_and_grad,
    scalar,
)
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    STEP_STREAM,
    make_generator,
    normal,
    randint,
)
from mcmcpp_tpu_torch.sampler import _tree_map, resolve_device


class SGState(NamedTuple):
    position: torch.Tensor  # (C, P)
    velocity: torch.Tensor  # (C, P); zeros (unused) for SGLD
    step: int  # drives the decay schedule


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class StochasticGradientSampler:
    """Shared sampler of the minibatch kernels (SGLD / SGHMC subclasses).

    ``step_size_decay=(t0, gamma)`` applies ``eps_t = step_size·(1 +
    t/t0)^(−gamma)``; ``None`` keeps a constant step. ``device`` defaults
    to "cuda".
    """

    def __init__(self, logprior_fn, loglike_fn, data, n_chains, n_params,
                 batch_size, seed=0, dtype=torch.float32, step_size=1e-3,
                 step_size_decay=None, max_chain_bytes=2 << 30, chain=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.logprior_fn = logprior_fn
        self.loglike_fn = loglike_fn

        def to_device(x):
            # floating leaves at the sampler's dtype, as JAX's float32 arrays
            x = torch.as_tensor(x, device=self.device)
            return x.to(dtype) if x.is_floating_point() else x

        self.data = _tree_map(to_device, data)
        sizes = {int(x.shape[0]) for x in _leaves(self.data)}
        if len(sizes) != 1:
            raise ValueError(f"data leaves disagree on leading axis: {sizes}")
        self.n_data = sizes.pop()
        self.batch_size = int(batch_size)
        if not 0 < self.batch_size <= self.n_data:
            raise ValueError(
                f"batch_size={batch_size} not in (0, {self.n_data}]")
        self.n_chains = int(n_chains)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.step_size = float(step_size)
        if step_size_decay is not None:
            t0, gamma = step_size_decay
            if not (t0 > 0 and 0 < gamma <= 1):
                raise ValueError("step_size_decay = (t0 > 0, 0 < gamma <= 1)")
        self.step_size_decay = step_size_decay
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self.state = None
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (
                    self.n_chains, self.n_params):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(n_walkers=self.n_chains,
                               n_params=self.n_params,
                               max_bytes=max_chain_bytes,
                               dtype=row_dtype(dtype))

    # -- stochastic gradient estimate ---------------------------------------

    def _logp_est(self, batch):
        scale = self.n_data / self.batch_size

        def logp(theta):
            return (self.logprior_fn(theta)
                    + scale * self.loglike_fn(theta, batch))

        return logp

    def _eps_at(self, t):
        """eps at step ``t`` (a host int): a CPU scalar of the sampler's dtype."""
        eps = scalar(self.step_size, self.dtype)
        if self.step_size_decay is not None:
            t0, gamma = self.step_size_decay
            eps = eps * (1.0 + scalar(t, self.dtype) / t0) ** (-gamma)
        return eps

    def draw_noise(self, gen, state):
        """One step's noise: the minibatch rows (B,) int64 and the normals
        (C, P)."""
        q = state.position
        return (randint(gen, 0, self.n_data, (self.batch_size,), q.device),
                normal(gen, q.shape, q.dtype, q.device))

    def apply(self, noise, state):
        """Subclass hook: -> (state, (position evaluated, logp estimate
        there)), the estimate taken at the pre-transition position."""
        raise NotImplementedError

    def _gradient(self, idx, state):
        batch = _tree_map(lambda x: x[idx], self.data)
        return logp_and_grad(self._logp_est(batch), state.position)

    def _step(self, state):
        return self.apply(self.draw_noise(self._step_gen, state), state)

    # -- init / run ----------------------------------------------------------

    def init(self, positions):
        positions = as_positions(positions, self.n_chains, self.n_params,
                                 self.dtype, self.device)
        self.state = SGState(positions, torch.zeros_like(positions), 0)
        return self

    def init_ball(self, center, scale=1.0, seed=None):
        return self.init(ball(self, center, scale, seed))

    def _run_chunk(self, take, thin):
        pos = torch.empty((take, self.n_chains, self.n_params),
                          dtype=self.dtype, device=self.device)
        lps = torch.empty((take, self.n_chains), dtype=self.dtype,
                          device=self.device)
        for s in range(take):
            for _ in range(thin):
                self.state, (pos_eval, lp) = self._step(self.state)
            pos[s] = pos_eval
            lps[s] = lp
        return pos, lps

    def run(self, n_steps, thin=1):
        """Advance ``n_steps``, storing every thin-th (position, logp
        estimate) pair — both at the position the last step of each thin
        window evaluated (one transition behind the live state).
        ``n_steps % thin`` leftover steps still advance the state, unstored.
        Returns False on the chain's byte cap."""
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        chunk = default_chunk_steps(self.n_chains, self.n_params,
                                    row_dtype(self.dtype))
        ok = run_pipelined(n_store, chunk,
                           lambda take: self._run_chunk(take, thin),
                           lambda c: self.chain.append(*c))
        if ok:
            for _ in range(leftover):
                self.state = self._step(self.state)[0]
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        """Minibatch logp ESTIMATES (see the module docstring)."""
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)


class SGLDSampler(StochasticGradientSampler):
    """Stochastic Gradient Langevin Dynamics (Welling & Teh 2011):
    ``theta += (eps/2)·ghat + N(0, eps)``."""

    def apply(self, noise, state):
        idx, z = noise
        lp, g = self._gradient(idx, state)
        eps = self._eps_at(state.step)
        pos = (state.position + 0.5 * float(eps) * g
               + float(torch.sqrt(eps)) * z)
        return (SGState(pos, state.velocity, state.step + 1),
                (state.position, lp))


class SGHMCSampler(StochasticGradientSampler):
    """Stochastic Gradient HMC (Chen, Fox & Guestrin 2014): momentum with
    friction ``alpha`` absorbing the minibatch gradient noise:
    ``v = (1-alpha)·v + eps·ghat + N(0, 2·alpha·eps); theta += v``."""

    def __init__(self, *args, friction=0.1, **kwargs):
        self.friction = float(friction)
        if not 0 < self.friction <= 1:
            raise ValueError("friction must be in (0, 1]")
        super().__init__(*args, **kwargs)

    def apply(self, noise, state):
        idx, z = noise
        lp, g = self._gradient(idx, state)
        eps = self._eps_at(state.step)
        alpha = self.friction
        v = ((1.0 - alpha) * state.velocity + float(eps) * g
             + float(torch.sqrt(2.0 * alpha * eps)) * z)
        return (SGState(state.position + v, v, state.step + 1),
                (state.position, lp))

