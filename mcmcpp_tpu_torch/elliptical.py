"""Elliptical slice sampling for Gaussian-prior latents.

PyTorch counterpart of ``mcmcpp_tpu/elliptical.py`` (Murray, Adams & MacKay
2010): for targets ``posterior(f) ∝ N(f; mu, Sigma) · L(f)`` propose on the
ellipse through the current state and a fresh prior draw, and shrink the
angle bracket until the likelihood threshold is met. Rejection-free and
tuning-free.

Chains are a (C, P) batch; the prior rotation is one (C, P) × (P, P)
product (float32, as torch leaves it: no TF32). The JAX package's
``while_loop`` tests "every chain done" on the device each iteration; here
the loop runs ``CHECK_EVERY`` iterations between host tests, with the
finished chains masked (their angle, bracket and output frozen), so the
results equal a test every iteration and a step waits on the device once
per ``CHECK_EVERY`` iterations. The cap ``max_shrink`` keeps JAX's
fallback: a chain that never meets its threshold keeps its state.

Every transition is ``draw_noise`` (the prior draw, the slice height's
uniform, the initial angle and a function that draws the j-th shrink
iteration's uniforms on demand) and a deterministic ``apply``, so a test can
hand the port the JAX package's draws.

Sharded (``mesh=``), every rank draws every chain's noise and keeps its
rows, and the loop's "every chain done" test covers every rank's chains
(``layout.all``, a MAX all-reduce every ``CHECK_EVERY`` iterations), so all
ranks run the iterations, and draw the shrink uniforms, that the unsharded
loop does. A blocked Gibbs sampler's slice blocks test the same way.
"""

import contextvars
import math
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import (
    Chain,
    default_chunk_steps,
    row_dtype,
    run_pipelined,
)
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    STEP_STREAM,
    make_generator,
    normal,
    uniform,
)
from mcmcpp_tpu_torch.movers.base import rows_of
from mcmcpp_tpu_torch.parallel.mesh import _engine_rows

TWO_PI = 2.0 * math.pi
# smallest slice-height uniform (≙ the JAX package's minval=1e-37): log u
# stays finite
U_FLOOR = 1e-37
# shrink iterations between two host tests of "every chain done": the
# masked extra iterations of a group cost less than a sync each
CHECK_EVERY = 4
# the layout whose ranks a shrink loop called without one tests "every chain
# done" over (set by a sharded blocked Gibbs sweep around its kernels)
_LOOP_LAYOUT = contextvars.ContextVar("loop_layout", default=None)


class EllipticalState(NamedTuple):
    position: torch.Tensor  # (C, P)
    loglike: torch.Tensor  # (C,)


def as_tensor(x, dtype, device):
    """``x`` (a tensor, an array, a JAX array's numpy view, a list) as a
    tensor of ``dtype`` on ``device``; arrays are copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def gaussian_prior(prior_mean, prior_chol, prior_scale, dtype, device):
    """(mean (P,), lower factor (P, P)) of a Gaussian prior given by its
    mean and exactly one of ``prior_chol`` (P, P) or ``prior_scale`` (P,),
    with the JAX package's validation."""
    mean = as_tensor(prior_mean, dtype, device)
    p = int(mean.shape[0])
    if (prior_chol is None) == (prior_scale is None):
        raise ValueError(
            "pass exactly one of prior_chol= (P, P) or prior_scale= (P,)")
    if prior_chol is not None:
        chol = as_tensor(prior_chol, dtype, device)
        if tuple(chol.shape) != (p, p):
            raise ValueError("prior_chol must be (P, P)")
    else:
        scale = as_tensor(prior_scale, dtype, device)
        if tuple(scale.shape) != (p,):
            raise ValueError("prior_scale must be (P,)")
        chol = torch.diag(scale)
    return mean, chol


def check_chain(chain, n_chains, n_params, max_bytes, dtype):
    """The injected ``chain`` after a geometry check, or a new host
    :class:`Chain` of (n_chains, n_params) rows (a sharded sampler's: its
    own chains)."""
    if chain is not None:
        if (chain.n_walkers, chain.n_params) != (n_chains, n_params):
            raise ValueError("injected chain store geometry mismatch")
        return chain
    return Chain(n_walkers=n_chains, n_params=n_params, max_bytes=max_bytes,
                 dtype=row_dtype(dtype))


def shrink_loop(propose, loglike, log_y, theta, noise_planes, max_shrink,
                keep, counters=None, layout=None):
    """The bracket-shrinking loop of one elliptical slice step on a batch.

    ``propose(th)`` maps (C,) angles to (C, ...) positions, ``loglike`` a
    batch of positions to (C,), ``log_y`` (C,) is the slice height,
    ``noise_planes(j)`` the (C,) uniforms of iteration j and ``keep`` the
    positions (and log-likelihoods, if a tuple) a chain keeps at the cap.
    Iterations run in groups of ``CHECK_EVERY`` between host tests of
    "every chain done"; finished chains are masked. ``counters`` (a dict)
    gains ``iterations`` and ``syncs``. ``layout`` (default
    :data:`_LOOP_LAYOUT`'s): the batch is a rank's rows, and the test covers
    every rank's. Returns what ``keep`` holds, each replaced where a chain
    met its threshold.
    """
    layout = _LOOP_LAYOUT.get() if layout is None else layout
    lo, hi = theta - TWO_PI, theta
    th = theta
    done = torch.zeros_like(log_y, dtype=torch.bool)
    out = keep
    i = syncs = 0
    while i < max_shrink:
        for _ in range(min(CHECK_EVERY, max_shrink - i)):
            pos = propose(th)
            ll = loglike(pos)
            ok = ll > log_y
            newly = ok & ~done
            rows = newly.reshape(newly.shape + (1,) * (pos.ndim - 1))
            out = (torch.where(rows, pos, out[0]),
                   torch.where(newly, ll, out[1])) if isinstance(
                       out, tuple) else torch.where(rows, pos, out)
            done = done | ok
            # Murray et al. shrinkage: pull the violated side to theta
            lo = torch.where(~done & (th < 0), th, lo)
            hi = torch.where(~done & (th >= 0), th, hi)
            th = torch.where(done, th, lo + noise_planes(i) * (hi - lo))
            i += 1
        syncs += 1
        if (bool(done.all()) if layout is None else layout.all(done)):
            break
    if counters is not None:
        counters["iterations"] = counters.get("iterations", 0) + i
        counters["syncs"] = counters.get("syncs", 0) + syncs
    return out


class EllipticalSliceSampler:
    """``log_like_fn``: (P,) -> scalar log-likelihood (or, with
    ``batched=True``, (C, P) -> (C,)). The Gaussian prior is given by
    ``prior_mean`` (P,) and either ``prior_chol`` (P, P) lower Cholesky or
    ``prior_scale`` (P,) for a diagonal prior. ``max_shrink`` bounds the
    bracket-shrinking loop (on the cap the chain keeps its state); the loop
    tests "every chain done" on the host every ``CHECK_EVERY`` iterations.
    ``device`` defaults to "cuda"; ``mesh`` (a ``WalkerLayout``) splits the
    chains over the ranks of a process group, on the layout's device."""

    def __init__(self, log_like_fn, prior_mean, prior_chol=None,
                 prior_scale=None, n_chains=32, seed=0, dtype=torch.float32,
                 max_shrink=64, max_chain_bytes=2 << 30, mesh=None,
                 chain=None, batched=False, device=None):
        self.mesh = mesh
        self.device, self._row0, self._n_local = _engine_rows(
            mesh, device, int(n_chains), "n_chains")
        self.dtype = dtype
        self.prior_mean, self.prior_chol = gaussian_prior(
            prior_mean, prior_chol, prior_scale, dtype, self.device)
        self.n_params = int(self.prior_mean.shape[0])
        self.n_chains = int(n_chains)
        self.max_shrink = int(max_shrink)
        self._batched_loglike = (log_like_fn if batched
                                 else torch.func.vmap(log_like_fn))
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self.state = None
        self.chain = check_chain(chain, self._n_local, self.n_params,
                                 max_chain_bytes, dtype)
        #: steps taken, shrink-loop iterations and host syncs of the loop
        self.counters = {"steps": 0, "iterations": 0, "syncs": 0}

    def init(self, positions):
        """Every chain's (C, P) positions (a sharded sampler keeps its
        rows)."""
        positions = as_tensor(positions, self.dtype, self.device)
        if tuple(positions.shape) != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})")
        positions = positions[self._row0:self._row0 + self._n_local]
        self.state = EllipticalState(positions,
                                     self._batched_loglike(positions))
        return self

    def init_prior(self, seed=None):
        """Start every chain at an independent prior draw (from the
        auxiliary generator, or one seeded by ``seed``)."""
        gen = (self._aux_gen if seed is None
               else make_generator(seed, AUX_STREAM, self.device))
        z = normal(gen, (self.n_chains, self.n_params), self.dtype,
                   self.device)
        return self.init(self.prior_mean[None, :] + z @ self.prior_chol.T)

    # -- one transition for the whole (C, P) batch ---------------------------

    def draw_noise(self):
        """(z (C, P), u (C,) in [1e-37, 1), theta (C,) in [0, 2π),
        shrink_uniforms): ``shrink_uniforms(j)`` draws iteration j's (C,)
        uniforms when the loop reaches it. Every chain's draws, cut to the
        rank's rows when sharded."""
        c, dev, dt = self.n_chains, self.device, self.dtype

        def shrink_uniforms(j):
            return uniform(self._step_gen, c, dt, dev)

        z = normal(self._step_gen, (c, self.n_params), dt, dev)
        u = torch.clamp(uniform(self._step_gen, c, dt, dev), min=U_FLOOR)
        theta = uniform(self._step_gen, c, dt, dev) * TWO_PI
        noise = z, u, theta, shrink_uniforms
        if self.mesh is None:
            return noise
        return rows_of(noise, self._row0, self._n_local)

    def apply(self, noise, state):
        """One elliptical slice step of every chain on the draws ``noise``."""
        z, u, theta, shrink_uniforms = noise
        mu = self.prior_mean[None, :]
        nu = z @ self.prior_chol.T  # prior deviate around 0
        log_y = state.loglike + torch.log(u)
        centered = state.position - mu

        def propose(th):
            return (centered * torch.cos(th)[:, None]
                    + nu * torch.sin(th)[:, None] + mu)

        pos, ll = shrink_loop(propose, self._batched_loglike, log_y, theta,
                              shrink_uniforms, self.max_shrink,
                              (state.position, state.loglike),
                              self.counters, self.mesh)
        self.counters["steps"] += 1
        return EllipticalState(pos, ll)

    # -- driver --------------------------------------------------------------

    def _run_chunk(self, take, thin):
        pos = torch.empty((take, self._n_local, self.n_params),
                          dtype=self.dtype, device=self.device)
        lls = torch.empty((take, self._n_local), dtype=self.dtype,
                          device=self.device)
        state = self.state
        for s in range(take):
            for _ in range(thin):
                state = self.apply(self.draw_noise(), state)
            pos[s], lls[s] = state.position, state.loglike
        self.state = state
        return pos, lls

    def run(self, n_steps, thin=1):
        """Store every thin-th state; the stored "logp" column is the
        LOG-LIKELIHOOD (the prior factor is implicit in the kernel).
        ``n_steps % thin`` leftover transitions still advance the state.
        Returns False on chain byte-cap (EndOfChain)."""
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
            self._run_chunk(1, leftover)
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_likes(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)
