"""Parallel tempering (replica exchange) over a temperature × walker grid.

PyTorch counterpart of ``mcmcpp_tpu/tempering.py``. K tempered replicas of
the red/black walker ensemble live as ``(K, W/2, P)`` tensors. Each replica
targets π^β_k with a shared mover (acceptance tempered through
``Mover.apply(beta=...)``, log-probs stored RAW); every ``swap_every`` steps
adjacent replicas propose per-walker state swaps with the exchange rule

    log α = (β_k − β_{k+1}) · (score_{k+1} − score_k)

in alternating even/odd pair phases. Samples are read from the β = 1
replica.

Where the JAX package vmaps ``mover.update_half`` over the ladder with one
key and one β per rung, the port runs the K rungs as one batched half-step:
the mover draws the noise of all K rungs at once (``draw_rung_noise``: one
partner shift, one z and one log u plane per rung) and ``torch.func.vmap`` of
its draw-free ``apply`` takes a (K,) tensor of β, so a half-step's launches
do not grow with K. Movers whose half-step branches on the host (the mixture
mover's branch, the slice move's loops) run their rungs one after another.

The step counter, the swap gate ``(step + 1) % swap_every == 0`` and the pair
parity are host ints (the JAX package's ``lax.cond`` on the device counter
would be a host sync a step here), so no step waits on the device. The JAX
package rotates a key epoch at 2^30 steps; the port's generators carry their
own state and need none, and a checkpoint carries the step.

**Power-posterior (evidence) mode**: pass ``loglike_fn`` and
``logprior_fn`` instead of ``logp_fn``. Replica k targets prior·L^β_k (the
prior is never tempered), the logp grids hold the log prior, swaps are
scored on the log-likelihood, and the evidence accumulators (a finite-masked
Welford mean of each rung's per-step walker mean of log L for TI, a
streaming logsumexp per ladder gap for the stepping stone) are updated on
the device every step, for ``log_evidence``.

Randomness: the steps draw from a generator on ``device`` (``seed``'s step
stream), ``init_ball`` from the auxiliary stream, host-side choices (the
mixture's branch) from a CPU generator.

Sharded (``mesh=``), each rank holds a block of the (K, H, P) grids and
draws every rung's and walker's noise, keeping its block's. A
``WalkerLayout`` splits the walkers (every rung whole on every rank): a
half-step gathers the other half of every rung, the exchange phase is local
(per walker), and the swap counts are summed over the ranks when read. A
``LadderLayout`` splits the rungs over its ladder shards and the walkers
within each: a half-step gathers the whole other half and keeps its rungs',
and an exchange phase, whose pairs cross the shards' edges, runs on the
gathered grids. Power mode gathers the log-likelihood grids once a step for
the evidence accumulators, which are the same on every rank.
"""

import warnings
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import (
    Chain,
    default_chunk_steps,
    row_dtype,
    run_pipelined,
)
from mcmcpp_tpu_torch.movers.base import Mover, rows_of
from mcmcpp_tpu_torch.movers.fused import FusedStretchMove
from mcmcpp_tpu_torch.movers.mixture import MixtureMover
from mcmcpp_tpu_torch.movers.slice import EnsembleSliceMove
from mcmcpp_tpu_torch.movers.stretch import StretchMove
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    HOST_STREAM,
    STEP_STREAM,
    make_generator,
    neg_exponential,
)
from mcmcpp_tpu_torch.parallel.mesh import LadderLayout, _engine_rows

# movers whose half-step decides control flow on the host: their rungs run
# one after another instead of under one vmap
_HOST_BRANCHING = (MixtureMover, EnsembleSliceMove)


class PTState(NamedTuple):
    """``red``/``black``: (K, H, P); ``logp_*``: (K, H) raw logp (power mode:
    the log prior); ``step``: a host int; ``swaps_*``: (K−1,) int64 counts
    since the start (or the last ``tune_ladder``), on the device. Power mode adds the log-likelihood grids and the
    evidence accumulators (None otherwise): ``ll_mean``/``ll_m2``/``ll_n``
    (K,), ``ss_max``/``ss_sum`` (K−1,), ``acc_n`` () float."""

    red: torch.Tensor
    black: torch.Tensor
    logp_red: torch.Tensor
    logp_black: torch.Tensor
    step: int
    swaps_accepted: torch.Tensor
    swaps_proposed: torch.Tensor
    ll_red: torch.Tensor = None
    ll_black: torch.Tensor = None
    ll_mean: torch.Tensor = None
    ll_m2: torch.Tensor = None
    ss_max: torch.Tensor = None
    ss_sum: torch.Tensor = None
    acc_n: torch.Tensor = None
    ll_n: torch.Tensor = None


EVIDENCE_FIELDS = ("ll_mean", "ll_m2", "ss_max", "ss_sum", "acc_n", "ll_n")


def geometric_ladder(n_temps, beta_min=0.01):
    """β ladder 1 → beta_min, geometric spacing (float32, on the CPU)."""
    return torch.from_numpy(
        np.geomspace(1.0, beta_min, n_temps).astype(np.float32))


def power_ladder(n_temps, exponent=5.0):
    """β ladder 1 → 0 with β_k = ((K−1−k)/(K−1))^c, the Friel & Pettitt
    (2008) power-posterior schedule; it reaches β = 0 (the prior), as
    thermodynamic integration needs. Float32, on the CPU."""
    k = np.arange(n_temps, dtype=np.float64)
    return torch.from_numpy(
        (((n_temps - 1 - k) / (n_temps - 1)) ** exponent).astype(np.float32))


def _neighbor_diff(score):
    """score[k+1] − score[k] per adjacent ladder pair, −inf-safe (a pair of
    zero-likelihood walkers has exchange ratio 1, not NaN)."""
    hi, lo = score[1:], score[:-1]
    both_inf = torch.isneginf(hi) & torch.isneginf(lo)
    return torch.where(both_inf, 0.0, hi - lo)


def draw_swap_noise(gen, k, h, dtype, device):
    """The draws of one exchange phase: log u = −Exp(1) for every walker of
    every adjacent pair, (K−1, H) for the red and for the black half."""
    return (neg_exponential(gen, (k - 1, h), dtype, device),
            neg_exponential(gen, (k - 1, h), dtype, device))


def _swap_rows(grid, acc):
    """``grid`` (K, H, ...) with row k taking row k+1 and row k+1 taking
    row k, per walker, where ``acc`` (K−1, H) is set."""
    none = torch.zeros_like(acc[:1])
    take_upper = torch.cat([acc, none])  # row k <- k+1
    take_lower = torch.cat([none, acc])  # row k+1 <- k
    if grid.ndim == 3:
        take_upper, take_lower = take_upper[..., None], take_lower[..., None]
    out = torch.where(take_upper, torch.roll(grid, -1, 0), grid)
    return torch.where(take_lower, torch.roll(grid, 1, 0), out)


def _swap_phase(pos_r, pos_b, lp_r, lp_b, betas, parity, log_u_r, log_u_b,
                score_r=None, score_b=None, extra_r=(), extra_b=()):
    """Propose swaps between ladder pairs (k, k+1) with k ≡ ``parity``
    (mod 2, a host int) on the full (K, H, P) grids, with the draws
    ``log_u_*`` of :func:`draw_swap_noise`.

    The decision uses ``score`` (default ``lp``; power mode passes the
    log-likelihood grids); ``extra_*`` are further (K, H) grids co-swapped
    with the same per-walker masks. Returns (pos_r, pos_b, lp_r, lp_b,
    accepted (K−1,) int32, proposed (K−1,) int32, extra_r, extra_b).
    """
    k_dim, h = pos_r.shape[:2]
    dbeta = betas[:-1] - betas[1:]
    score_r = lp_r if score_r is None else score_r
    score_b = lp_b if score_b is None else score_b
    # only pairs of the current parity act, so they touch disjoint rows
    active_pair = (torch.arange(k_dim - 1, device=pos_r.device) % 2) == parity
    acc_r = (log_u_r < dbeta[:, None] * _neighbor_diff(score_r)) \
        & active_pair[:, None]
    acc_b = (log_u_b < dbeta[:, None] * _neighbor_diff(score_b)) \
        & active_pair[:, None]
    pos_r, lp_r = _swap_rows(pos_r, acc_r), _swap_rows(lp_r, acc_r)
    pos_b, lp_b = _swap_rows(pos_b, acc_b), _swap_rows(lp_b, acc_b)
    extra_r = tuple(_swap_rows(g, acc_r) for g in extra_r)
    extra_b = tuple(_swap_rows(g, acc_b) for g in extra_b)
    n_acc = (acc_r.sum(dim=1) + acc_b.sum(dim=1)).to(torch.int32)
    n_prop = active_pair.to(torch.int32) * (2 * h)
    return pos_r, pos_b, lp_r, lp_b, n_acc, n_prop, extra_r, extra_b


def _power_update(mover, mover_state, loglike, logprior, active, prior, ll,
                  other, noise, beta, row0=0):
    """One power-posterior half-step of one rung: Metropolis against
    prior·L^β with both −inf guards, so no NaN is ever made. ``row0``: the
    active rows' offset in their half (a rank's shard)."""
    *prop_noise, log_u = noise
    proposal, log_factor = mover.propose(
        active, other, mover_state, *prop_noise,
        **({"row0": row0} if row0 else {}))
    prop_ll = loglike(proposal)
    prop_prior = logprior(proposal)
    # β·Δll with both lls at −inf would be NaN; such a move holds the
    # (zero) likelihood fixed, so its ratio term is 0
    both = torch.isneginf(prop_ll) & torch.isneginf(ll)
    dll = torch.where(both, 0.0, prop_ll - ll)
    # β = 0 (the prior rung) ignores the likelihood entirely: 0·±inf is NaN
    tempered = torch.where(beta > 0.0, beta * dll, 0.0)
    log_ratio = log_factor + (prop_prior - prior) + tempered
    acc = log_u < log_ratio
    return (torch.where(acc[:, None], proposal, active),
            torch.where(acc, prop_prior, prior),
            torch.where(acc, prop_ll, ll))


def _accumulate_evidence(state, ll_red, ll_black, betas):
    """The evidence accumulators after one step whose log-likelihood grids
    are ``ll_red``/``ll_black``: a dict of the six fields."""
    ll_all = torch.cat([ll_red, ll_black], dim=1)  # (K, W)
    # TI: Welford over per-step walker means of log L, finite-masked per
    # rung (one −inf walker must not poison the accumulator into NaN)
    step_mean = torch.mean(ll_all, dim=1)
    finite = torch.isfinite(step_mean)
    safe_mean = torch.where(finite, step_mean, 0.0)
    ll_n = state.ll_n + finite.to(state.ll_n.dtype)
    denom = torch.clamp(ll_n, min=1.0)
    delta = safe_mean - state.ll_mean
    ll_mean = torch.where(finite, state.ll_mean + delta / denom,
                          state.ll_mean)
    ll_m2 = torch.where(finite, state.ll_m2 + delta * (safe_mean - ll_mean),
                        state.ll_m2)
    # stepping stone: streaming logsumexp of Δβ_k·ll over the lower rung's
    # walkers, merged one per-step logsumexp at a time
    dbeta = betas[:-1] - betas[1:]
    lo = ll_all[1:]
    x = torch.where(torch.isneginf(lo), -torch.inf, dbeta[:, None] * lo)
    step_lse = torch.logsumexp(x, dim=1)
    m_new = torch.maximum(state.ss_max, step_lse)
    safe = torch.isfinite(m_new)
    ss_sum = torch.where(
        safe,
        state.ss_sum * torch.exp(torch.where(safe, state.ss_max - m_new, 0.0))
        + torch.exp(torch.where(safe, step_lse - m_new, -torch.inf)),
        0.0,
    )
    return dict(ll_mean=ll_mean, ll_m2=ll_m2, ss_max=m_new, ss_sum=ss_sum,
                acc_n=state.acc_n + 1.0, ll_n=ll_n)


class ParallelTemperingSampler:
    """Replica-exchange ensemble sampler.

    logp_fn: (P,) -> scalar raw log-posterior, or with ``batched=True``
    (n, P) -> (n,). n_temps/betas: ladder size or explicit β vector (β[0]
    must be 1). swap_every: steps between exchange phases. Samples and
    statistics are exposed for the cold (β = 1) replica; swap acceptance
    rates per ladder pair via ``swap_acceptance``.

    Power-posterior (evidence) mode: pass ``loglike_fn`` and
    ``logprior_fn`` INSTEAD of ``logp_fn`` (each per-walker, or batched with
    ``batched=True``); use ``power_ladder`` (it reaches β = 0).
    ``log_evidence()`` gives the stepping-stone (Xie et al. 2011) or
    thermodynamic-integration (Friel & Pettitt 2008) estimate of log Z.

    device: where the grids live (default "cuda"; CUDA without a GPU
    raises). chain: an injected cold-chain store of geometry (W, P) (a
    sharded sampler's: its walkers of the cold rung). mesh: a
    ``WalkerLayout`` or a ``LadderLayout`` splitting the grids over the
    ranks of a process group, on the layout's device.
    """

    def __init__(self, logp_fn=None, n_walkers=None, n_params=None,
                 n_temps=8, betas=None, mover=None, seed=0,
                 dtype=torch.float32, swap_every=1, max_chain_bytes=2 << 30,
                 batched=False, mesh=None, chain=None, loglike_fn=None,
                 logprior_fn=None, device=None):
        if n_walkers is None or n_params is None:
            raise TypeError("n_walkers and n_params are required")
        if n_walkers % 2:
            raise ValueError("n_walkers must be even")
        self.mesh = mesh
        self._ladder = isinstance(mesh, LadderLayout)
        if self._ladder:  # its rows once the ladder's size is known
            self.device = mesh.bind(device)
        else:
            self.device, self._h0, self._hn = _engine_rows(
                mesh, device, int(n_walkers) // 2, "n_walkers/2")
        self.n_walkers = int(n_walkers)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.swap_every = int(swap_every)
        self._power = loglike_fn is not None or logprior_fn is not None
        if self._power:
            if loglike_fn is None or logprior_fn is None:
                raise ValueError("power-posterior mode needs BOTH loglike_fn "
                                 "and logprior_fn")
            if logp_fn is not None:
                raise ValueError(
                    "pass either logp_fn OR (loglike_fn, logprior_fn)")
        elif logp_fn is None:
            raise TypeError("logp_fn is required (or loglike_fn+logprior_fn)")
        if betas is None:
            betas = (power_ladder(n_temps) if self._power
                     else geometric_ladder(n_temps))
        self._set_betas(betas)
        if self._betas_host[0] != 1.0:
            raise ValueError("betas[0] must be 1.0 (the cold chain)")
        if not self._power and self._betas_host[-1] <= 0.0:
            raise ValueError(
                "β=0 tempers the whole posterior to an improper flat target; "
                "β=0 rungs need power-posterior mode (loglike_fn+logprior_fn)")
        self.n_temps = len(self._betas_host)
        self._k0, self._kn = 0, self.n_temps
        if self._ladder:
            (self._k0, self._kn), (self._h0, self._hn) = mesh.grid_rows(
                self.n_temps, self.n_walkers // 2)
        self.mover = mover if mover is not None else StretchMove()
        if self._power and (type(self.mover).propose is Mover.propose
                            or self.mover.always_accept):
            raise ValueError(
                "power-posterior mode needs a propose-based Metropolis mover "
                f"(got {type(self.mover).__name__})")
        if isinstance(self.mover, FusedStretchMove) and self.n_temps > 1:
            raise NotImplementedError(
                "FusedStretchMove does not support tempered acceptance "
                "(beta != 1); use StretchMove for parallel tempering")
        self._mover_state = self.mover.init_state(self.n_params, dtype,
                                                  self.device)

        def batch(fn):
            return fn if batched else torch.func.vmap(fn)

        if self._power:
            self._batched_ll = batch(loglike_fn)
            self._batched_prior = batch(logprior_fn)
        else:
            self._batched_logp = batch(logp_fn)
        self._rung_loop = isinstance(self.mover, _HOST_BRANCHING)
        if self._rung_loop and self._ladder and mesh.n_ladder_shards > 1:
            raise NotImplementedError(
                f"{type(self.mover).__name__} runs its rungs one after "
                "another with host tests that a ladder layout's shards "
                "would take on different rungs; use a WalkerLayout")
        self._vhalf = torch.func.vmap(self._power_rung if self._power
                                      else self._rung)
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self._host_gen = make_generator(seed, HOST_STREAM, "cpu")
        self.state = None
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (2 * self._hn,
                                                     self.n_params):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(n_walkers=2 * self._hn,
                               n_params=self.n_params,
                               max_bytes=max_chain_bytes,
                               dtype=row_dtype(dtype))

    def _set_betas(self, betas):
        """The ladder as a (K,) tensor on the device, rounded to ``dtype``
        as the JAX package rounds it, and as host floats."""
        if not isinstance(betas, torch.Tensor):
            betas = torch.from_numpy(np.asarray(betas, np.float64))
        self.betas = betas.detach().to(self.dtype).to(self.device)
        self._betas_host = self.betas.cpu().tolist()

    # -- one rung's half-step (vmapped over the ladder) ----------------------

    def _rows(self):
        """A sharded half-step's keyword arguments to the mover: its rows'
        offset, and the layout for a host-branching mover's loop tests
        (none unsharded, so a mover subclass without them still runs)."""
        if self.mesh is None:
            return {}
        return {"row0": self._h0,
                "layout": self.mesh if self._rung_loop else None}

    def _rung(self, active, logp, other, noise, beta):
        return self.mover.apply(active, logp, other, self._batched_logp,
                                self._mover_state, noise, beta,
                                **self._rows())[:2]

    def _power_rung(self, active, prior, ll, other, noise, beta):
        return _power_update(self.mover, self._mover_state, self._batched_ll,
                             self._batched_prior, active, prior, ll, other,
                             noise, beta, row0=self._h0)

    def _grid(self, fn, x):
        """A batched (n, P) -> (n,) function on a (K, H, P) grid."""
        return fn(x.reshape(-1, self.n_params)).reshape(x.shape[:2])

    # -- setup ---------------------------------------------------------------

    def _whole_grid(self, x):
        """Every rank's block of a (k, h, …) grid as the whole (K, H, …)
        grid (one all-gather)."""
        if self._ladder:
            return self.mesh.gather_grid(x)
        return self.mesh.gather(x, dim=1)

    def _own(self, x):
        """This rank's block of a whole (K, H, …) grid."""
        return x[self._k0:self._k0 + self._kn,
                 self._h0:self._h0 + self._hn].contiguous()

    def _zero_evidence_acc(self):
        k, kw = self.n_temps, dict(dtype=self.dtype, device=self.device)
        return dict(ll_mean=torch.zeros((k,), **kw),
                    ll_m2=torch.zeros((k,), **kw),
                    ss_max=torch.full((k - 1,), -torch.inf, **kw),
                    ss_sum=torch.zeros((k - 1,), **kw),
                    acc_n=torch.zeros((), **kw),
                    ll_n=torch.zeros((k,), **kw))

    def _init_state(self, red, black):
        """A fresh :class:`PTState` from (K, H, P) halves."""
        extra = {}
        if self._power:
            # the logp grids hold the PRIOR (ll kept apart, so −inf
            # likelihoods never poison the prior through a subtraction)
            lp_red = self._grid(self._batched_prior, red)
            lp_black = self._grid(self._batched_prior, black)
            extra = dict(ll_red=self._grid(self._batched_ll, red),
                         ll_black=self._grid(self._batched_ll, black),
                         **self._zero_evidence_acc())
        else:
            lp_red = self._grid(self._batched_logp, red)
            lp_black = self._grid(self._batched_logp, black)
        zeros = torch.zeros((self.n_temps - 1,), dtype=torch.int64,
                            device=self.device)
        return PTState(red, black, lp_red, lp_black, 0, zeros, zeros.clone(),
                       **extra)

    def init_ball(self, center, scale=1e-2, seed=None):
        """Every replica's walkers in a Gaussian ball around ``center``,
        drawn from the auxiliary generator (or one seeded by ``seed``)."""
        gen = (self._aux_gen if seed is None
               else make_generator(seed, AUX_STREAM, self.device))
        center = torch.as_tensor(center, dtype=self.dtype, device=self.device)
        z = torch.randn((self.n_temps, self.n_walkers, self.n_params),
                        generator=gen, dtype=self.dtype, device=self.device)
        pos = center[None, None, :] + scale * z
        h = self.n_walkers // 2
        red, black = pos[:, :h].contiguous(), pos[:, h:].contiguous()
        if self.mesh is not None:
            red, black = self._own(red), self._own(black)
        self.state = self._init_state(red, black)
        return self

    # -- one step ------------------------------------------------------------

    def draw_step_noise(self, state):
        """Every draw of one step, in a fixed order: the red half's rungs,
        the black half's, and the exchange phase's (None on steps that do
        not swap). A rung's noise is the mover's; under the vmap each plane
        has a leading K axis, in the host-branching case it is a list of K
        per-rung noises. Every rung's and walker's (a sharded sampler's
        step keeps its block's)."""
        k, h, p = self.n_temps, self.n_walkers // 2, self.n_params
        gen, kw = self._step_gen, dict(dtype=self.dtype,
                                       host_gen=self._host_gen)

        def rungs():
            if self._rung_loop:
                return [self.mover.draw_noise(gen, h, h, p, self.device, **kw)
                        for _ in range(k)]
            return self.mover.draw_rung_noise(gen, k, h, h, p, self.device,
                                              **kw)

        red, black = rungs(), rungs()
        swap = None
        if (state.step + 1) % self.swap_every == 0:
            swap = draw_swap_noise(self._step_gen, k, h, self.dtype,
                                   self.device)
        return red, black, swap

    def _block_noise(self, noise):
        """The rank's rungs' and walkers' part of a half-step's noise: each
        rung's cut to the rank's walkers (one vmap over the stacked rungs),
        then the rank's rungs."""
        rungs = slice(self._k0, self._k0 + self._kn)
        if self._rung_loop:
            return [self.mover.noise_rows(n, self._h0, self._hn)
                    for n in noise[rungs]]
        per_rung = torch.func.vmap(
            lambda n: self.mover.noise_rows(n, self._h0, self._hn))(noise)
        return rows_of(per_rung, self._k0, self._kn)

    def _half(self, grids, other, noise):
        """Every rung's half-step: ``grids`` are the active half's grids
        (positions, logp, and in power mode ll); ``other`` the rank's block
        of the other half. Sharded, the other half is gathered first."""
        betas, betas_host = self.betas, self._betas_host
        if self.mesh is not None:
            other = self._whole_grid(other)[self._k0:self._k0 + self._kn]
            noise = self._block_noise(noise)
            betas = betas[self._k0:self._k0 + self._kn]
            betas_host = betas_host[self._k0:self._k0 + self._kn]
        if not self._rung_loop:
            return self._vhalf(*grids, other, noise, betas)
        fn = self._power_rung if self._power else self._rung
        outs = [fn(*(g[i] for g in grids), other[i], noise[i], betas_host[i])
                for i in range(len(betas_host))]
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def _sharded_swap(self, red, black, lp_red, lp_black, parity, swap,
                      ll_red, ll_black):
        """The exchange phase on the rank's block: per walker on its own
        rows under a walker layout; on the gathered grids, keeping the
        block, under a ladder layout (its pairs cross the shards)."""
        extra = {}
        if not self._ladder:
            h = slice(self._h0, self._h0 + self._hn)
            if self._power:
                extra = dict(score_r=ll_red, score_b=ll_black,
                             extra_r=(ll_red,), extra_b=(ll_black,))
            return _swap_phase(red, black, lp_red, lp_black, self.betas,
                               parity, swap[0][:, h], swap[1][:, h], **extra)
        grids = [red, black, lp_red, lp_black]
        if self._power:
            grids += [ll_red, ll_black]
        p = self.n_params
        flat = torch.cat([g.reshape(self._kn, self._hn, -1) for g in grids],
                         -1)
        whole = self._whole_grid(flat)
        widths = [p, p, 1, 1, 1, 1][:len(grids)]
        parts, i = [], 0
        for g, w in zip(grids, widths):
            parts.append(whole[..., i:i + w].reshape(
                whole.shape[:2] + g.shape[2:]).contiguous())
            i += w
        if self._power:
            extra = dict(score_r=parts[4], score_b=parts[5],
                         extra_r=(parts[4],), extra_b=(parts[5],))
        out = _swap_phase(*parts[:4], self.betas, parity, *swap, **extra)
        *own, n_acc, n_prop, ex_r, ex_b = out
        own = [self._own(x) for x in own]
        return (*own, n_acc, n_prop, tuple(self._own(x) for x in ex_r),
                tuple(self._own(x) for x in ex_b))

    def step(self, state, noise=None):
        """One step of every replica: red against black, black against the
        new red, then, on swap steps, an exchange phase. ``noise`` (from
        :meth:`draw_step_noise`, drawn here if None) is how a test hands the
        port the JAX package's draws. Returns the new state."""
        if noise is None:
            noise = self.draw_step_noise(state)
        red_noise, black_noise, swap = noise
        if self._power:
            red, lp_red, ll_red = self._half(
                (state.red, state.logp_red, state.ll_red), state.black,
                red_noise)
            black, lp_black, ll_black = self._half(
                (state.black, state.logp_black, state.ll_black), red,
                black_noise)
        else:
            red, lp_red = self._half((state.red, state.logp_red),
                                     state.black, red_noise)
            black, lp_black = self._half((state.black, state.logp_black),
                                         red, black_noise)
        sa, sp = state.swaps_accepted, state.swaps_proposed
        if swap is not None:
            parity = (state.step // self.swap_every) % 2
            if self.mesh is not None:
                red, black, lp_red, lp_black, n_acc, n_prop, ex_r, ex_b = (
                    self._sharded_swap(
                        red, black, lp_red, lp_black, parity, swap,
                        ll_red if self._power else None,
                        ll_black if self._power else None))
            else:
                extra = (dict(score_r=ll_red, score_b=ll_black,
                              extra_r=(ll_red,), extra_b=(ll_black,))
                         if self._power else {})
                red, black, lp_red, lp_black, n_acc, n_prop, ex_r, ex_b = (
                    _swap_phase(red, black, lp_red, lp_black, self.betas,
                                parity, *swap, **extra))
            sa, sp = sa + n_acc, sp + n_prop
            if self._power:
                ll_red, ll_black = ex_r[0], ex_b[0]
        if not self._power:
            return PTState(red, black, lp_red, lp_black, state.step + 1, sa,
                           sp)
        whole_r, whole_b = ll_red, ll_black
        if self.mesh is not None:
            whole_r, whole_b = self._whole_grid(
                torch.stack([ll_red, ll_black], -1)).unbind(-1)
            whole_r, whole_b = whole_r.contiguous(), whole_b.contiguous()
        return PTState(red, black, lp_red, lp_black, state.step + 1, sa, sp,
                       ll_red=ll_red, ll_black=ll_black,
                       **_accumulate_evidence(state, whole_r, whole_b,
                                              self.betas))

    def _cold_rows(self, state):
        """The cold replica as a stored row: positions (W, P) and the RAW
        log-posterior (W,) (power mode: prior + log-likelihood); a rank's
        walkers of it, ``[red, black]``, when sharded (under a ladder layout
        the first ladder shard's, gathered)."""
        pos = torch.cat([state.red[0], state.black[0]])
        if self._power:
            lp = torch.cat([state.logp_red[0] + state.ll_red[0],
                            state.logp_black[0] + state.ll_black[0]])
        else:
            lp = torch.cat([state.logp_red[0], state.logp_black[0]])
        if self._ladder:
            # rank (0, w) holds the cold rung's walker shard w
            row = self.mesh.stack(torch.cat([pos, lp[:, None]], 1))
            row = row[self.mesh.walker_index]
            pos, lp = row[:, :-1].contiguous(), row[:, -1].contiguous()
        return pos, lp

    # -- driver --------------------------------------------------------------

    def _run_chunk(self, take, thin):
        """``take·thin`` steps, the cold replica of every ``thin``-th stored
        into device tensors (take, W, P) and (take, W)."""
        pos = torch.empty((take, 2 * self._hn, self.n_params),
                          dtype=self.dtype, device=self.device)
        lps = torch.empty((take, 2 * self._hn), dtype=self.dtype,
                          device=self.device)
        state = self.state
        for s in range(take):
            for _ in range(thin):
                state = self.step(state)
            pos[s], lps[s] = self._cold_rows(state)
        self.state = state
        return pos, lps

    def run_mcmc(self, n_steps, thin=1):
        """Advance all replicas; store the cold chain every ``thin`` steps.

        Returns False if the cold chain hit its byte capacity (further
        stores are skipped, ≙ EndOfChain), else True. Leftover
        ``n_steps % thin`` steps still advance the replicas unstored. Chunk
        k is enqueued before chunk k−1 lands.
        """
        if self.state is None:
            raise RuntimeError("call init_ball first")
        if int(n_steps) > (1 << 30):
            raise ValueError("split runs over 2^30 steps into multiple calls")
        thin = int(thin)
        if thin < 1:
            raise ValueError("thin must be >= 1")
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        chunk = default_chunk_steps(self.n_walkers, self.n_params,
                                    row_dtype(self.dtype))

        def launch(take):
            return self._run_chunk(take, thin)

        def fetch(rows):
            return self.chain.append(*rows)

        ok = run_pipelined(n_store, chunk, launch, fetch)
        if ok and leftover:
            state = self.state
            for _ in range(leftover):
                state = self.step(state)
            self.state = state
        return ok

    def tune_ladder(self, n_blocks=10, block_steps=100, target=0.4,
                    eta=0.6, min_rate=0.02):
        """Adapt the β ladder toward uniform swap acceptance ≈ ``target``.

        Multiplicative log-spacing updates per block: pairs swapping too
        often move apart, pairs swapping too rarely move together; β[0]
        stays 1. Call before production sampling (the chain is cleared
        afterwards). Returns self. Not available in power-posterior mode,
        whose estimators need the declared ladder and its β = 0 rung.
        """
        if self._power:
            raise RuntimeError(
                "tune_ladder is not supported in power-posterior mode — the "
                "β=0 rung is required and log-gap tuning would remove it; "
                "shape the ladder with power_ladder(K, exponent)")
        if self.state is None:
            raise RuntimeError("call init_ball first")
        log_gaps = -np.diff(np.log(np.asarray(self._betas_host, np.float64)))
        for _ in range(int(n_blocks)):
            before_acc, before_prop = self._swap_counts()
            self.run_mcmc(int(block_steps), thin=int(block_steps))
            after_acc, after_prop = self._swap_counts()
            d_acc = after_acc - before_acc
            d_prop = np.maximum(after_prop - before_prop, 1)
            rates = np.maximum(d_acc / d_prop, min_rate)
            # too-frequent swaps -> widen the gap; too-rare -> shrink it
            log_gaps = np.clip(log_gaps * (rates / target) ** eta, 1e-3, 10.0)
            self._set_betas(np.exp(-np.concatenate([[0.0],
                                                    np.cumsum(log_gaps)])))
        self.chain.clear()
        s = self.state
        self.state = s._replace(
            swaps_accepted=torch.zeros_like(s.swaps_accepted),
            swaps_proposed=torch.zeros_like(s.swaps_proposed))
        return self

    # -- evidence (power-posterior mode) -------------------------------------

    def _require_power(self):
        if not self._power:
            raise RuntimeError("evidence requires power-posterior mode")

    def reset_evidence(self):
        """Zero the on-device evidence accumulators (after burn-in, before
        the run the estimate should come from)."""
        self._require_power()
        if self.state is not None:
            self.state = self.state._replace(**self._zero_evidence_acc())
        return self

    def ti_curve(self):
        """(betas ascending, E_β[log L] ascending), float64 numpy: the
        thermodynamic integrand."""
        self._require_power()
        betas = np.asarray(self._betas_host, np.float64)[::-1]
        means = self.state.ll_mean.cpu().numpy().astype(np.float64)[::-1]
        return betas, means

    def log_evidence(self, method="stepping_stone"):
        """log Z = log ∫ prior·L from the accumulated power-posterior run:
        ``stepping_stone`` (Σ_k log E_{β_{k+1}}[L^{Δβ_k}] over the lower
        rung's walkers) or ``ti`` (trapezoidal ∫_0^1 E_β[log L] dβ)."""
        self._require_power()
        if self.state is None or float(self.state.acc_n) == 0:
            raise RuntimeError("run_mcmc first (no accumulated steps)")
        acc_n = float(self.state.acc_n)
        n = acc_n * self.n_walkers
        if method == "stepping_stone":
            m = self.state.ss_max.cpu().numpy().astype(np.float64)
            s = self.state.ss_sum.cpu().numpy().astype(np.float64)
            return float(np.sum(m + np.log(np.maximum(s, 1e-300))
                                - np.log(n)))
        if method == "ti":
            betas, means = self.ti_curve()
            if betas[0] > 1e-6:
                warnings.warn(
                    f"TI ladder starts at β={betas[0]:.4g}, not 0 — the "
                    "integral misses the prior end; use power_ladder",
                    stacklevel=2)
            ll_n = self.state.ll_n.cpu().numpy().astype(np.float64)
            if (ll_n < acc_n).any():
                warnings.warn(
                    "some rungs had steps with non-finite mean log L "
                    "(hard-constraint likelihood); the TI integrand is "
                    "conditioned on finite steps and may be biased — prefer "
                    "stepping_stone", stacklevel=2)
            trapezoid = getattr(np, "trapezoid", None) or np.trapz
            return float(trapezoid(means, betas))
        raise ValueError(f"unknown method {method!r}")

    # -- statistics & access -------------------------------------------------

    def _swap_counts(self):
        """(accepted, proposed) exchanges per ladder pair, int64 numpy (a
        walker layout's ranks' counts summed: one all-gather)."""
        acc, prop = self.state.swaps_accepted, self.state.swaps_proposed
        if self.mesh is not None and not self._ladder:
            acc, prop = self.mesh.stack(torch.stack([acc, prop])).sum(0)
        return acc.cpu().numpy(), prop.cpu().numpy()

    @property
    def swap_acceptance(self):
        """Per-ladder-pair swap acceptance rates, (K−1,)."""
        acc, prop = self._swap_counts()
        return np.where(prop > 0, acc / np.maximum(prop, 1), 0.0)

    def get_samples(self, burn_in=0, thin=1, flat=False):
        """Cold-chain (β = 1) samples."""
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        """Cold-chain RAW log-posteriors (stored untempered)."""
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)
