"""Hamiltonian Monte Carlo over a batch of chains, and the shared sampler.

PyTorch counterpart of ``mcmcpp_tpu/gradient/hmc.py``. JAX writes one chain's
transition and vmaps it; here every transition is written for the whole
``(C, P)`` batch at once, and each is split in two:

    noise = kernel.draw_noise(gen, state, host_gen)       # every draw
    state, info = kernel.apply(noise, state, step_size, inv_mass)

so that a test can hand ``apply`` the numbers the JAX package drew. The logp
is batched, ``(C, P) -> (C,)`` (a :class:`~mcmcpp_tpu_torch.models.targets.
Target`, a :class:`GaussianTarget` or any such callable); :func:`logp_and_grad`
takes its value and gradient for the whole batch by autograd, which is exact
because the rows are independent. States hold detached tensors.

Warmup adapts a per-chain step size by dual averaging (Hoffman & Gelman 2014
§3.2, vectorized over the chain axis) and a shared mass matrix by Welford
accumulation over every chain's position: ``metric="diag"`` (default)
per-parameter variances, ``metric="dense"`` the full covariance (see
``gradient/metric.py``). ``lax.scan`` becomes a Python loop that enqueues the
steps on the device; ``run`` writes every ``thin``-th state into a device chunk
that lands in the host :class:`~mcmcpp_tpu_torch.chain.Chain` through
``run_pipelined``, with the sample stats (``diverging``, ``energy``) aligned
to the chain.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import (
    Chain,
    default_chunk_steps,
    row_dtype,
    run_pipelined,
)
from mcmcpp_tpu_torch.gradient.metric import (
    dense_mass_from_cov,
    mass_kinetic,
    mass_momentum,
    mass_velocity,
    matmul,
)
from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    HOST_STREAM,
    STEP_STREAM,
    make_generator,
    neg_exponential,
    normal,
)
from mcmcpp_tpu_torch.sampler import resolve_device

# energy error marking a transition divergent (Stan's default), surfaced as
# ``sample_stats.diverging``
DIVERGENCE_THRESHOLD = 1000.0


class HMCState(NamedTuple):
    position: torch.Tensor  # (C, P)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, P)


class DualAveragingState(NamedTuple):
    """Tensors of the step size's shape, and ``count``, a host int."""

    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: int


class WelfordState(NamedTuple):
    """``mean`` (P,), ``m2`` (P,) or (P, P), ``count`` a host int."""

    mean: torch.Tensor
    m2: torch.Tensor
    count: int


def scalar(x, dtype=torch.float32):
    """A CPU scalar of ``dtype``: the host side of JAX's scalar math, which
    runs at the dtype of the arrays it meets."""
    return torch.tensor(float(x), dtype=dtype)


def as_positions(positions, n_chains, n_params, dtype, device):
    """``positions`` (C, P) as a tensor of ``dtype`` on ``device`` (a copy of
    a numpy array: the JAX package's host arrays are read-only views)."""
    if not isinstance(positions, torch.Tensor):
        positions = torch.from_numpy(np.array(positions))
    positions = positions.to(dtype=dtype, device=device)
    if tuple(positions.shape) != (n_chains, n_params):
        raise ValueError(f"positions must be ({n_chains}, {n_params})")
    return positions


def ball(sampler, center, scale, seed):
    """``center + scale·z`` for every chain of ``sampler``, z from its
    auxiliary generator, or from one seeded by ``seed``."""
    gen = (sampler._aux_gen if seed is None
           else make_generator(seed, AUX_STREAM, sampler.device))
    center = torch.as_tensor(center, dtype=sampler.dtype,
                             device=sampler.device)
    z = normal(gen, (sampler.n_chains, sampler.n_params), sampler.dtype,
               sampler.device)
    return center[None, :] + scale * z


def logp_and_grad(logp_fn, q):
    """(logp (C,), ∇logp (C, P)) of the batched ``logp_fn`` at ``q``, both
    detached: one backward pass of the summed logp."""
    with torch.enable_grad():
        x = q.detach().requires_grad_()
        lp = logp_fn(x)
        (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def column(step_size):
    """A (C,) per-chain step size as a (C, 1) column; a scalar as is."""
    if isinstance(step_size, torch.Tensor) and step_size.ndim == 1:
        return step_size[:, None]
    return step_size


def metropolis(log_ratio, log_u):
    """The accept rule of the family: a NaN ratio becomes −inf, divergent
    below −DIVERGENCE_THRESHOLD, ``accept_prob = min(1, e^ratio)``, and the
    chain moves iff ``log_u < log_ratio`` (strict; log u = −Exp(1)).
    Returns (accept_prob, accept, diverging)."""
    log_ratio = torch.where(torch.isnan(log_ratio), -torch.inf, log_ratio)
    diverging = log_ratio < -DIVERGENCE_THRESHOLD
    accept_prob = torch.clamp_max(torch.exp(log_ratio), 1.0)
    return accept_prob, log_u < log_ratio, diverging


def select_state(accept, new, old):
    """Per-chain ``where(accept, new, old)`` over a state's fields."""
    return type(old)(*(
        torch.where(accept[:, None] if a.ndim == 2 else accept, a, b)
        for a, b in zip(new, old)))


def axpy(x, a, y):
    """``x + a·y`` in one launch, ``a`` a tensor (a per-chain column) or a
    number."""
    if isinstance(a, torch.Tensor):
        return torch.addcmul(x, a, y)
    return torch.add(x, y, alpha=a)


def leapfrog(logp_fn, q, p, g, inv_mass, eps, n_steps):
    """``n_steps`` leapfrog steps with half kicks at the ends of each;
    returns (q, p, logp, grad) at the end."""
    lp, half = None, 0.5 * eps
    for _ in range(n_steps):
        p = axpy(p, half, g)
        q = axpy(q, eps, mass_velocity(inv_mass, p))
        lp, g = logp_and_grad(logp_fn, q)
        p = axpy(p, half, g)
    return q, p, lp, g


class GradientKernel:
    """A batched transition: ``draw_noise`` then a deterministic ``apply``
    (≙ the per-chain kernels of the JAX package, vmapped)."""

    def __init__(self, logp_fn):
        self.logp_fn = logp_fn

    def draw_noise(self, gen, state, host_gen=None):
        raise NotImplementedError

    def apply(self, noise, state, step_size, inv_mass):
        """-> (state, (accept_prob, accepted, diverging, energy)), each (C,)."""
        raise NotImplementedError


class HMCKernel(GradientKernel):
    """Fixed-length HMC; noise ``(z (C, P), log_u (C,))``: the momentum's
    standard normals and −Exp(1) (≙ ``hmc.py:89-109``). ``energy`` is the
    Hamiltonian after the momentum refresh (the E-BFMI statistic)."""

    def __init__(self, logp_fn, n_leapfrog):
        super().__init__(logp_fn)
        self.n_leapfrog = int(n_leapfrog)

    def draw_noise(self, gen, state, host_gen=None):
        q = state.position
        return (normal(gen, q.shape, q.dtype, q.device),
                neg_exponential(gen, q.shape[0], q.dtype, q.device))

    def apply(self, noise, state, step_size, inv_mass):
        z, log_u = noise
        momentum = mass_momentum(inv_mass, z)
        kinetic0 = mass_kinetic(inv_mass, momentum)
        energy = kinetic0 - state.logp
        q, p, lp, g = leapfrog(self.logp_fn, state.position, momentum,
                               state.grad, inv_mass, column(step_size),
                               self.n_leapfrog)
        log_ratio = (lp - mass_kinetic(inv_mass, p)) - (state.logp - kinetic0)
        accept_prob, accept, diverging = metropolis(log_ratio, log_u)
        return (select_state(accept, HMCState(q, lp, g), state),
                (accept_prob, accept, diverging, energy))


def hmc_kernel(logp_fn, n_leapfrog):
    """The batched HMC transition (≙ ``mcmcpp_tpu.gradient.hmc_kernel``)."""
    return HMCKernel(logp_fn, n_leapfrog)


# -- dual averaging (Hoffman & Gelman 2014, §3.2; vectorizes over chains) ----


def da_init(step_size):
    log_step = torch.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        h_sum=torch.zeros_like(log_step),
        mu=float(torch.log(scalar(10.0, log_step.dtype))) + log_step,
        count=0,
    )


def da_update(da, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    """One dual-averaging update; the scalar factors at the state's dtype as
    in JAX (the count is an int32 there, a host int here)."""
    count = da.count + 1
    tf = scalar(count, da.log_step.dtype)
    h_sum = da.h_sum + (target - accept_prob)
    log_step = da.mu - float(torch.sqrt(tf) / gamma) * h_sum / float(tf + t0)
    eta = float(tf ** -kappa)
    log_step_avg = eta * log_step + (1 - eta) * da.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_sum, da.mu, count)


# -- Welford moments (batched over chains; diag variance or full cov) --------


def welford_init(shape, dtype, device):
    """``shape=(P,)`` accumulates per-parameter variances, ``(P, P)`` the
    full scatter matrix of the dense metric."""
    return WelfordState(
        mean=torch.zeros((shape[0],), dtype=dtype, device=device),
        m2=torch.zeros(shape, dtype=dtype, device=device),
        count=0,
    )


def welford_update_batch(w, x):
    """Fold a whole (C, P) batch into the running moments (Chan et al.)."""
    c = x.shape[0]
    count = w.count + c
    batch_mean = torch.mean(x, dim=0)
    centered = x - batch_mean
    delta = batch_mean - w.mean
    nf, wf = scalar(count, x.dtype), scalar(w.count, x.dtype)
    mean = w.mean + delta * float(c / nf)
    scale = float(wf * c / nf)
    if w.m2.ndim == 2:
        m2 = (w.m2 + matmul(centered.T, centered)
              + torch.outer(delta, delta) * scale)
    else:
        m2 = w.m2 + torch.sum(centered ** 2, dim=0) + delta ** 2 * scale
    return WelfordState(mean, m2, count)


def _shrinkage(count, dtype):
    """Stan's shrinkage toward 1e-3 at small counts: (weight, floor)."""
    c = scalar(count, dtype)
    return float(c / (c + 5.0)), float(1e-3 * (5.0 / (c + 5.0)))


def welford_variance(w, regularize=True):
    var = w.m2 / float(scalar(max(w.count - 1, 1), w.m2.dtype))
    if regularize:
        weight, floor = _shrinkage(w.count, w.m2.dtype)
        var = weight * var + floor
    return var


def welford_covariance(w, regularize=True):
    """Covariance from a rank-2 accumulator, shrunk toward 1e-3·I at small
    counts (keeps the Cholesky well-posed before the estimate settles)."""
    cov = w.m2 / float(scalar(max(w.count - 1, 1), w.m2.dtype))
    if regularize:
        weight, floor = _shrinkage(w.count, w.m2.dtype)
        eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        cov = weight * cov + floor * eye
    return cov


class GradientSampler:
    """Shared sampler of the batched gradient kernels (HMC, NUTS, MALA,
    Barker, ChEES, MEADS).

    ``logp_fn`` maps (C, P) -> (C,). ``warmup`` adapts; ``run`` samples into
    the host :class:`Chain`. Randomness: the kernels draw from a generator
    on ``device`` (``seed``'s step stream), ``init_ball`` from the auxiliary
    stream, and host-side choices (ChEES's jitter) from a CPU generator.
    ``device`` defaults to "cuda"; CUDA without a GPU raises.
    """

    needs_mass = True

    def __init__(self, logp_fn, n_chains, n_params, seed=0,
                 dtype=torch.float32, step_size=0.1, target_accept=0.8,
                 max_chain_bytes=2 << 30, chain=None, metric="diag",
                 device="cuda"):
        self.device = resolve_device(device)
        self.logp_fn = logp_fn
        self.n_chains = int(n_chains)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.step_size = float(step_size)
        self.target_accept = float(target_accept)
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self._host_gen = make_generator(seed, HOST_STREAM, "cpu")
        if metric not in ("diag", "dense"):
            raise ValueError(f"metric must be 'diag' or 'dense', got {metric!r}")
        self.metric = metric
        eye = torch.eye(self.n_params, dtype=dtype, device=self.device)
        self.inv_mass = (dense_mass_from_cov(eye) if metric == "dense"
                         else torch.ones((self.n_params,), dtype=dtype,
                                         device=self.device))
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
        self._kernel = self._make_kernel()
        self.last_mean_accept = None
        # per-stored-step sample stats, one numpy block per landed chunk
        self._divergences = []  # (S_chunk, C) bool
        self._energies = []  # (S_chunk, C)

    def _make_kernel(self):
        """Subclass hook: the :class:`GradientKernel`."""
        raise NotImplementedError

    def _step(self, state, step_size, inv_mass):
        noise = self._kernel.draw_noise(self._step_gen, state,
                                        host_gen=self._host_gen)
        return self._kernel.apply(noise, state, step_size, inv_mass)

    def _require_state(self):
        if self.state is None:
            raise RuntimeError("call init/init_ball first")

    # -- init ----------------------------------------------------------------

    def _positions(self, positions):
        return as_positions(positions, self.n_chains, self.n_params,
                            self.dtype, self.device)

    def init(self, positions):
        positions = self._positions(positions)
        self.state = HMCState(positions, *logp_and_grad(self.logp_fn,
                                                        positions))
        return self

    def init_ball(self, center, scale=1.0, seed=None):
        """Positions ``center + scale·z``, z from the auxiliary generator
        (or from one seeded by ``seed``)."""
        return self.init(ball(self, center, scale, seed))

    # -- warmup --------------------------------------------------------------

    def _step_vector(self):
        """The step size as a (C,) tensor on the device."""
        return torch.as_tensor(self.step_size, dtype=self.dtype,
                               device=self.device).expand(
                                   self.n_chains).clone()

    def _welford_init(self):
        p = self.n_params
        shape = (p, p) if self.metric == "dense" else (p,)
        return welford_init(shape, self.dtype, self.device)

    def _mass_from_welford(self, wf):
        """The current estimate (rebuilt every warmup step, so early steps
        use the shrunk prior)."""
        if self.metric == "dense":
            return dense_mass_from_cov(welford_covariance(wf))
        return welford_variance(wf)

    def warmup(self, n_steps, adapt_mass=True):
        """Adapt the per-chain step size (dual averaging) and the mass matrix
        (Welford variances for ``metric="diag"``, the covariance for
        ``"dense"``). No host sync."""
        self._require_state()
        adapt_mass = bool(adapt_mass and self.needs_mass)
        da = da_init(self._step_vector())
        wf = self._welford_init()
        state = self.state
        for _ in range(int(n_steps)):
            inv_mass = (self._mass_from_welford(wf) if adapt_mass
                        else self.inv_mass)
            state, (ap, *_) = self._step(state, torch.exp(da.log_step),
                                         inv_mass)
            da = da_update(da, ap, target=self.target_accept)
            if adapt_mass:
                wf = welford_update_batch(wf, state.position)
        self.state = state
        # per-chain adapted step sizes
        self.step_size = torch.exp(da.log_step_avg)
        if adapt_mass:
            self.inv_mass = self._mass_from_welford(wf)
        return self

    # -- sampling --------------------------------------------------------------

    def _run_step(self, state, step_size, inv_mass):
        """One sampling transition (ChEES adds its jitter here)."""
        return self._step(state, step_size, inv_mass)

    def _run_chunk(self, take, thin, step_size):
        """``take·thin`` transitions, every ``thin``-th stored into device
        tensors: (pos (take, C, P), logp (take, C), mean accept (a device
        scalar), diverging (take, C), energy (take, C), take). Any divergence
        inside a thin window flags the stored step; the energy is the last
        transition's."""
        c, p, dev = self.n_chains, self.n_params, self.device
        pos = torch.empty((take, c, p), dtype=self.dtype, device=dev)
        lps = torch.empty((take, c), dtype=self.dtype, device=dev)
        divs = torch.zeros((take, c), dtype=torch.bool, device=dev)
        ens = torch.empty((take, c), dtype=self.dtype, device=dev)
        acc = torch.zeros((), dtype=self.dtype, device=dev)
        state = self.state
        for s in range(take):
            for _ in range(thin):
                state, (ap, _, div, en) = self._run_step(state, step_size,
                                                         self.inv_mass)
                acc = acc + torch.mean(ap)
                divs[s] |= div
            pos[s] = state.position
            lps[s] = state.logp
            ens[s] = en
        self.state = state
        return pos, lps, acc / (take * thin), divs, ens, take

    def _store_chunk_steps(self):
        """Stored steps per device chunk: ~64 MiB of positions and logps."""
        return default_chunk_steps(self.n_chains, self.n_params,
                                   row_dtype(self.dtype))

    def run(self, n_steps, thin=1, checkpoint_path=None, checkpoint_every=1):
        """Sample ``n_steps`` post-warmup transitions, storing every
        ``thin``-th. Returns True, or False if the host chain hit its byte
        capacity. ``n_steps % thin`` leftover transitions still advance the
        state, unstored. Chunk k is enqueued before chunk k−1 lands.

        ``checkpoint_path``: a resumable checkpoint (``io.checkpoint``) is
        written after every ``checkpoint_every`` landed chunks, with the
        in-flight chunk landed first, and once more at the end.
        """
        self._require_state()
        thin = int(thin)
        if thin < 1:
            raise ValueError("thin must be >= 1")
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        step_size = self._step_vector()
        acc_sum, acc_n = 0.0, 0

        def launch(take):
            return self._run_chunk(take, thin, step_size)

        def fetch(chunk):
            nonlocal acc_sum, acc_n
            pos, lps, acc, divs, ens, take = chunk
            before = self.chain.n_steps
            appended = self.chain.append(pos, lps)
            # stats stay chain-aligned through a cap-truncated append: keep
            # only the rows the chain took
            took = self.chain.n_steps - before
            self._divergences.append(divs[:took].cpu().numpy())
            self._energies.append(ens[:took].cpu().numpy())
            acc_sum += float(acc) * take
            acc_n += take
            return appended

        def on_drop(chunk):
            # the launched chunk advanced the state; keep its acceptance
            nonlocal acc_sum, acc_n
            acc_sum += float(chunk[2]) * chunk[-1]
            acc_n += chunk[-1]

        checkpoint_save = None
        if checkpoint_path is not None:
            from mcmcpp_tpu_torch.io.checkpoint import save_checkpoint

            def checkpoint_save():
                save_checkpoint(self, checkpoint_path)

        ok = run_pipelined(n_store, self._store_chunk_steps(), launch, fetch,
                           on_drop=on_drop, checkpoint_save=checkpoint_save,
                           checkpoint_every=checkpoint_every)
        if ok and leftover:
            acc = self._run_chunk(1, leftover, step_size)[2]
            acc_sum += float(acc)
            acc_n += 1
        if acc_n:
            self.last_mean_accept = acc_sum / acc_n
        if ok and checkpoint_save is not None:
            checkpoint_save()  # final snapshot
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)

    def get_sample_stats(self, burn_in=0, thin=1):
        """Per-stored-step diagnostics, sliced like :meth:`get_samples`:
        ``diverging`` (S, C) bool — a divergent transition inside the step's
        thin window — and ``energy`` (S, C), the post-refresh Hamiltonian
        (E-BFMI). ``export.to_inference_dict`` carries both."""
        if self._divergences:
            div = np.concatenate(self._divergences, axis=0)
            en = np.concatenate(self._energies, axis=0)
        else:
            div = np.zeros((0, self.n_chains), bool)
            en = np.zeros((0, self.n_chains), np.float32)
        n = self.chain.n_steps  # cap-truncated chunks store fewer rows
        return {"diverging": div[:n][burn_in::thin],
                "energy": en[:n][burn_in::thin]}

    @property
    def divergence_count(self):
        """Stored-step divergences per chain, (C,) int64."""
        return self.get_sample_stats()["diverging"].sum(axis=0)


class HMCSampler(GradientSampler):
    """HMC with fixed leapfrog length ``n_leapfrog`` and adapted step size."""

    def __init__(self, *args, n_leapfrog=16, **kwargs):
        self.n_leapfrog = int(n_leapfrog)
        super().__init__(*args, **kwargs)

    def _make_kernel(self):
        return hmc_kernel(self.logp_fn, self.n_leapfrog)

