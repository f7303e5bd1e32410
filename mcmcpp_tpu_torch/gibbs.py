"""Blocked Gibbs: composable per-block kernels, C chains in lockstep.

PyTorch counterpart of ``mcmcpp_tpu/gibbs.py``: Metropolis-within-Gibbs over
named parameter blocks, each updated by the kernel that fits its
conditional structure (elliptical slice for a Gaussian-prior latent, a
gradient kernel for hyperparameters, exact conjugate or categorical draws,
ASIS interweaving for the hyper/latent pair).

Where a JAX kernel updates one chain (``step(key, x (size,), others)``,
vmapped over chains by the sampler), a port kernel updates the whole
(C, …) batch:

    noise = kernel.draw_noise(gen, x (C, size), others {name: (C, size)})
    x_new = kernel.apply(noise, x, others)

The user's conditional-density callables stay per-chain, as in the JAX
package (``logp_fn(x (size,), others {name: (size,)})``), and each kernel
wraps them with ``torch.func.vmap`` unless it is built with
``batched=True``, in which case they take and return the (C, …) batch. A
kernel that has no ``draw_noise``/``apply`` may define ``step(gen, x,
others)`` instead. The draws of a kernel whose size depends on the state (a
categorical block's Gumbel noise, the elliptical slice loop's shrink
uniforms) are functions in its noise, called when the kernel reaches them.

Differences from the JAX package, by design: ``ExactGibbsKernel``'s
``sample_fn`` takes a ``torch.Generator`` where JAX's takes a key (vmapped
with ``randomness="different"``, so chains draw independently); each sweep
draws block by block from one generator where JAX folds the block index
into a per-chain key; the categorical draw is argmax(logits + Gumbel), as
``jax.random.categorical`` is, so a test can hand the port JAX's Gumbel
noise.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import default_chunk_steps, row_dtype, \
    run_pipelined
from mcmcpp_tpu_torch.elliptical import TWO_PI, U_FLOOR, as_tensor, \
    check_chain, shrink_loop
from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
from mcmcpp_tpu_torch.ops.random import (
    STEP_STREAM,
    exponential,
    make_generator,
    neg_exponential,
    normal,
    randint,
    uniform,
)
from mcmcpp_tpu_torch.sampler import resolve_device


def per_chain(fn, batched):
    """``fn`` on the (C, …) batch: itself if ``batched``, else its
    ``torch.func.vmap`` over every argument's leading axis."""
    if batched or fn is None:
        return fn
    vmapped = torch.func.vmap(fn)

    def call(*args):
        # nothing to map over (a lone block's empty ``others``)
        if not any(isinstance(a, torch.Tensor) or (isinstance(a, dict) and a)
                   for a in args):
            return fn(*args)
        return vmapped(*args)

    return call


def matvec(a, x):
    """a @ x on the last axes, for one chain ((N, N), (N,)) or a batch
    ((C, N, N), (C, N))."""
    return (a @ x[..., None])[..., 0]


def tri_solve(chol, f):
    """L⁻¹ f for lower-triangular L, per chain: (N, N) with (N,), or the
    batched solve of (C, N, N) factors against their own (C, N) right-hand
    sides (never one factor against every chain's)."""
    return torch.linalg.solve_triangular(chol, f[..., None], upper=False)[
        ..., 0]


def constant(held, value, x):
    """``value`` (a number, an array or a tensor) as a tensor of ``x``'s
    dtype on its device, with no copy from the host after the first: a
    number is filled in on the device, anything else is copied once and kept
    in ``held`` (the kernel's dict), since a copy from pageable host memory
    waits for the device."""
    if not isinstance(value, torch.Tensor) and np.ndim(value) == 0:
        return torch.full((), float(value), dtype=x.dtype, device=x.device)
    key = (id(value), x.device, x.dtype)
    if key not in held:
        held[key] = (value, as_tensor(value, x.dtype, x.device))
    return held[key][1]


def _rows(mask, x):
    """A (C,) mask broadcast against ``x`` (C, …)."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


def _metropolis(log_u, log_ratio, prop, x):
    return torch.where(_rows(log_u < log_ratio, x), prop, x)


class RWMKernel:
    """Gaussian random-walk Metropolis on ``logp_fn(x, others)``. Noise:
    (z like x, log u (C,))."""

    def __init__(self, logp_fn, scale, batched=False):
        self._logp = per_chain(logp_fn, batched)
        self.scale = scale
        self._held = {}

    def draw_noise(self, gen, x, others):
        return (normal(gen, tuple(x.shape), x.dtype, x.device),
                neg_exponential(gen, x.shape[0], x.dtype, x.device))

    def apply(self, noise, x, others):
        z, log_u = noise
        prop = x + constant(self._held, self.scale, x) * z
        log_ratio = self._logp(prop, others) - self._logp(x, others)
        return _metropolis(log_u, log_ratio, prop, x)


class MALAKernel:
    """One Metropolis-adjusted Langevin step on ``logp_fn(x, others)``, its
    gradient by autograd. Noise: (z like x, log u (C,))."""

    def __init__(self, logp_fn, step_size, batched=False):
        self._logp = per_chain(logp_fn, batched)
        self.step_size = float(step_size)

    draw_noise = RWMKernel.draw_noise

    def apply(self, noise, x, others):
        z, log_u = noise
        eps = torch.full((), self.step_size, dtype=x.dtype, device=x.device)
        lp, g = logp_and_grad(lambda v: self._logp(v, others), x)
        prop = x + 0.5 * eps ** 2 * g + eps * z
        lp2, g2 = logp_and_grad(lambda v: self._logp(v, others), prop)
        fwd = -torch.sum((prop - x - 0.5 * eps ** 2 * g) ** 2,
                         dim=-1) / (2 * eps ** 2)
        rev = -torch.sum((x - prop - 0.5 * eps ** 2 * g2) ** 2,
                         dim=-1) / (2 * eps ** 2)
        return _metropolis(log_u, lp2 - lp + rev - fwd, prop, x)


class HMCKernel:
    """Leapfrog HMC on ``logp_fn(x, others)`` (identity mass). Each chain's
    leapfrog count is drawn from {1, …, n_leapfrog} (Neal 2011 §3.2); the
    batch runs ``n_leapfrog`` steps with each chain frozen after its own
    count, so the step needs no host sync. Noise: (p0 like x, counts (C,)
    int64, log u (C,))."""

    def __init__(self, logp_fn, step_size, n_leapfrog=8, batched=False):
        self._logp = per_chain(logp_fn, batched)
        self.step_size = float(step_size)
        self.n_leapfrog = int(n_leapfrog)

    def draw_noise(self, gen, x, others):
        c = x.shape[0]
        return (normal(gen, tuple(x.shape), x.dtype, x.device),
                randint(gen, 1, self.n_leapfrog + 1, (c,), x.device),
                neg_exponential(gen, c, x.dtype, x.device))

    def apply(self, noise, x, others):
        p0, n_leap, log_u = noise
        eps = torch.full((), self.step_size, dtype=x.dtype, device=x.device)

        def vg(v):
            return logp_and_grad(lambda w: self._logp(w, others), v)

        lp0, g = vg(x)
        q, p = x, p0
        for i in range(self.n_leapfrog):
            live = _rows(i < n_leap, x)
            p_half = p + 0.5 * eps * g
            q_new = q + eps * p_half
            _, g_new = vg(q_new)
            p_new = p_half + 0.5 * eps * g_new
            q = torch.where(live, q_new, q)
            p = torch.where(live, p_new, p)
            g = torch.where(live, g_new, g)
        lp1 = self._logp(q, others).detach()
        log_ratio = (lp1 - lp0) - 0.5 * (torch.sum(p * p, dim=-1)
                                         - torch.sum(p0 * p0, dim=-1))
        return _metropolis(log_u, log_ratio, q, x)


class EllipticalSliceKernel:
    """Exact rejection-free update for a block with a Gaussian prior
    (Murray, Adams & MacKay 2010). ``loglike_fn(x, others)`` is the block's
    log-likelihood; the prior is N(mean, L Lᵀ) with ``prior_mean`` a
    constant or a function of ``others`` and exactly one of ``prior_chol`` /
    ``prior_scale`` (each a constant or a function of ``others``). The
    shrinking loop runs ``elliptical.CHECK_EVERY`` iterations between host
    tests of "every chain done", finished chains masked; a chain at
    ``max_shrink`` keeps its state. Noise: (z like x, u (C,), theta (C,),
    shrink_uniforms(j))."""

    def __init__(self, loglike_fn, prior_mean=0.0, prior_chol=None,
                 prior_scale=None, max_shrink=64, batched=False):
        if (prior_chol is None) == (prior_scale is None):
            raise ValueError("pass exactly one of prior_chol= or prior_scale=")
        self._loglike = per_chain(loglike_fn, batched)
        self._batched = batched
        self._mean = prior_mean
        self._chol = prior_chol
        self._scale = prior_scale
        self.max_shrink = int(max_shrink)
        self.counters = {"iterations": 0, "syncs": 0}
        self._held = {}

    def _resolve(self, spec, others, x):
        if callable(spec):
            return per_chain(spec, self._batched)(others)
        return constant(self._held, spec, x)

    def draw_noise(self, gen, x, others):
        c = x.shape[0]

        def shrink_uniforms(j):
            return uniform(gen, c, x.dtype, x.device)

        return (normal(gen, tuple(x.shape), x.dtype, x.device),
                torch.clamp(uniform(gen, c, x.dtype, x.device), min=U_FLOOR),
                uniform(gen, c, x.dtype, x.device) * TWO_PI,
                shrink_uniforms)

    def apply(self, noise, x, others):
        z, u, theta, shrink_uniforms = noise
        mu = torch.broadcast_to(self._resolve(self._mean, others, x), x.shape)
        if self._chol is not None:
            chol = self._resolve(self._chol, others, x)
            nu = z @ chol.T if chol.ndim == 2 else matvec(chol, z)
        else:
            nu = self._resolve(self._scale, others, x) * z
        log_y = self._loglike(x, others) + torch.log(u)
        centered = x - mu

        def propose(th):
            return (centered * torch.cos(th)[:, None]
                    + nu * torch.sin(th)[:, None] + mu)

        return shrink_loop(propose, lambda v: self._loglike(v, others), log_y,
                           theta, shrink_uniforms, self.max_shrink, x,
                           self.counters)


class CategoricalGibbsKernel:
    """Exact Gibbs update for a block of DISCRETE sites, conditionally
    independent given the other blocks (mixture assignments):
    ``logits_fn(others) -> (S, V)`` unnormalized log-probabilities of each
    of the S sites over V categories, resampled in one draw,
    argmax(logits + Gumbel). Values are stored as floats in {0, …, V−1}.
    Noise: ``gumbel(shape)``, a function drawing standard Gumbel noise of
    the logits' shape (C, S, V)."""

    def __init__(self, logits_fn, batched=False):
        self._logits = per_chain(logits_fn, batched)

    def draw_noise(self, gen, x, others):
        def gumbel(shape):
            return -torch.log(exponential(gen, tuple(shape), x.dtype,
                                          x.device))

        return gumbel

    def apply(self, noise, x, others):
        logits = self._logits(others)
        if logits.ndim == x.ndim:  # one (S, V) table for every chain
            logits = logits.expand((x.shape[0],) + tuple(logits.shape[-2:]))
        draws = torch.argmax(noise(logits.shape) + logits, dim=-1)
        return draws.to(x.dtype)


class ExactGibbsKernel:
    """A block whose full conditional is sampled EXACTLY (conjugate
    updates): ``sample_fn(gen, others) -> new block (size,)``, where the
    JAX package's ``sample_fn`` takes a key. Per-chain calls are vmapped
    with ``randomness="different"`` (each chain its own draws) unless
    ``batched=True`` (then ``others`` is the batch and the result (C,
    size)). Noise: the generator itself."""

    def __init__(self, sample_fn, batched=False):
        self._sample = sample_fn
        self._batched = batched

    def draw_noise(self, gen, x, others):
        return gen

    def apply(self, noise, x, others):
        if self._batched:
            return torch.as_tensor(self._sample(noise, others)).to(x.dtype)
        # mapped over x too, so a lone block (no others) still draws C rows
        draw = torch.func.vmap(lambda _x, o: self._sample(noise, o),
                               randomness="different")
        return draw(x, others).to(x.dtype)


class GaussianInterweaveKernel:
    """Joint (hyper, latent) update by ancillarity-sufficiency interweaving
    (ASIS, Yu & Meng 2011) for ``f = chol(h) @ e``, ``e ~ N(0, I)``. Declare
    as a JOINT block over (hyper, latent).

    loglike_fn(f), chol_fn(h) -> (N, N) lower Cholesky, hyper_logprior(h):
    per chain (or batched with ``batched=True``). make_hyper_kernel(logp_fn)
    -> a single-block kernel (HMC/MALA/RWM) built with the same ``batched``;
    its ``logp_fn(h, others)`` finds what it holds fixed in ``others``.

    One step = ESS on e | h, then h | e (ancillary), switch to f, then h | f
    (sufficient), switch back. Noise: (ESS noise, hyper noise, hyper noise).
    """

    def __init__(self, loglike_fn, chol_fn, hyper_logprior,
                 make_hyper_kernel, max_shrink=64, batched=False):
        self._like = loglike_fn
        self._chol = chol_fn
        self._prior = hyper_logprior
        self._mk = make_hyper_kernel
        self._chol_b = per_chain(chol_fn, batched)
        self.max_shrink = int(max_shrink)
        self._batched = batched

    def _ess(self, n):
        return EllipticalSliceKernel(
            lambda e_, o: self._like(matvec(o["chol"], e_)),
            prior_scale=1.0, max_shrink=self.max_shrink,
            batched=self._batched)

    def draw_noise(self, gen, values, others):
        h, e = values
        hyper = self._mk(None)
        return (self._ess(e.shape[-1]).draw_noise(gen, e, {}),
                hyper.draw_noise(gen, h, {}), hyper.draw_noise(gen, h, {}))

    def apply(self, noise, values, others):
        h, e = values
        n_ess, n_anc, n_suf = noise
        # phase 0: ESS on the whitened latent given h
        e = self._ess(e.shape[-1]).apply(n_ess, e,
                                         {"chol": self._chol_b(h)})
        # phase 1 (ancillary): h | e, likelihood-coupled
        h = self._mk(lambda h_, o: self._prior(h_) + self._like(
            matvec(self._chol(h_), o["e"]))).apply(n_anc, h, {"e": e})
        # phase 2 (sufficient): h | f, prior-coupled
        f = matvec(self._chol_b(h), e)

        def c_logp(h_, o):
            chol = self._chol(h_)
            w = tri_solve(chol, o["f"])
            return (self._prior(h_) - 0.5 * torch.sum(w * w, dim=-1)
                    - torch.sum(torch.log(torch.diagonal(
                        chol, dim1=-2, dim2=-1)), dim=-1))

        h = self._mk(c_logp).apply(n_suf, h, {"f": f})
        # exact coordinate switch back: f is held fixed through phase 2
        return h, tri_solve(self._chol_b(h), f)


class InterweaveKernel:
    """General ASIS for a smooth hyper-indexed coupling ``f = T_h(e)``:
    forward(h, e) -> f, inverse(h, f) -> e, anc_logpdf(e), loglike(f),
    hyper_logprior(h) (per chain, or batched with ``batched=True``);
    make_hyper_kernel(logp_fn) (built twice a step) and
    make_latent_kernel(logp_fn) (default ``RWMKernel(logp,
    latent_rwm_scale)``) take ``logp_fn(x, others)``.
    log_det_inverse(h, f) -> log|det ∂e/∂f|; if None it is
    ``torch.func.jacfwd`` + ``slogdet`` of the per-chain inverse, so it
    needs ``batched=False``.

    One step = e | h (ancillary coordinates), h | e, switch to f = T_h(e),
    h | f, switch back. Noise: (latent noise, hyper noise, hyper noise).
    """

    def __init__(self, forward, inverse, anc_logpdf, loglike,
                 hyper_logprior, make_hyper_kernel, make_latent_kernel=None,
                 log_det_inverse=None, latent_rwm_scale=0.5, batched=False):
        self._fwd = forward
        self._inv = inverse
        self._anc = anc_logpdf
        self._like = loglike
        self._prior = hyper_logprior
        self._mk_h = make_hyper_kernel
        self._mk_e = make_latent_kernel or (
            lambda logp: RWMKernel(logp, latent_rwm_scale, batched=batched))
        if log_det_inverse is None:
            if batched:
                raise ValueError("the jacfwd fallback of log_det_inverse "
                                 "needs per-chain functions (batched=False)")

            def log_det_inverse(h, f):
                jac = torch.func.jacfwd(lambda f_: self._inv(h, f_))(f)
                return torch.linalg.slogdet(torch.atleast_2d(jac))[1]

        self._ldet = log_det_inverse
        self._fwd_b = per_chain(forward, batched)
        self._inv_b = per_chain(inverse, batched)

    def draw_noise(self, gen, values, others):
        h, e = values
        hyper = self._mk_h(None)
        return (self._mk_e(None).draw_noise(gen, e, {}),
                hyper.draw_noise(gen, h, {}), hyper.draw_noise(gen, h, {}))

    def apply(self, noise, values, others):
        h, e = values
        n_lat, n_anc, n_suf = noise
        # phase 0: e | h in the ancillary coordinates
        e = self._mk_e(lambda e_, o: self._anc(e_) + self._like(
            self._fwd(o["h"], e_))).apply(n_lat, e, {"h": h})
        # phase 1 (ancillary): h | e, likelihood-coupled
        h = self._mk_h(lambda h_, o: self._prior(h_) + self._like(
            self._fwd(h_, o["e"]))).apply(n_anc, h, {"e": e})
        # phase 2 (sufficient): h | f, prior-coupled
        f = self._fwd_b(h, e)
        h = self._mk_h(lambda h_, o: (
            self._prior(h_) + self._anc(self._inv(h_, o["f"]))
            + self._ldet(h_, o["f"]))).apply(n_suf, h, {"f": f})
        # exact coordinate switch back: f held fixed through phase 2
        return h, self._inv_b(h, f)


def _kernel_step(kernel, gen, x, others, noise=None):
    """One kernel update, on ``noise`` if given (a replay)."""
    if noise is None and not hasattr(kernel, "apply"):
        return kernel.step(gen, x, others)
    if noise is None:
        noise = kernel.draw_noise(gen, x, others)
    return kernel.apply(noise, x, others)


class BlockedGibbsSampler:
    """Sequential per-block kernel sweep, C chains in lockstep.

    blocks: list of ``(name, size, kernel)``; the sweep order is the list's.
        A JOINT entry ``((n1, n2), (s1, s2), kernel)`` updates several
        blocks in one kernel step (``kernel.apply(noise, (v1, v2), others)
        -> (v1', v2')``), as the interweaving kernels do.
    logp_fn (optional): joint log density over the values dict (per chain,
        or batched with ``batched=True``), stored as the chain's logp
        column (zeros if omitted).
    Storage is flat ``(C, Σ size)`` rows in block declaration order;
    ``get_block(name)`` slices a block back out. ``device`` defaults to
    "cuda".
    """

    def __init__(self, blocks, n_chains, logp_fn=None, seed=0,
                 dtype=torch.float32, max_chain_bytes=2 << 30, chain=None,
                 batched=False, device="cuda"):
        if not blocks:
            raise ValueError("need at least one block")
        self.device = resolve_device(device)
        self.blocks = []
        for n, s, k in blocks:
            if isinstance(n, tuple):
                if not (isinstance(s, tuple) and len(s) == len(n)):
                    raise ValueError(
                        f"joint block {n}: sizes must be a matching tuple")
                self.blocks.append((tuple(n), tuple(int(x) for x in s), k))
            else:
                self.blocks.append((n, int(s), k))
        names = [x for n, _, _ in self.blocks
                 for x in (n if isinstance(n, tuple) else (n,))]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate block names in {names}")
        # flat (name, size) layout for storage and state, declaration order
        self._layout = []
        for n, s, _ in self.blocks:
            self._layout.extend(zip(n, s) if isinstance(n, tuple)
                                else [(n, s)])
        self.n_chains = int(n_chains)
        self.n_params = sum(s for _, s in self._layout)
        self.dtype = dtype
        self._logp = None
        if logp_fn is not None:
            self._logp = (
                (lambda flat: logp_fn(self._unflatten(flat))) if batched
                else torch.func.vmap(
                    lambda row: logp_fn(self._unflatten(row))))
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self.state = None  # dict name -> (C, size)
        self.chain = check_chain(chain, self.n_chains, self.n_params,
                                 max_chain_bytes, dtype)

    # -- state plumbing ------------------------------------------------------

    def init(self, values):
        """``values``: {name: (size,) or (C, size)} initial positions."""
        state = {}
        for name, size in self._layout:
            if name not in values:
                raise ValueError(f"missing init for block {name!r}")
            v = as_tensor(values[name], self.dtype, self.device)
            if v.ndim == 1:
                v = v[None, :].expand(self.n_chains, size)
            if tuple(v.shape) != (self.n_chains, size):
                raise ValueError(f"block {name!r}: init shape "
                                 f"{tuple(v.shape)} != ({self.n_chains}, "
                                 f"{size})")
            state[name] = v.contiguous()
        self.state = state
        return self

    def sweep(self, state, noises=None):
        """One sweep over the blocks in order; ``noises`` (one per block,
        each as its kernel's ``draw_noise`` gives it) replays given draws.
        Returns the new state dict."""
        values = dict(state)
        for i, (name, _, kernel) in enumerate(self.blocks):
            noise = None if noises is None else noises[i]
            if isinstance(name, tuple):
                others = {n: v for n, v in values.items() if n not in name}
                new = _kernel_step(kernel, self._step_gen,
                                   tuple(values[n] for n in name), others,
                                   noise)
                values.update(zip(name, new))
            else:
                others = {n: v for n, v in values.items() if n != name}
                values[name] = _kernel_step(kernel, self._step_gen,
                                            values[name], others, noise)
        return values

    def _flat(self, state):
        return torch.cat([state[n] for n, _ in self._layout], dim=1)

    def _unflatten(self, row):
        out, i = {}, 0
        for name, size in self._layout:
            out[name] = row[..., i:i + size]
            i += size
        return out

    # -- driver --------------------------------------------------------------

    def _run_chunk(self, take, thin):
        pos = torch.empty((take, self.n_chains, self.n_params),
                          dtype=self.dtype, device=self.device)
        lps = torch.zeros((take, self.n_chains), dtype=self.dtype,
                          device=self.device)
        state = self.state
        for s in range(take):
            for _ in range(thin):
                state = self.sweep(state)
            pos[s] = self._flat(state)
            if self._logp is not None:
                lps[s] = self._logp(pos[s])
        self.state = state
        return pos, lps

    def run(self, n_steps, thin=1):
        """Advance ``n_steps`` sweeps, storing every thin-th flattened
        state. Returns False on chain byte-cap (EndOfChain)."""
        if self.state is None:
            raise RuntimeError("call init first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        chunk = default_chunk_steps(self.n_chains, self.n_params,
                                    row_dtype(self.dtype))
        ok = run_pipelined(n_store, chunk,
                           lambda take: self._run_chunk(take, thin),
                           lambda rows: self.chain.append(*rows))
        if ok and leftover:
            state = self.state
            for _ in range(leftover):
                state = self.sweep(state)
            self.state = state
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_block(self, name, burn_in=0, thin=1, flat=False):
        """Samples for one named block, sliced from the flat store."""
        i = 0
        for n, size in self._layout:
            if n == name:
                s = self.get_samples(burn_in=burn_in, thin=thin, flat=flat)
                return s[..., i:i + size]
            i += size
        raise KeyError(name)
