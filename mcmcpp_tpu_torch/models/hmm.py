"""Hidden Markov models with finite state spaces: forward filtering,
forward-backward smoothing, exact posterior path sampling (discrete FFBS),
Viterbi decoding and a blocked-Gibbs kernel for state sequences.

PyTorch counterpart of ``mcmcpp_tpu/models/hmm.py``. The user supplies the
emission table ``log_obs[t, k] = log p(y_t | z_t = k)``, the (K,) initial
log-distribution ``log_pi`` and the (K, K) row-stochastic transition
log-matrix ``log_gamma`` (rows: from-state). Everything runs in log space.

``method="sequential"`` is a Python loop over T of a few batched ops a step
(no host sync); ``"parallel"`` is one associative scan over (K, K)
log-matmul-exp elements (:func:`mcmcpp_tpu_torch.ops.scan.
associative_scan`). Its combine materialises (…, K, K, K) before the
reduction, batched over the whole level as JAX's is: at T = 2^16 and K = 8
the first level holds 2^15 · 8³ float32, 67 MB (134 MB for the whole T).

The internals take leading batch axes (one filter per Gibbs chain at once);
the public functions keep the JAX package's shapes. Categorical draws are
argmax(logits + Gumbel), as ``jax.random.categorical`` is, so a test can
hand the port JAX's Gumbel noise.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.ops.random import gumbel as gumbel_draws
from mcmcpp_tpu_torch.ops.scan import associative_scan

__all__ = ["HMMForward", "HMMKernel", "gaussian_emission_logpdf",
           "hmm_forecast", "hmm_forward", "hmm_loglik",
           "hmm_sample_posterior", "hmm_smoother", "transition_counts",
           "viterbi"]


class HMMForward(NamedTuple):
    log_alpha: torch.Tensor  # (T, K) NORMALIZED filtered log p(z_t | y_1:t)
    loglik: torch.Tensor     # () log p(y_{1:T})


def _validate(log_pi, log_gamma, log_obs):
    log_obs = torch.as_tensor(log_obs)
    log_pi = torch.as_tensor(log_pi, dtype=log_obs.dtype,
                             device=log_obs.device)
    log_gamma = torch.as_tensor(log_gamma, dtype=log_obs.dtype,
                                device=log_obs.device)
    k = log_pi.shape[0]
    if tuple(log_gamma.shape) != (k, k):
        raise ValueError(f"log_gamma must be ({k}, {k}), got "
                         f"{tuple(log_gamma.shape)}")
    if log_obs.ndim != 2 or log_obs.shape[1] != k:
        raise ValueError(f"log_obs must be (T, {k}), got "
                         f"{tuple(log_obs.shape)}")
    return log_pi, log_gamma, log_obs


def _lse(x, dim, keepdim=False):
    return torch.logsumexp(x, dim, keepdim=keepdim)


def _seq_forward(log_pi, log_gamma, log_obs):
    """Batched over leading axes: log_obs (…, T, K)."""
    a = log_pi + log_obs[..., 0, :]
    c0 = _lse(a, -1, True)
    a = a - c0
    alphas, cs = [a], []
    for t in range(1, log_obs.shape[-2]):
        nxt = _lse(a[..., :, None] + log_gamma, -2) + log_obs[..., t, :]
        c = _lse(nxt, -1, True)
        a = nxt - c
        alphas.append(a)
        cs.append(c)
    loglik = c0[..., 0]
    if cs:
        loglik = loglik + torch.sum(torch.cat(cs, -1), -1)
    return HMMForward(torch.stack(alphas, -2), loglik)


def _logmatmulexp(a, b):
    """(…, K, K) log-space matrix product (the associative combine)."""
    return _lse(a[..., :, :, None] + b[..., None, :, :], -2)


def _par_forward(log_pi, log_gamma, log_obs):
    # element t is the (K, K) map M_t(i, j) = Gamma(i, j) + obs_t(j); the
    # initial row folds into element 0 as a rank-1 map, so one scan yields
    # every prefix
    k = log_obs.shape[-1]
    lo = log_obs.movedim(-2, 0)                             # (T, …, K)
    elems = log_gamma + lo[1:, ..., None, :]                # (T-1, …, K, K)
    first = (log_pi + lo[0])[..., None, :].expand(
        tuple(lo.shape[1:-1]) + (k, k))[None]
    pref = associative_scan(_logmatmulexp, torch.cat([first, elems], 0))
    log_alpha_un = pref[..., 0, :].movedim(0, -2)           # (…, T, K)
    norm = _lse(log_alpha_un, -1, True)
    return HMMForward(log_alpha_un - norm, norm[..., -1, 0])


def _forward(log_pi, log_gamma, log_obs, method):
    if method == "parallel":
        return _par_forward(log_pi, log_gamma, log_obs)
    if method == "sequential":
        return _seq_forward(log_pi, log_gamma, log_obs)
    raise ValueError(f"method must be 'parallel'|'sequential', got {method!r}")


def hmm_forward(log_pi, log_gamma, log_obs, method="sequential"):
    """Filtered state posteriors and log p(y_{1:T})."""
    return _forward(*_validate(log_pi, log_gamma, log_obs), method)


def hmm_loglik(log_pi, log_gamma, log_obs, method="sequential"):
    """Marginal log-likelihood with the states summed out; differentiable by
    autograd."""
    return hmm_forward(log_pi, log_gamma, log_obs, method=method).loglik


def hmm_smoother(log_pi, log_gamma, log_obs, method="sequential"):
    """Forward-backward: ``(log_marginals (T, K), loglik)``."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    fwd = _forward(log_pi, log_gamma, log_obs, method)
    b = torch.zeros_like(log_pi)
    betas = [b]
    for t in range(log_obs.shape[0] - 1, 0, -1):
        nxt = _lse(log_gamma + (log_obs[t] + b)[None, :], 1)
        b = nxt - _lse(nxt, 0)
        betas.append(b)
    post = fwd.log_alpha + torch.stack(betas[::-1])
    return post - _lse(post, 1, True), fwd.loglik


def _backward_sample(log_alpha, log_gamma, n, gumbel):
    """Discrete FFBS draws from filtered ``log_alpha`` (…, T, K): (…, n, T)
    int64 paths; ``gumbel(i)`` gives the (…, n, K) noise of z_i's draw,
    called for i = T−1, then T−2 … 0."""
    t_n, k = log_alpha.shape[-2:]
    z = torch.argmax(gumbel(t_n - 1) + log_alpha[..., -1, None, :], -1)
    lead = tuple(z.shape[:-1])
    lg_t = log_gamma.mT.expand(lead + (k, k))
    zs = [z]
    for t in range(t_n - 2, -1, -1):
        # p(z_t | z_{t+1}, y_1:t) ∝ alpha_t(i) Gamma(i, z_{t+1})
        logits = log_alpha[..., t, None, :] + torch.gather(
            lg_t, -2, z[..., None].expand(lead + (z.shape[-1], k)))
        z = torch.argmax(gumbel(t) + logits, -1)
        zs.append(z)
    return torch.stack(zs[::-1], -1)


def hmm_sample_posterior(gen, log_pi, log_gamma, log_obs, n_paths=None,
                         method="sequential", gumbel=None):
    """EXACT joint draw(s) z_{1:T} ~ p(z | y): (T,) int32, or (n_paths, T).

    ``gumbel``: optional ``gumbel(i) -> (n, K)`` standard Gumbel noise of
    z_i's categorical draw (argmax(logits + Gumbel)), asked for i = T−1
    first, then T−2 … 0 (JAX's ``categorical(k_last, …)``, then its
    ``split(k_scan, T−1)[i]`` draws); drawn from ``gen`` when None."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    fwd = _forward(log_pi, log_gamma, log_obs, method)
    squeeze = n_paths is None
    n = 1 if squeeze else int(n_paths)
    if gumbel is None:
        shape = (n, log_pi.shape[0])
        gumbel = lambda i: gumbel_draws(gen, shape, log_obs.dtype,  # noqa: E731
                                        log_obs.device)
    path = _backward_sample(fwd.log_alpha, log_gamma, n, gumbel).to(
        torch.int32)
    return path[0] if squeeze else path


def viterbi(log_pi, log_gamma, log_obs):
    """MAP state path: ``(path (T,) int32, log p(path, y))``."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    d = log_pi + log_obs[0]
    ptrs = []
    for t in range(1, log_obs.shape[0]):
        scores = d[:, None] + log_gamma          # (K from, K to)
        best, arg = torch.max(scores, 0)
        d = best + log_obs[t]
        ptrs.append(arg)
    z = torch.argmax(d)
    zs = [z]
    for p in reversed(ptrs):
        z = p[z]
        zs.append(z)
    return torch.stack(zs[::-1]).to(torch.int32), torch.max(d)


def transition_counts(path, n_states):
    """(K, K) int32 transition counts of an int path (the sufficient
    statistic of conjugate Dirichlet transition rows)."""
    path = torch.as_tensor(path).long()
    idx = path[:-1] * n_states + path[1:]
    flat = torch.zeros(n_states * n_states, dtype=torch.int64,
                       device=path.device)
    flat.index_add_(0, idx, torch.ones_like(idx))
    return flat.reshape(n_states, n_states).to(torch.int32)


class HMMKernel:
    """Blocked-Gibbs kernel drawing a state sequence EXACTLY from its full
    conditional by discrete FFBS; states are stored as floats.

        BlockedGibbsSampler([
            ("z", T, HMMKernel(log_obs_fn, log_pi, log_gamma_fn)),
            ("mu", K, <any kernel>),    # emissions see z via `others`
        ], n_chains, device=...)

    log_obs_fn: (T, K), or a per-chain callable ``others -> (T, K)``;
    log_gamma_fn: (K, K) or a per-chain callable ``others -> (K, K)``
    (vmapped over the chains). All chains' filters run as one batch. Noise:
    ``gumbel(i) -> (C, 1, K)``, z_i's Gumbel draws (see
    :func:`hmm_sample_posterior`)."""

    def __init__(self, log_obs_fn, log_pi, log_gamma_fn,
                 method="sequential"):
        self._obs = log_obs_fn
        self.log_pi = torch.as_tensor(np.asarray(log_pi) if not isinstance(
            log_pi, torch.Tensor) else log_pi)
        self._gamma = log_gamma_fn
        self.method = method
        self._held = {}

    def draw_noise(self, gen, x, others):
        shape = (x.shape[0], 1, self.log_pi.shape[0])
        return lambda i: gumbel_draws(gen, shape, x.dtype, x.device)

    def _table(self, spec, others, x):
        # imported here: the models package loads before gibbs can
        from mcmcpp_tpu_torch.gibbs import per_chain

        if callable(spec):
            return per_chain(spec, False)(others).to(x.dtype)
        return torch.as_tensor(spec, dtype=x.dtype, device=x.device)

    def apply(self, noise, x, others):
        lo = self._table(self._obs, others, x)
        lg = self._table(self._gamma, others, x)
        key = (x.device, x.dtype)
        if key not in self._held:  # copied once: a copy waits for the device
            self._held[key] = self.log_pi.to(x.device, x.dtype)
        lp = self._held[key]
        if lo.ndim == 2:          # one table for every chain
            lo = lo.expand((x.shape[0],) + tuple(lo.shape))
        fwd = _forward(lp, lg, lo, self.method)
        path = _backward_sample(fwd.log_alpha, lg, 1, noise)
        return path[:, 0, :].to(x.dtype)


def hmm_forecast(log_pi, log_gamma, log_obs, horizon=1,
                 method="sequential"):
    """(h, K) log p(z_{T+k} | y_{1:T}) for k = 1..h."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    a = _forward(log_pi, log_gamma, log_obs, method).log_alpha[-1]
    preds = []
    for _ in range(int(horizon)):
        nxt = _lse(a[:, None] + log_gamma, 0)
        a = nxt - _lse(nxt, 0)
        preds.append(a)
    return torch.stack(preds)


def gaussian_emission_logpdf(ys, means, sigmas):
    """(T, K) table for scalar-Gaussian emissions: ``ys`` (T,),
    ``means``/``sigmas`` (K,)."""
    ys = torch.as_tensor(ys)[:, None]
    means = torch.as_tensor(means, dtype=ys.dtype, device=ys.device)[None, :]
    sigmas = torch.as_tensor(sigmas, dtype=ys.dtype,
                             device=ys.device)[None, :]
    z = (ys - means) / sigmas
    return -0.5 * z * z - torch.log(sigmas) - 0.5 * np.log(2.0 * np.pi)
