"""Nested sampling: evidence and posterior from a batched live-point set.

PyTorch counterpart of ``mcmcpp_tpu/nested.py``. The live set is one (N, P)
device tensor; each iteration sorts it (``torch.argsort(stable=True)``, as
``jnp.argsort`` is stable), removes the B worst points and regrows B
replacements above the killed likelihood L* as one batch of constrained
chains, with one of two kernels:

- ``"stretch"``: ``n_mcmc`` affine-invariant stretch steps against the
  survivors;
- ``"slice"``: ``n_mcmc`` random-direction slice steps in live-set-whitened
  coordinates (fixed-width stepping-out capped by ``max_slice_expand``,
  split at random between the two ends, then shrinking capped by
  ``max_slice_shrink``). The JAX package vmaps two ``while_loop``s over the
  walkers; here they are masked lock-step loops over the batch, a finished
  walker held as it is, with the host testing "every walker done" every
  ``CHECK_EVERY`` iterations (the held walkers give the same bits as a test
  every iteration).

The evidence ledger runs on the host in float64, as in the JAX package:
log-space shell widths with the batched-deaths shrinkage of dynamic nested
sampling, the live set's remaining evidence for termination. One iteration
reads the device once (the dead rows, their log-likelihoods, the count of
accepts or evaluations and the live set's best log-likelihood, in one copy),
plus the slice kernel's loop tests.

An iteration is ``draw_noise()`` (every random draw, the slice kernel's for
every possible loop iteration too) and ``iterate(live, ll, lpp, noise)``,
so a test can hand the port the JAX package's draws. ``run()`` again
continues a run; ``reset()`` starts over. ``mesh=`` is not ported.
"""

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.ops.random import (
    AUX_STREAM,
    STEP_STREAM,
    make_generator,
)
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["NestedResult", "NestedSampler"]

#: slice-loop iterations between host tests of "every walker done"
CHECK_EVERY = 4


class NestedResult(NamedTuple):
    logz: float  # log evidence
    logz_err: float  # sqrt(H / N)
    h: float  # information (nats)
    n_iters: int  # outer batches executed
    n_calls: int  # total likelihood evaluations
    samples: np.ndarray  # (D, P) dead points, worst-first, then the live set
    logl: np.ndarray  # (D,) their log-likelihoods
    logw: np.ndarray  # (D,) normalized posterior log-weights
    ess: float  # Kish effective sample size of the weights


class StretchNoise(NamedTuple):
    """``seed_idx`` (B,) survivors to regrow from; per step (leading axis
    n_mcmc): ``u`` (B,) the stretch uniforms, ``c_idx`` (B,) partners,
    ``log_u`` (B,) = −Exp(1)."""

    seed_idx: torch.Tensor
    u: torch.Tensor
    c_idx: torch.Tensor
    log_u: torch.Tensor


class SliceNoise(NamedTuple):
    """``seed_idx`` (B,); per direction step (leading axis n_mcmc):
    ``z`` (B, P) the direction's normals, ``e`` (B,) the slice height's
    Exp(1), ``u0`` (B,) the interval's offset, ``j_lo`` (B,) int64 the
    expansions given to the lower end, ``shrink_u`` (max_slice_shrink, B)
    the shrinking uniforms of every possible iteration."""

    seed_idx: torch.Tensor
    z: torch.Tensor
    e: torch.Tensor
    u0: torch.Tensor
    j_lo: torch.Tensor
    shrink_u: torch.Tensor


def _shrink(n_live, batch):
    """The cumulative −Δlog X of each death in a batch: Σ_{j<=k} 1/(N−j)."""
    return np.cumsum(1.0 / (n_live - np.arange(batch)))


def _logsumexp(x):
    x = np.asarray(x, np.float64)
    m = np.max(x) if x.size else -np.inf
    if not np.isfinite(m):
        return m
    return m + np.log(np.sum(np.exp(x - m)))


def _cov(x):
    """``jnp.cov(x, rowvar=False)``: (P, P), ddof 1."""
    xc = x - x.mean(0)
    return xc.T @ xc / (x.shape[0] - 1)


class NestedSampler:
    """Static-live-set nested sampling with batched deaths (≙
    ``mcmcpp_tpu/nested.py::NestedSampler``).

    logprior_fn, loglike_fn : (P,) -> scalar, or with ``batched=True``
        (n, P) -> (n,) (log L = −inf allowed).
    prior_sample : (gen, n) -> (n, P) exact prior draws, ``gen`` a
        generator on the sampler's device.
    device : default "cuda" (CUDA without a GPU raises).
    """

    def __init__(self, logprior_fn, loglike_fn, prior_sample, n_params,
                 n_live=500, batch=None, n_mcmc=30, a=2.0, seed=0,
                 dtype=torch.float32, kernel="stretch", max_slice_expand=8,
                 max_slice_shrink=32, batched=False, device="cuda"):
        if kernel not in ("stretch", "slice"):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.device = resolve_device(device)
        self.kernel = kernel
        self.max_slice_expand = int(max_slice_expand)
        self.max_slice_shrink = int(max_slice_shrink)
        self.n_params = int(n_params)
        self.n_live = int(n_live)
        self.batch = (int(batch) if batch is not None
                      else max(1, self.n_live // 4))
        if not 0 < self.batch < self.n_live:
            raise ValueError(
                f"batch={self.batch} must be in (0, n_live={self.n_live})")
        self.n_mcmc = int(n_mcmc)
        self.a = float(a)
        self.dtype = dtype
        self._prior_sample = prior_sample
        self._logprior = logprior_fn if batched else torch.func.vmap(
            logprior_fn)
        self._loglike = loglike_fn if batched else torch.func.vmap(loglike_fn)
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self.result = None
        self.host_syncs = 0
        self.reset()

    def reset(self):
        """Discard mid-run state so the next :meth:`run` starts fresh."""
        self._live = self._ll = self._lpp = None
        self._dead_pos, self._dead_ll, self._dead_logw = [], [], []
        self._logz, self._logx = -np.inf, 0.0
        self._n_calls = 0
        self._iters_done = 0
        self._low_acc_warned = False
        self.result = None
        return self

    # -- device kernels ------------------------------------------------------

    def draw_noise(self):
        """Every random draw of one iteration, in a fixed order."""
        g, dev, dt = self._step_gen, self.device, self.dtype
        b, m, k = self.batch, self.n_mcmc, self.n_live - self.batch
        seed_idx = torch.randint(0, k, (b,), generator=g, device=dev)
        if self.kernel == "stretch":
            return StretchNoise(
                seed_idx,
                torch.rand((m, b), generator=g, dtype=dt, device=dev),
                torch.randint(0, k, (m, b), generator=g, device=dev),
                -torch.empty((m, b), dtype=dt, device=dev).exponential_(
                    generator=g))
        return SliceNoise(
            seed_idx,
            torch.randn((m, b, self.n_params), generator=g, dtype=dt,
                        device=dev),
            torch.empty((m, b), dtype=dt, device=dev).exponential_(
                generator=g),
            torch.rand((m, b), generator=g, dtype=dt, device=dev),
            torch.randint(0, self.max_slice_expand + 1, (m, b), generator=g,
                          device=dev),
            torch.rand((m, self.max_slice_shrink, b), generator=g, dtype=dt,
                       device=dev))

    def _any(self, mask):
        self.host_syncs += 1
        return bool(mask.any())

    def _slice_direction(self, x, x_ll, x_lpp, chol, lstar, noise, j):
        """One slice direction step for every walker (lock-step over the
        batch); returns (x, ll, lpp, evaluations (B,) int64)."""
        z = noise.z[j]
        d = (z / torch.linalg.vector_norm(z, dim=1, keepdim=True)) @ chol.T
        log_y = x_lpp - noise.e[j]
        b = x.shape[0]
        dt, dev = x.dtype, x.device

        def g(t):
            # t (k, B): the constrained prior at x + t·d, row by row
            p = x + t[..., None] * d
            flat = p.reshape(-1, self.n_params)
            val = torch.where(self._loglike(flat) > lstar,
                              self._logprior(flat), -torch.inf)
            return val.reshape(t.shape), p

        # stepping-out at both ends at once: row 0 the lower end (delta −1,
        # cap j_lo), row 1 the upper (delta +1, cap m − j_lo)
        u0 = noise.u0[j]
        t = torch.stack([-u0, 1.0 - u0])
        cap = torch.stack([noise.j_lo[j], self.max_slice_expand
                           - noise.j_lo[j]])
        delta = torch.tensor([[-1.0], [1.0]], dtype=dt, device=dev)
        val, _ = g(t)
        open_ = val > log_y
        it = torch.zeros((2, b), dtype=torch.int64, device=dev)
        for i in range(self.max_slice_expand):
            if i % CHECK_EVERY == 0 and not self._any(open_ & (it < cap)):
                break
            active = open_ & (it < cap)
            t2 = t + delta
            val2, _ = g(t2)
            t = torch.where(active, t2, t)
            it = it + active.to(torch.int64)
            open_ = torch.where(active, val2 > log_y, open_)
        lo, hi = t[0], t[1]
        evals = it[0] + it[1] + 2  # + the two evaluations at t0

        # shrinking
        n_sh = torch.zeros((b,), dtype=torch.int64, device=dev)
        val = torch.full((b,), -torch.inf, dtype=dt, device=dev)
        p = x
        for i in range(self.max_slice_shrink):
            going = val <= log_y
            if i % CHECK_EVERY == 0 and not self._any(going):
                break
            t2 = lo + noise.shrink_u[j, i] * (hi - lo)
            val2, p2 = g(t2[None, :])
            val2, p2 = val2[0], p2[0]
            miss = going & (val2 <= log_y)
            lo = torch.where(miss & (t2 < 0), t2, lo)
            hi = torch.where(miss & (t2 >= 0), t2, hi)
            val = torch.where(going, val2, val)
            p = torch.where(going[:, None], p2, p)
            n_sh = n_sh + going.to(torch.int64)
        ok = val > log_y  # the shrink cap hit: keep x
        new_x = torch.where(ok[:, None], p, x)
        new_ll = torch.where(ok, self._loglike(new_x), x_ll)
        new_lpp = torch.where(ok, self._logprior(new_x), x_lpp)
        return new_x, new_ll, new_lpp, evals + n_sh + 1

    @torch.no_grad()
    def iterate(self, live, ll, lpp, noise):
        """One batch: sort, kill the B worst, regrow B chains above L*.
        Returns (live, ll, lpp, dead, dead_ll, acc): ``acc`` the accepted
        stretch moves, or the slice kernel's likelihood evaluations."""
        n, b = self.n_live, self.batch
        order = torch.argsort(ll, stable=True)
        live, ll, lpp = live[order], ll[order], lpp[order]
        dead, dead_ll = live[:b], ll[:b]
        surv, surv_ll, surv_lpp = live[b:], ll[b:], lpp[b:]
        lstar = ll[b - 1]
        pos, pos_ll = surv[noise.seed_idx], surv_ll[noise.seed_idx]
        pos_lpp = surv_lpp[noise.seed_idx]
        if self.kernel == "slice":
            chol = torch.linalg.cholesky(
                _cov(surv) + 1e-8 * torch.eye(self.n_params,
                                              dtype=surv.dtype,
                                              device=surv.device))
            acc = torch.zeros((b,), dtype=torch.int64, device=live.device)
            for j in range(self.n_mcmc):
                pos, pos_ll, pos_lpp, evals = self._slice_direction(
                    pos, pos_ll, pos_lpp, chol, lstar, noise, j)
                acc = acc + evals
            acc = acc.sum()
        else:
            acc = torch.zeros((), dtype=torch.int64, device=live.device)
            for i in range(self.n_mcmc):
                z = (noise.u[i] * (self.a - 1.0) + 1.0) ** 2 / self.a
                c = surv[noise.c_idx[i]]
                prop = c + z[:, None] * (pos - c)
                prop_lpp = self._logprior(prop)
                prop_ll = self._loglike(prop)
                log_ratio = ((self.n_params - 1) * torch.log(z)
                             + prop_lpp - pos_lpp)
                ok = (noise.log_u[i] < log_ratio) & (prop_ll > lstar)
                pos = torch.where(ok[:, None], prop, pos)
                pos_ll = torch.where(ok, prop_ll, pos_ll)
                pos_lpp = torch.where(ok, prop_lpp, pos_lpp)
                acc = acc + ok.sum()
        return (torch.cat([surv, pos]), torch.cat([surv_ll, pos_ll]),
                torch.cat([surv_lpp, pos_lpp]), dead, dead_ll, acc)

    # -- host ledger ---------------------------------------------------------

    def run(self, dlogz=0.01, max_iters=100_000, min_accept=0.05):
        """Iterate until the live set's remaining evidence falls below
        ``dlogz`` nats; returns (and stores) a :class:`NestedResult`. A
        second call continues the run (``max_iters`` bounds the further
        iterations), bit for bit as an uninterrupted one."""
        n, b, p = self.n_live, self.batch, self.n_params
        if self._live is None:
            live = torch.as_tensor(self._prior_sample(self._aux_gen, n)).to(
                self.device, self.dtype)
            if tuple(live.shape) != (n, p):
                raise ValueError(f"prior_sample returned {tuple(live.shape)},"
                                 f" expected {(n, p)}")
            with torch.no_grad():
                self._live, self._ll = live, self._loglike(live)
                self._lpp = self._logprior(live)
            self._n_calls = n

        live, ll, lpp = self._live, self._ll, self._lpp
        logx_steps = _shrink(n, b)
        logz, logx = self._logz, self._logx
        for _ in range(int(max_iters)):
            live, ll, lpp, dead, d_ll, acc = self.iterate(
                live, ll, lpp, self.draw_noise())
            # one device read: dead rows, their log L, acc and max log L
            # (float64 holds the float32 rows and the count exactly)
            host = torch.cat([dead.reshape(-1), d_ll, acc.reshape(1),
                              ll.max().reshape(1)]).to(
                                  torch.float64).cpu().numpy()
            self.host_syncs += 1
            dead_np = host[:b * p].reshape(b, p).astype(
                str(self.dtype).split(".")[-1])
            d_ll = host[b * p:b * p + b]
            acc, ll_max = int(host[-2]), float(host[-1])
            self._iters_done += 1
            self._n_calls += acc if self.kernel == "slice" else b * self.n_mcmc
            self._dead_pos.append(dead_np)
            self._dead_ll.append(d_ll)
            # shell weights in log space: log(X_{j-1} − X_j) =
            # log X_{j-1} + log(−expm1(Δlog X))
            logx_new = logx - logx_steps
            logx_prev = np.concatenate([[logx], logx_new[:-1]])
            log_width = logx_prev + np.log(-np.expm1(logx_new - logx_prev))
            logw = log_width + d_ll
            self._dead_logw.append(logw)
            logz = np.logaddexp(logz, _logsumexp(logw))
            logx = float(logx_new[-1])
            self._logz, self._logx = logz, logx
            acc_rate = (1.0 if self.kernel == "slice"
                        else acc / (b * self.n_mcmc))
            if acc_rate < min_accept and not self._low_acc_warned:
                warnings.warn(
                    f"constrained-walk acceptance {acc_rate:.3f} < "
                    f"{min_accept} at iteration {self._iters_done}; "
                    "replacements may correlate with seeds (raise n_mcmc "
                    "or n_live)", stacklevel=2)
                self._low_acc_warned = True
            remain = logx + ll_max
            if np.isfinite(logz) and (
                    np.logaddexp(logz, remain) - logz < dlogz):
                break
        self._live, self._ll, self._lpp = live, ll, lpp
        return self._finalize()

    def _finalize(self):
        """The result from the ledger and the surviving live set (which
        share the last volume); reads copies, so a continued run can
        finalize again."""
        n = self.n_live
        live_np = self._live.cpu().numpy()
        ll_np = self._ll.cpu().numpy().astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            logw_live = (self._logx - np.log(n)) + ll_np
        logz = np.logaddexp(self._logz, _logsumexp(logw_live))
        samples = np.concatenate(self._dead_pos + [live_np], 0)
        logl = np.concatenate(self._dead_ll + [ll_np], 0)
        logw = np.concatenate(self._dead_logw + [logw_live]) - logz
        finite = np.isfinite(logw) & np.isfinite(logl)
        h = float(np.sum(np.exp(logw[finite]) * logl[finite]) - logz)
        wsum = np.exp(_logsumexp(2.0 * logw))
        ess = 1.0 / wsum if wsum > 0 else 0.0
        self.result = NestedResult(
            logz=float(logz), logz_err=float(math.sqrt(max(h, 0.0) / n)),
            h=float(h), n_iters=self._iters_done,
            n_calls=int(self._n_calls), samples=samples, logl=logl,
            logw=logw, ess=float(ess))
        return self.result

    @property
    def log_evidence(self):
        if self.result is None:
            raise RuntimeError("call run() first")
        return self.result.logz

    def posterior_samples(self, n_draws=1000, seed=0):
        """Equal-weight posterior draws by categorical resampling of the
        dead points."""
        if self.result is None:
            raise RuntimeError("call run() first")
        rng = np.random.default_rng(seed)
        w = np.exp(self.result.logw - self.result.logw.max())
        w /= w.sum()
        idx = rng.choice(w.size, size=int(n_draws), p=w)
        return self.result.samples[idx]
