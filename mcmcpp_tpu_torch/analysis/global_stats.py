"""Global-ensemble diagnostics from per-process chain shards.

PyTorch counterpart of ``mcmcpp_tpu/analysis/global_stats.py``. The
reference's analysis always sees the WHOLE ensemble
(``MCMCpp/Analysis/AutoCorrCalc.h:151-221`` averages the normalized
autocovariance over all walkers before the Sokal window); under a
multi-process run (:class:`~mcmcpp_tpu_torch.parallel.ShardedEnsembleSampler`)
each process holds only its walker shard, so each global function reduces its
shard to small sufficient statistics (per-walker autocovariance partial sums,
moment sums, split-chain mean and variance sums, compressed per-parameter
ECDFs), combines them across processes and finishes with the same number on
every process. Every process must call each function collectively, with
same-shaped shards.

The combination is a ``torch.distributed`` collective of the default process
group when its world size is above 1: :func:`_sum_over_hosts` is an
all-reduce and :func:`_gather_hosts` an all-gather, in float64 on the
group's device (the card under NCCL, the CPU under gloo). In one process it
is the identity, and every function equals its local counterpart in
``analysis`` (same math, same window). The ``_reduce`` / ``_gather`` hooks
take a callable in their place, as in JAX, so that a test can emulate the
exchange of several shards in one process.

A tensor is reduced on its own device (the moments in float64, the
autocovariance FFT in float32, as ``autocorr_time`` takes it); numpy input
goes to ``device`` (default "cuda"; CUDA without a GPU raises), as the JAX
package puts it on its accelerator. Results are numpy (float64) or Python
floats.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.analysis.autocorr import (
    _norm_autocov_fft,
    _sokal_window_tau,
)
from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.sampler import resolve_device


def _sum_over_hosts(*partials):
    """Sum each partial statistic across processes (an all-reduce in
    float64 on the process group's device; the identity in one process)."""
    if distributed.is_multihost():
        dev = distributed.group_device()
        partials = [torch.as_tensor(p).to(device=dev, dtype=torch.float64)
                    for p in partials]
        for p in partials:
            torch.distributed.all_reduce(p)
    return partials if len(partials) > 1 else partials[0]


def _gather_hosts(*partials):
    """Stack each partial across processes, (n_hosts, ...) in rank order:
    ``process_allgather`` in float64 (a leading axis of 1 in one
    process)."""
    out = tuple(distributed.process_allgather(
        torch.as_tensor(p, dtype=torch.float64)) for p in partials)
    return out if len(out) > 1 else out[0]


def _tensor(x, device, dtype=torch.float64):
    return (x.to(device=device, dtype=dtype) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x), device=device).to(dtype))


def _collective(fn, device):
    """Wrap a reduce/gather callable so its outputs (numpy from a test's
    emulation, tensors from the identity) come back as float64 tensors on
    ``device``."""
    def call(*parts):
        out = fn(*parts)
        if len(parts) == 1:
            return _tensor(out, device)
        return tuple(_tensor(o, device) for o in out)
    return call


def _reducer(_reduce, device):
    return _collective(_reduce if _reduce is not None else _sum_over_hosts,
                       device)


def _gatherer(_gather, device):
    return _collective(_gather if _gather is not None else _gather_hosts,
                       device)


def _as_tensor(local_samples, device):
    """A tensor as it is; numpy on ``device`` (default "cuda")."""
    if isinstance(local_samples, torch.Tensor):
        return local_samples
    return torch.as_tensor(np.asarray(local_samples)).to(
        resolve_device("cuda" if device is None else device))


def _chain(local_samples, ndims=(2, 3), what="(S, W_local[, P])",
           device=None):
    """The shard as a tensor (numpy goes to ``device``), (S, W, P), and
    whether the input was 2-D."""
    x = _as_tensor(local_samples, device)
    if x.ndim not in ndims:
        raise ValueError(f"local_samples must be {what}")
    squeeze = x.ndim == 2
    return (x[:, :, None] if squeeze else x), squeeze


def _out(v, squeeze):
    v = np.asarray(v, np.float64)
    return float(v[0]) if squeeze else v


def _global_tau(arr, window_scaling, reduce_):
    """Whole-ensemble taus from a (S, W_local, P) shard: (taus (P,),
    w_total, s). One reduce."""
    s, w, p = arr.shape
    x = arr.to(torch.float32)
    # the walker sum of ρ per parameter, as autocorr_time accumulates it
    rho_partial = torch.stack([
        _norm_autocov_fft(x[:, :, i].T).double().sum(dim=0)
        for i in range(p)])  # (P, S)
    rho_sum, w_total = reduce_(
        rho_partial, torch.tensor(float(w), dtype=torch.float64))
    rho_mean = rho_sum.cpu().numpy() / float(w_total)
    taus = np.array([_sokal_window_tau(rho_mean[i], window_scaling)
                     for i in range(p)])
    return taus, float(w_total), s


def global_autocorr_time(local_samples, window_scaling=4.0, device=None,
                         _reduce=None):
    """Whole-ensemble integrated ACT from a walker shard (S, W_local[, P]):
    equal to ``analysis.autocorr_time`` on the full ensemble. Each process
    contributes Σ_{w∈local} ρ_w(t) (P, S) and its walker count; the Sokal
    window runs on the combined mean."""
    arr, squeeze = _chain(local_samples, device=device)
    taus, _, _ = _global_tau(arr, window_scaling,
                             _reducer(_reduce, arr.device))
    return _out(taus, squeeze)


def global_effective_sample_size(local_samples, window_scaling=4.0,
                                 device=None, _reduce=None):
    """Whole-ensemble ESS = S·W_global/τ (equal to
    ``analysis.effective_sample_size`` on the full ensemble); an unclosed
    window (τ ≤ 0) gives NaN."""
    arr, squeeze = _chain(local_samples, device=device)
    taus, w_total, s = _global_tau(arr, window_scaling,
                                   _reducer(_reduce, arr.device))
    n_total = s * w_total
    ess = np.where(taus > 0, n_total / np.maximum(taus, 1e-12), np.nan)
    return _out(ess, squeeze)


def _moments_raw(flat):
    """(n, Σx (P,), Σx² (P,)) over the rows of flat (float64)."""
    return (torch.tensor(float(flat.shape[0]), dtype=torch.float64),
            flat.sum(dim=0), (flat * flat).sum(dim=0))


def global_covariance_matrix(local_samples, device=None, _reduce=None):
    """Whole-ensemble covariance (ddof = 1) from a shard (S, W_local, P) or
    (N_local, P): float64 partials n, Σx (P,), Σxxᵀ (P, P)."""
    x = _as_tensor(local_samples, device)
    if x.ndim not in (2, 3):
        raise ValueError("local_samples must be (S, W_local, P) or (N, P)")
    flat = x.reshape(-1, x.shape[-1]).to(torch.float64)
    reduce_ = _reducer(_reduce, flat.device)
    n, sx, sxx = reduce_(
        torch.tensor(float(flat.shape[0]), dtype=torch.float64),
        flat.sum(dim=0), flat.T @ flat)
    mean = sx / n
    return ((sxx - torch.outer(mean, sx)) / (n - 1.0)).cpu().numpy()


def global_correlation_matrix(local_samples, device=None, _reduce=None):
    cov = global_covariance_matrix(local_samples, device, _reduce)
    d = np.sqrt(np.diag(cov))
    return cov / np.outer(d, d)


def _batches(arr, n_batches):
    s = arr.shape[0]
    b = s // int(n_batches)
    if b < 2:
        raise ValueError("chain too short for the requested n_batches")
    trimmed = arr[: b * n_batches].to(torch.float64)
    w, p = arr.shape[1], arr.shape[2]
    means = trimmed.reshape(n_batches, b, w, p).mean(dim=1)  # (nb, W, P)
    return b, trimmed, means


def global_batch_means_ess(local_samples, n_batches=32, device=None,
                           _reduce=None):
    """Whole-ensemble batch-means ESS (equal to ``analysis.batch_means_ess``
    on the full ensemble up to float64 summation order). Partials: walker
    count, Σ over walkers of each walker's batch-mean variance, and the
    pooled n, Σx, Σx²."""
    arr, squeeze = _chain(local_samples, device=device)
    w = arr.shape[1]
    b, trimmed, means = _batches(arr, n_batches)
    vm_partial = means.var(dim=0, correction=1).sum(dim=0)  # (P,)
    flat = trimmed.reshape(-1, arr.shape[2])
    reduce_ = _reducer(_reduce, arr.device)
    w_total, vm_sum, n, sx, sxx = reduce_(
        torch.tensor(float(w), dtype=torch.float64), vm_partial,
        *_moments_raw(flat))
    var_means = vm_sum / w_total
    var_x = (sxx - sx * sx / n) / (n - 1.0)
    ess = torch.minimum(n * var_x / (b * var_means), n)
    return _out(ess.cpu().numpy(), squeeze)


def global_multivariate_ess(local_samples, n_batches=32, device=None,
                            _reduce=None):
    """Whole-ensemble multivariate ESS (Vats, Flegal & Jones) (equal to
    ``analysis.multivariate_ess`` on the full ensemble): both covariances
    use per-walker centering, so each process's Λ and Σ partial sums are
    exact (P, P) sufficient statistics."""
    arr, _ = _chain(local_samples, device=device)
    w, p = arr.shape[1], arr.shape[2]
    b, trimmed, means = _batches(arr, n_batches)
    centered = trimmed - trimmed.mean(dim=0, keepdim=True)
    c2 = centered.reshape(-1, p)
    lam_partial = c2.T @ c2
    mc = (means - means.mean(dim=0, keepdim=True)).reshape(-1, p)
    sig_partial = mc.T @ mc
    reduce_ = _reducer(_reduce, arr.device)
    w_total, lam_sum, sig_sum = reduce_(
        torch.tensor(float(w), dtype=torch.float64), lam_partial,
        sig_partial)
    w_total = float(w_total)
    lam = lam_sum.cpu().numpy() / (w_total * (b * n_batches - 1.0))
    sig = b * sig_sum.cpu().numpy() / (w_total * (n_batches - 1.0))
    sign_l, logdet_l = np.linalg.slogdet(lam)
    sign_s, logdet_s = np.linalg.slogdet(sig)
    if sign_l <= 0 or sign_s <= 0:
        return float("nan")
    n_total = float(b * n_batches * w_total)
    return float(n_total * np.exp((logdet_l - logdet_s) / p))


# --- global rank machinery -------------------------------------------------
#
# Rank normalization (bulk/tail ESS, rank-normalized R̂) needs GLOBAL ranks.
# Each process shares a compressed per-parameter ECDF: its sorted values
# subsampled to ``max_knots`` order statistics with exact cumulative counts.
# With n_local ≤ max_knots the knots ARE the sorted shard and every count and
# quantile below is EXACT (ties included, by left/right counts); beyond that
# the per-process CDF error is at most n_local/max_knots.


def _local_ecdf(flat, max_knots):
    """(n,) values -> (knots (K,), cums (K,)): cums[j] = #{x ≤ knots[j]}."""
    sv = torch.sort(flat).values
    n = sv.shape[0]
    if n <= max_knots:
        pad = max_knots - n
        knots = torch.cat([sv, sv[-1:].expand(pad)])
        cums = torch.cat([
            torch.arange(1, n + 1, dtype=torch.float64, device=flat.device),
            torch.full((pad,), float(n), dtype=torch.float64,
                       device=flat.device)])
    else:
        idx = torch.as_tensor(
            np.round(np.linspace(0, n - 1, max_knots)).astype(np.int64),
            device=flat.device)
        knots = sv[idx]
        cums = (idx + 1).to(torch.float64)
    return knots, cums


def _ecdf_counts(knots, cums, v):
    """Global (#{x < v_m}, #{x ≤ v_m}) from stacked process ECDFs (H, K);
    v (M,). Exact when the knots are the full sorted shards."""
    less = torch.zeros(v.shape, dtype=torch.float64, device=v.device)
    leq = torch.zeros_like(less)
    for h in range(knots.shape[0]):
        jl = torch.searchsorted(knots[h], v, side="left")
        jr = torch.searchsorted(knots[h], v, side="right")
        c = cums[h]
        less += torch.where(jl > 0, c[torch.clamp(jl - 1, min=0)], 0.0)
        leq += torch.where(jr > 0, c[torch.clamp(jr - 1, min=0)], 0.0)
    return less, leq


def _merged(knots, cums):
    """The merged ECDF's sorted values and cumulative weights."""
    weights = torch.diff(cums, dim=1, prepend=torch.zeros_like(cums[:, :1]))
    vals = knots.reshape(-1)
    wts = weights.reshape(-1)
    order = torch.argsort(vals, stable=True)
    return vals[order], wts[order], torch.cumsum(wts[order], dim=0)


def _merged_quantile(knots, cums, n_total, q):
    """``np.quantile(..., method='linear')`` on the merged ECDF (exact when
    the knots are the full sorted shards)."""
    vals, _, cumw = _merged(knots, cums)

    def order_stat(k):  # 1-based k-th order statistic
        i = torch.searchsorted(cumw, torch.tensor(
            [float(k)], dtype=cumw.dtype, device=cumw.device), side="left")
        return float(vals[i.clamp(max=vals.numel() - 1)][0])

    pos = q * (n_total - 1.0)  # 0-based fractional position
    lo = np.floor(pos)
    frac = pos - lo
    x_lo = order_stat(lo + 1.0)
    x_hi = order_stat(min(lo + 2.0, n_total))
    return x_lo + frac * (x_hi - x_lo)


def _gathered_ecdf(arr, gather_, max_knots):
    """This shard's per-parameter compressed ECDFs, gathered: one exchange;
    returns (knots (H, P, K), cums (H, P, K), n_total)."""
    p = arr.shape[-1]
    flat = arr.reshape(-1, p).to(torch.float64)
    parts = [_local_ecdf(flat[:, i], max_knots) for i in range(p)]
    knots = torch.stack([k for k, _ in parts])
    cums = torch.stack([c for _, c in parts])
    g_knots, g_cums, g_n = gather_(
        knots, cums, torch.tensor(float(flat.shape[0]), dtype=torch.float64))
    return g_knots, g_cums, float(g_n.sum())


def _global_normal_scores(arr, gather_, max_knots, pre=None):
    """(S, W_local, P) shard -> normal scores by GLOBAL average ranks (the
    (r − 0.375)/(N + 0.25) convention of the local rank normalizers). One
    gather, skipped when ``pre`` holds an ECDF gathered for the same arr.
    Returns (scores, ecdf)."""
    s, w, p = arr.shape
    flat = arr.reshape(-1, p).to(torch.float64)
    g_knots, g_cums, n_total = (
        pre if pre is not None else _gathered_ecdf(arr, gather_, max_knots)
    )
    cols = []
    for i in range(p):
        less, leq = _ecdf_counts(g_knots[:, i], g_cums[:, i],
                                 flat[:, i].contiguous())
        rank = less + (leq - less + 1.0) / 2.0
        cols.append(torch.special.ndtri((rank - 0.375) / (n_total + 0.25)))
    return (torch.stack(cols, dim=1).reshape(s, w, p),
            (g_knots, g_cums, n_total))


def global_ess_bulk(local_samples, window_scaling=4.0, max_knots=4096,
                    device=None, _reduce=None, _gather=None, _pre=None):
    """Whole-ensemble rank-normalized bulk ESS (Vehtari et al. 2021) from a
    walker shard: one ECDF gather and one reduce; equal to
    ``analysis.ess_bulk`` on the full ensemble, exactly when S·W_local ≤
    max_knots, else to ECDF resolution."""
    arr, squeeze = _chain(local_samples, device=device)
    scores, _ = _global_normal_scores(arr, _gatherer(_gather, arr.device),
                                      int(max_knots), pre=_pre)
    ess = np.atleast_1d(global_effective_sample_size(
        scores, window_scaling=window_scaling, _reduce=_reduce))
    return _out(ess, squeeze)


def global_ess_tail(local_samples, prob=0.05, window_scaling=4.0,
                    max_knots=4096, device=None, _reduce=None, _gather=None,
                    _pre=None):
    """Whole-ensemble tail ESS: the smaller of the ``prob`` and ``1 −
    prob`` GLOBAL-quantile indicator ESS (equal to ``analysis.ess_tail`` on
    the full ensemble, exactly when S·W_local ≤ max_knots)."""
    arr, squeeze = _chain(local_samples, device=device)
    p = arr.shape[2]
    g_knots, g_cums, n_total = (
        _pre if _pre is not None
        else _gathered_ecdf(arr, _gatherer(_gather, arr.device),
                            int(max_knots))
    )
    out = []
    for q in (prob, 1.0 - prob):
        cut = torch.tensor([
            _merged_quantile(g_knots[:, i], g_cums[:, i], n_total, q)
            for i in range(p)], dtype=torch.float64, device=arr.device)
        ind = (arr.to(torch.float64) <= cut[None, None, :]).to(torch.float64)
        out.append(np.atleast_1d(global_effective_sample_size(
            ind, window_scaling=window_scaling, _reduce=_reduce)))
    return _out(np.minimum(*out), squeeze)


def global_rank_normalized_rhat(local_samples, max_knots=4096,
                                device=None, _reduce=None, _gather=None,
                                _pre=None):
    """Whole-ensemble RANK-NORMALIZED split-R̂ (Vehtari et al. 2021): one
    ECDF gather and one reduce; equal to
    ``analysis.potential_scale_reduction(full, rank_normalized=True)``,
    exactly when S·W_local ≤ max_knots. ``_pre`` is honoured only for an
    even S (an odd S ranks the trimmed value set)."""
    arr, squeeze = _chain(local_samples, device=device)
    s_even = arr.shape[0] - arr.shape[0] % 2
    # rank over the SAME value set the local split path sees (trim first:
    # splitting is a reshape, so ranks commute with it)
    pre = _pre if s_even == arr.shape[0] else None
    scores, _ = _global_normal_scores(arr[:s_even],
                                      _gatherer(_gather, arr.device),
                                      int(max_knots), pre=pre)
    return _out(global_split_rhat(scores, _reduce=_reduce), squeeze)


def _merged_hdi(knots, cums, n_total, prob):
    """Shortest interval holding ``prob`` mass, from the merged ECDF (the
    convention of ``analysis.hdi``: keep = floor(prob·n) order statistics;
    exact when the knots are the full sorted shards)."""
    vals, wts, cumw = _merged(knots, cums)
    live = wts > 0
    keep = max(1, int(np.floor(prob * n_total)))
    if keep >= n_total:
        raise ValueError(f"prob={prob} needs more than {n_total} draws")
    starts = torch.cat([cumw.new_zeros(1), cumw[:-1]])[live]
    ends = starts + 1.0 + keep  # rank of the interval's upper endpoint
    ok = ends <= n_total
    starts_v = vals[live][ok]
    hi_idx = torch.searchsorted(cumw, ends[ok], side="left")
    hi_v = vals[torch.clamp(hi_idx, max=vals.numel() - 1)]
    i = int(torch.argmin(hi_v - starts_v))
    return float(starts_v[i]), float(hi_v[i])


def global_mcse_mean(local_samples, window_scaling=4.0, device=None,
                     _reduce=None):
    """Whole-ensemble Monte-Carlo standard error of the posterior mean:
    global sd / sqrt(global ESS) (equal to ``analysis.mcse_mean`` on the
    full ensemble)."""
    arr, squeeze = _chain(local_samples, device=device)
    reduce_ = _reducer(_reduce, arr.device)
    n, sx, sxx = reduce_(*_moments_raw(
        arr.reshape(-1, arr.shape[-1]).to(torch.float64)))
    sd = torch.sqrt(torch.clamp((sxx - sx * sx / n) / (n - 1.0), min=0.0))
    ess = np.atleast_1d(global_effective_sample_size(
        arr, window_scaling=window_scaling, _reduce=_reduce))
    return _out(sd.cpu().numpy() / np.sqrt(np.maximum(ess, 1.0)), squeeze)


def global_summary(local_samples, prob=0.9, max_knots=4096,
                   window_scaling=4.0, device=None, _reduce=None,
                   _gather=None):
    """Whole-ensemble posterior summary from a walker shard, the collective
    counterpart of ``analysis.summary`` (the same keys: mean, sd, median,
    central interval, HDI, ess, ess_bulk, ess_tail, rhat, mcse). Moments
    from exact partials; order statistics from the merged compressed ECDF
    (exact when S·W_local ≤ max_knots); the ESS family and rank-normalized
    R̂ from the decompositions above."""
    arr, _ = _chain(local_samples, (3,), "(S, W_local, P)", device)
    s, w, p = arr.shape
    reduce_ = _reducer(_reduce, arr.device)
    gather_ = _gatherer(_gather, arr.device)
    flat = arr.reshape(-1, p).to(torch.float64)
    # ONE ECDF gather for every order statistic and the rank normalization
    pre = _gathered_ecdf(arr, gather_, int(max_knots))
    g_knots, g_cums, n_total = pre
    n, sx, sxx = reduce_(*_moments_raw(flat))
    mean = (sx / n).cpu().numpy()
    sd = torch.sqrt(torch.clamp((sxx - sx * sx / n) / (n - 1.0),
                                min=0.0)).cpu().numpy()
    lo_q, hi_q = (1 - prob) / 2, 1 - (1 - prob) / 2
    qs = {q: np.empty(p) for q in (0.5, lo_q, hi_q)}
    hdi_lo = np.empty(p)
    hdi_hi = np.empty(p)
    for i in range(p):
        for q in qs:
            qs[q][i] = _merged_quantile(g_knots[:, i], g_cums[:, i],
                                        n_total, q)
        hdi_lo[i], hdi_hi[i] = _merged_hdi(g_knots[:, i], g_cums[:, i],
                                           n_total, prob)
    ess = np.atleast_1d(global_effective_sample_size(
        arr, window_scaling=window_scaling, _reduce=_reduce))
    if s % 2 == 0:
        # one normal-scores pass feeds both bulk ESS and rank-R̂ (the split
        # path ranks the same value set when S is even)
        scores, _ = _global_normal_scores(arr, gather_, int(max_knots),
                                          pre=pre)
        bulk = np.atleast_1d(global_effective_sample_size(
            scores, window_scaling=window_scaling, _reduce=_reduce))
        rhat = global_split_rhat(scores, _reduce=_reduce)
    else:
        bulk = np.atleast_1d(global_ess_bulk(
            arr, window_scaling=window_scaling, max_knots=max_knots,
            _reduce=_reduce, _gather=_gather, _pre=pre))
        rhat = global_rank_normalized_rhat(
            arr, max_knots=max_knots, _reduce=_reduce, _gather=_gather)
    tail = np.atleast_1d(global_ess_tail(
        arr, window_scaling=window_scaling, max_knots=max_knots,
        _reduce=_reduce, _gather=_gather, _pre=pre))
    return {
        "mean": mean,
        "sd": sd,
        "median": qs[0.5],
        f"q{round(lo_q * 100, 6):g}": qs[lo_q],
        f"q{round(hi_q * 100, 6):g}": qs[hi_q],
        "hdi_lo": hdi_lo,
        "hdi_hi": hdi_hi,
        "ess": ess,
        "ess_bulk": bulk,
        "ess_tail": tail,
        "rhat": rhat,
        "mcse": sd / np.sqrt(np.maximum(ess, 1.0)),
    }


def global_split_rhat(local_samples, device=None, _reduce=None):
    """Whole-ensemble split-R̂ from a walker shard (S, W_local, P): the
    classic (not rank-normalized) Gelman–Rubin split-R̂, equal to
    ``analysis.potential_scale_reduction(..., rank_normalized=False)`` on
    the full ensemble. Partials per parameter: the split-chain count, Σ m_c,
    Σ m_c² over split-chain means, Σ s_c² over within-chain variances."""
    arr, _ = _chain(local_samples, (3,), "(S, W_local, P)", device)
    arr = arr.to(torch.float64)
    s_even = arr.shape[0] - arr.shape[0] % 2
    half = s_even // 2
    # (half, 2·W_local, P): each walker's series split in two chains
    x = torch.cat([arr[:half], arr[half:s_even]], dim=1)
    s, c, p = x.shape
    m = x.mean(dim=0)  # (2W, P) split-chain means
    v = x.var(dim=0, correction=1)  # (2W, P) within-chain variances
    reduce_ = _reducer(_reduce, arr.device)
    count, sm, smm, sv = reduce_(
        torch.tensor(float(c), dtype=torch.float64), m.sum(dim=0),
        (m * m).sum(dim=0), v.sum(dim=0))
    mean_m = sm / count
    b = s * (smm - count * mean_m ** 2) / (count - 1.0)  # between-chain
    w = sv / count  # mean within-chain
    var_plus = (s - 1.0) / s * w + b / s
    rhat = torch.sqrt(var_plus / w)
    return torch.where(w > 0, rhat, torch.inf).cpu().numpy()
