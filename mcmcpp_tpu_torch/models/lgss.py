"""Linear-Gaussian state space: the parallel-in-time Kalman filter, the RTS
smoother, exact forward-filter backward-sampling (FFBS) and a blocked-Gibbs
kernel for latent trajectories.

PyTorch counterpart of ``mcmcpp_tpu/models/lgss.py``. The model (D latent,
E observed):

    x_1 ~ N(m1, P1)                       [or x_1 = A x_0 + b + w with
                                           x_0 ~ N(m0, P0): initial="prior"]
    x_t = A x_{t-1} + b + w_t,   w_t ~ N(0, Q)     t = 2..T
    y_t = H x_t + c + v_t,       v_t ~ N(0, R)     t = 1..T

``method="parallel"`` (the default) runs the filter as one associative scan
over the Särkkä & García-Fernández (2021) elements ``(A, b, C, eta, J)``
(:func:`mcmcpp_tpu_torch.ops.scan.associative_scan`, the recursion of JAX's
``lax.associative_scan``): O(log T) levels of batched (T, D, D) ops, where
the JAX package ``vmap``s its combine over time. The FFBS draw, with its
noise drawn up front, is a reverse scan over affine maps. ``"sequential"``
runs the textbook recursion as a Python loop over T, each step a handful of
small device ops and no host sync; unlike the reference it symmetrizes the
filtered covariance each step, which keeps float32 runs on diffuse priors
near float64 (the reference's drift there is measured in
``tests/test_torch_lgss.py``). The time-invariant and the time-varying
models share one code path: a time-invariant matrix is broadcast over T
(a view), as the JAX package's ``_tv_view`` does for its time-varying paths.

Differences from the JAX package, by design: ``cho_factor``/``cho_solve``
are ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``; where a matrix
is not positive definite, torch's Cholesky raises and JAX's returns NaN, so
the port fills a failed factor with NaN (a non-finite log-likelihood, which
PMMH and SMC² reject) rather than stop a run. ``ffbs_sample`` takes a
``torch.Generator`` where JAX's takes a key, and its noise ``z`` may be
handed over (a replay), with leading batch axes for several draws from one
filter. Everything stays differentiable by autograd (``lgss_loglik`` is
the collapsed target of the gradient engines).
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.ops.scan import associative_scan

__all__ = ["Component", "FilterResult", "LGSSKernel", "LGSSParams",
           "autoregressive", "ffbs_sample", "forecast", "kalman_filter",
           "lgss_loglik", "lgss_params", "local_level", "local_linear_trend",
           "rts_smoother", "seasonal", "structural"]


class LGSSParams(NamedTuple):
    """Model matrices (D latent, E observed). Any subset of A/b/Q/H/c/R may
    carry a leading time axis (``A``/``Q`` (T, D, D), ``b`` (T, D), ``H``
    (T, E, D), ``c`` (T, E), ``R`` (T, E, E)): ``A_t/b_t/Q_t`` govern the
    transition INTO step t (index 0 is used only by ``initial="prior"``),
    ``H_t/c_t/R_t`` observe step t."""

    A: torch.Tensor
    b: torch.Tensor
    Q: torch.Tensor
    H: torch.Tensor
    c: torch.Tensor
    R: torch.Tensor
    m0: torch.Tensor
    P0: torch.Tensor


class FilterResult(NamedTuple):
    means: torch.Tensor   # (T, D) filtered E[x_t | y_{1:t}]
    covs: torch.Tensor    # (T, D, D)
    loglik: torch.Tensor  # () log p(y_{1:T})


def _is_tv(p):
    return (p.H.ndim == 3 or p.A.ndim == 3 or p.Q.ndim == 3
            or p.R.ndim == 3 or p.b.ndim == 2 or p.c.ndim == 2)


def _tv_view(p, t_n):
    """Every matrix with a leading time axis (a broadcast view where it has
    none): (As, bs, Qs, Hs, cs, Rs)."""
    d = p.A.shape[-1]
    e = p.H.shape[-2]

    def bc(x, shape, name):
        if x.ndim == len(shape) - 1:
            return x.expand((t_n,) + tuple(x.shape))
        if tuple(x.shape) != (t_n,) + shape[1:]:
            raise ValueError(
                f"time-varying {name} has shape {tuple(x.shape)}; expected "
                f"{shape[1:]} or {(t_n,) + shape[1:]} (ys has T={t_n})")
        return x

    return (bc(p.A, (t_n, d, d), "A"), bc(p.b, (t_n, d), "b"),
            bc(p.Q, (t_n, d, d), "Q"), bc(p.H, (t_n, e, d), "H"),
            bc(p.c, (t_n, e), "c"), bc(p.R, (t_n, e, e), "R"))


def _as(x, dtype, device):
    """``x`` as a tensor on ``device``: a Python number is filled in there
    (a copy from the host would wait for the device: a Gibbs sweep that
    rebuilds its parameters each time would sync once a constant)."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def resolve_device(device):
    # imported here: the models package loads while the sampler module does
    from mcmcpp_tpu_torch.sampler import resolve_device as resolve

    return resolve(device)


def lgss_params(A, b, Q, H, c, R, m0, P0, dtype=torch.float32,
                device="cuda"):
    """Build :class:`LGSSParams` on ``device``, promoting scalars and 1-D
    shorthands as the JAX package does (a scalar ``Q``/``R``/``P0`` times
    the identity). Tensors keep their autograd graph."""
    device = resolve_device(device)
    A = torch.atleast_2d(_as(A, dtype, device))
    d = A.shape[-1]
    Q = _as(Q, dtype, device)
    Q = Q * torch.eye(d, dtype=dtype, device=device) if Q.ndim == 0 \
        else torch.atleast_2d(Q)
    H = torch.atleast_2d(_as(H, dtype, device))
    e = H.shape[-2]
    R = _as(R, dtype, device)
    R = R * torch.eye(e, dtype=dtype, device=device) if R.ndim == 0 \
        else torch.atleast_2d(R)
    P0 = _as(P0, dtype, device)
    P0 = P0 * torch.eye(d, dtype=dtype, device=device) if P0.ndim == 0 \
        else torch.atleast_2d(P0)
    b = _as(b, dtype, device)
    if b.ndim < 2:
        b = b.expand((d,))
    c = _as(c, dtype, device)
    if c.ndim < 2:
        c = c.expand((e,))
    return LGSSParams(A=A, b=b, Q=Q, H=H, c=c, R=R,
                      m0=_as(m0, dtype, device).expand((d,)), P0=P0)


def nan_cholesky(s):
    """Lower Cholesky factor of ``s`` (…, n, n); NaN where it is not
    positive definite (≙ JAX's ``cho_factor``/``cholesky``), not a raise."""
    fac, info = torch.linalg.cholesky_ex(s)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(fac, float("nan")), fac)


def solve(a, b):
    """``torch.linalg.solve`` without its singularity check, which waits
    for the device (a singular system gives inf/NaN, as JAX's solve)."""
    return torch.linalg.solve_ex(a, b)[0]


def _mv(a, v):
    """a @ v on the last axes, batched: (…, n, m) with (…, m)."""
    return (a @ v[..., None])[..., 0]


def _gauss_ll(fac, innov, e):
    """log N(innov; 0, L Lᵀ) from the factor, batched."""
    quad = torch.sum(innov * torch.cholesky_solve(innov[..., None], fac)[
        ..., 0], -1)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(fac, dim1=-2,
                                                      dim2=-1)), -1)
    return -0.5 * (e * np.log(2.0 * np.pi) + logdet + quad)


def _first_pred(p, As, bs, Qs, initial):
    """Predictive mean/cov of x_1 before seeing y_1."""
    if initial == "state":
        return p.m0, p.P0
    if initial == "prior":
        return As[0] @ p.m0 + bs[0], As[0] @ p.P0 @ As[0].mT + Qs[0]
    raise ValueError(f"initial must be 'state' or 'prior', got {initial!r}")


def _seq_filter(p, ys, initial, mask):
    t_n = ys.shape[0]
    As, bs, Qs, Hs, cs, Rs = _tv_view(p, t_n)
    e = Hs.shape[1]
    zero = ys.new_zeros(())

    def measure(mp, Pp, t):
        """Masked update: a missing step keeps the predictive moments and
        adds zero log-likelihood (its y arrives NaN-scrubbed)."""
        h, obs = Hs[t], mask[t]
        fac = nan_cholesky(h @ Pp @ h.mT + Rs[t])
        innov = ys[t] - h @ mp - cs[t]
        hp = h @ Pp
        gain = torch.cholesky_solve(hp, fac).mT
        m = torch.where(obs, mp + gain @ innov, mp)
        # symmetrized: without it the float32 covariance drifts off
        # symmetry, and a diffuse structural model's means with it (the
        # reference's own sequential filter, which does not symmetrize,
        # ends 2.5% of the state scale off float64 there at T = 1024)
        cov = torch.where(obs, Pp - gain @ hp, Pp)
        cov = 0.5 * (cov + cov.mT)
        return m, cov, torch.where(obs, _gauss_ll(fac, innov, e), zero)

    m1p, P1p = _first_pred(p, As, bs, Qs, initial)
    m, cov, ll = measure(m1p, P1p, 0)
    means, covs, lls = [m], [cov], [ll]
    for t in range(1, t_n):
        a = As[t]
        m, cov, ll = measure(a @ m + bs[t], a @ cov @ a.mT + Qs[t], t)
        means.append(m)
        covs.append(cov)
        lls.append(ll)
    return FilterResult(torch.stack(means), torch.stack(covs),
                        torch.sum(torch.stack(lls)))


def _combine_filter(e1, e2):
    """Associative combination of two batches of filtering elements (ibid.,
    Lemma 8); the inverses are solves against I + C₁J₂ / I + J₂C₁."""
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    eye = torch.eye(a1.shape[-1], dtype=a1.dtype, device=a1.device)
    a2s = solve((eye + c1 @ j2).mT, a2.mT).mT  # A₂(I + C₁J₂)⁻¹
    a = a2s @ a1
    b = _mv(a2s, b1 + _mv(c1, eta2)) + b2
    c = a2s @ c1 @ a2.mT + c2
    a1s = solve((eye + j2 @ c1).mT, a1).mT     # A₁ᵀ(I + J₂C₁)⁻¹
    eta = _mv(a1s, eta2 - _mv(j2, b1)) + eta1
    j = a1s @ j2 @ a1 + j1
    return a, b, c, eta, j


def _parallel_filter(p, ys, initial, mask):
    t_n = ys.shape[0]
    As, bs, Qs, Hs, cs, Rs = _tv_view(p, t_n)
    e, d = Hs.shape[1], As.shape[-1]
    dt, dev = ys.dtype, ys.device
    eye = torch.eye(d, dtype=dt, device=dev)

    # the generic element (k >= 2): the prediction covariance is Q_k
    fac = nan_cholesky(Hs @ Qs @ Hs.mT + Rs)
    gain = torch.cholesky_solve(Hs @ Qs, fac).mT          # Q Hᵀ S⁻¹
    imkh = eye - gain @ Hs
    ht_sinv = torch.cholesky_solve(Hs, fac).mT            # Hᵀ S⁻¹
    resid = ys - _mv(Hs, bs) - cs
    at_hs = As.mT @ ht_sinv
    m3, m2 = mask[:, None, None], mask[:, None]
    # a MISSING step contributes the pure prediction element (A, b, Q, 0, 0)
    a_g = torch.where(m3, imkh @ As, As)
    b_g = torch.where(m2, bs + _mv(gain, resid), bs)
    c_g = torch.where(m3, imkh @ Qs, Qs)
    eta_g = torch.where(m2, _mv(at_hs, resid),
                        torch.zeros((t_n, d), dtype=dt, device=dev))
    j_g = torch.where(m3, at_hs @ Hs @ As, torch.zeros_like(eye))

    # element 1 conditions on the initial distribution, not on x_0
    m1p, P1p = _first_pred(p, As, bs, Qs, initial)
    h0 = Hs[0]
    fac1 = nan_cholesky(h0 @ P1p @ h0.mT + Rs[0])
    k1 = torch.cholesky_solve(h0 @ P1p, fac1).mT
    b_1 = torch.where(mask[0], m1p + k1 @ (ys[0] - h0 @ m1p - cs[0]), m1p)
    c_1 = torch.where(mask[0], P1p - k1 @ (h0 @ P1p), P1p)
    zero_d = torch.zeros((1, d, d), dtype=dt, device=dev)
    elems = (torch.cat([zero_d, a_g[1:]]), torch.cat([b_1[None], b_g[1:]]),
             torch.cat([c_1[None], c_g[1:]]),
             torch.cat([torch.zeros((1, d), dtype=dt, device=dev),
                        eta_g[1:]]),
             torch.cat([zero_d, j_g[1:]]))
    _, means, covs, _, _ = associative_scan(_combine_filter, elems)

    # the log-likelihood from the one-step predictives, batched over T
    m_pred = torch.cat([m1p[None], _mv(As[1:], means[:-1]) + bs[1:]])
    p_pred = torch.cat([P1p[None], As[1:] @ covs[:-1] @ As[1:].mT + Qs[1:]])
    s_all = Hs @ p_pred @ Hs.mT + Rs
    innov = ys - _mv(Hs, m_pred) - cs
    lls = _gauss_ll(nan_cholesky(s_all), innov, e)
    loglik = torch.sum(torch.where(mask, lls, torch.zeros_like(lls)))
    return FilterResult(means, covs, loglik)


def kalman_filter(params, ys, method="parallel", initial="state", mask=None):
    """Filtered means/covariances and the marginal log-likelihood.

    ys: (T, E) observations ((T,) is promoted to (T, 1)). ``mask`` ((T,)
    bool, True = observed), or NaN rows in ``ys``: a missing step skips its
    update and adds zero log-likelihood."""
    ys = torch.as_tensor(ys, dtype=params.A.dtype, device=params.A.device)
    if ys.ndim == 1:
        ys = ys[:, None]
    if mask is None:
        mask = torch.all(torch.isfinite(ys), 1)
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=ys.device)
        if tuple(mask.shape) != (ys.shape[0],):
            raise ValueError(f"mask must be ({ys.shape[0]},)")
    # scrub NaNs so masked arithmetic cannot poison the observed path
    ys = torch.where(mask[:, None] & torch.isfinite(ys), ys,
                     torch.zeros_like(ys))
    if method == "parallel":
        return _parallel_filter(params, ys, initial, mask)
    if method == "sequential":
        return _seq_filter(params, ys, initial, mask)
    raise ValueError(f"method must be 'parallel'|'sequential', got {method!r}")


def lgss_loglik(params, ys, method="parallel", initial="state", mask=None):
    """Marginal log p(y_obs) with the states integrated out; differentiable
    in every parameter by autograd."""
    return kalman_filter(params, ys, method=method, initial=initial,
                         mask=mask).loglik


def rts_smoother(params, ys=None, filtered=None, method="parallel",
                 initial="state", mask=None):
    """Rauch–Tung–Striebel smoothed means (T, D) and covariances (T, D, D).
    The gains are batched over T; the backward recursion is a loop."""
    if filtered is None:
        filtered = kalman_filter(params, ys, method=method, initial=initial,
                                 mask=mask)
    ms, Ps = filtered.means, filtered.covs
    t_n = ms.shape[0]
    As, bs, Qs, _, _, _ = _tv_view(params, t_n)
    a, bv, q = As[1:], bs[1:], Qs[1:]
    p_pred = a @ Ps[:-1] @ a.mT + q
    gain = solve(p_pred, a @ Ps[:-1]).mT  # P Aᵀ Pp⁻¹
    m_pred = _mv(a, ms[:-1]) + bv
    m_s, p_s = ms[-1], Ps[-1]
    out_m, out_p = [m_s], [p_s]
    for t in range(t_n - 2, -1, -1):
        g = gain[t]
        m_s = ms[t] + g @ (m_s - m_pred[t])
        p_s = Ps[t] + g @ (p_s - p_pred[t]) @ g.mT
        out_m.append(m_s)
        out_p.append(p_s)
    return torch.stack(out_m[::-1]), torch.stack(out_p[::-1])


def ffbs_sample(gen, params, ys=None, filtered=None, method="parallel",
                initial="state", jitter=0.0, mask=None, z=None):
    """An EXACT joint draw x_{1:T} ~ p(x | y), (T, D): the Carter–Kohn
    backward recursion ``x_t = G_t x_{t+1} + d_t + L_t z_t`` with the
    noises ``z`` drawn up front, run as a reverse associative scan over the
    affine maps (``method="parallel"``) or a loop.

    ``z``: the (T, D) standard normals (JAX's ``normal(key, (T, D))``), or
    (…, T, D) for several draws from one filter (then (…, T, D) out); drawn
    from ``gen`` when None. ``jitter`` adds a diagonal nugget before the
    conditional Choleskys (for exactly singular Q directions)."""
    if filtered is None:
        filtered = kalman_filter(params, ys, method=method, initial=initial,
                                 mask=mask)
    ms, Ps = filtered.means, filtered.covs
    t_n, d = ms.shape
    dt, dev = ms.dtype, ms.device
    eye_j = jitter * torch.eye(d, dtype=dt, device=dev)
    As, bs, Qs, _, _, _ = _tv_view(params, t_n)
    a, bv, q = As[1:], bs[1:], Qs[1:]
    # x_t | x_{t+1}, y_{1:t} = N(G x_{t+1} + d_t, Σ_t), batched over t
    a_p = a @ Ps[:-1]
    gains = solve(a_p @ a.mT + q, a_p).mT
    dvecs = ms[:-1] - _mv(gains, _mv(a, ms[:-1]) + bv)
    facs = nan_cholesky(Ps[:-1] - gains @ a_p + eye_j)
    if z is None:
        z = torch.randn((t_n, d), generator=gen, dtype=dt, device=dev)
    single = z.ndim == 2
    lead = tuple(z.shape[:-2])
    zt = z.reshape((-1, t_n, d)).movedim(1, 0)          # (T, B, D)
    fac_t = nan_cholesky(Ps[-1] + eye_j)
    x_last = ms[-1] + zt[-1] @ fac_t.mT                 # (B, D)
    u = dvecs[:, None, :] + torch.einsum("tij,tbj->tbi", facs, zt[:-1])
    if method == "sequential":
        xs, x = [x_last], x_last
        for t in range(t_n - 2, -1, -1):
            x = x @ gains[t].mT + u[t]
            xs.append(x)
        out = torch.stack(xs[::-1])
    else:
        # state t is f_t ∘ … ∘ f_{T-1} applied to x_T, f_t(x) = G_t x + u_t;
        # in prefix order (innermost first) combine(a, b) = b ∘ a
        def combine(first, second):
            fa, ua = first
            fb, ub = second
            return fb @ fa, torch.einsum("tij,tbj->tbi", fb, ua) + ub

        f_c, u_c = associative_scan(
            combine, (torch.flip(gains, (0,)), torch.flip(u, (0,))))
        xs = torch.einsum("tij,bj->tbi", f_c, x_last) + u_c
        out = torch.cat([torch.flip(xs, (0,)), x_last[None]])
    out = out.movedim(0, 1)                              # (B, T, D)
    return out[0] if single else out.reshape(lead + (t_n, d))


def forecast(params, ys=None, filtered=None, horizon=1, method="parallel",
             initial="state", mask=None):
    """k-step-ahead predictive moments from the filtered endpoint:
    ``(state_means (h, D), state_covs (h, D, D), obs_means (h, E),
    obs_covs (h, E, E))`` for horizons 1..h."""
    if _is_tv(params):
        raise ValueError(
            "forecast() needs observation matrices for FUTURE steps, "
            "which a (T, E, D) time-varying H does not carry. Forecast a "
            "dynamic-regression model by filtering with the horizon "
            "appended: extend H with the future covariate rows, append "
            "NaN rows to ys (mask=False) — the filter coasts on "
            "prediction steps, so the filtered moments AT those rows are "
            "exactly p(x_{T+k} | y_{1:T}).")
    if filtered is None:
        filtered = kalman_filter(params, ys, method=method, initial=initial,
                                 mask=mask)
    p = params
    m, cov = filtered.means[-1], filtered.covs[-1]
    ms, covs = [], []
    for _ in range(int(horizon)):
        m = p.A @ m + p.b
        cov = p.A @ cov @ p.A.mT + p.Q
        ms.append(m)
        covs.append(cov)
    ms, covs = torch.stack(ms), torch.stack(covs)
    return ms, covs, ms @ p.H.mT + p.c, p.H @ covs @ p.H.mT + p.R


class Component(NamedTuple):
    """One structural block: transition ``A`` (d, d), innovation covariance
    ``Q`` (d, d), observation row ``h`` (d,)."""

    A: torch.Tensor
    Q: torch.Tensor
    h: torch.Tensor


def local_level(sigma_level=1.0, dtype=torch.float32, device="cuda"):
    """Random-walk level: x_{t+1} = x_t + N(0, sigma_level^2)."""
    device = resolve_device(device)
    s = _as(sigma_level, dtype, device)
    return Component(A=torch.eye(1, dtype=dtype, device=device),
                     Q=(s * s).reshape(1, 1),
                     h=torch.ones((1,), dtype=dtype, device=device))


def local_linear_trend(sigma_level=1.0, sigma_slope=0.1, dtype=torch.float32,
                       device="cuda"):
    """Level + slope: level_{t+1} = level_t + slope_t + eps_l,
    slope_{t+1} = slope_t + eps_s."""
    device = resolve_device(device)
    sl, ss = _as(sigma_level, dtype, device), _as(sigma_slope, dtype, device)
    return Component(
        A=torch.tensor([[1.0, 1.0], [0.0, 1.0]], dtype=dtype, device=device),
        Q=torch.diag(torch.stack([sl * sl, ss * ss])),
        h=torch.tensor([1.0, 0.0], dtype=dtype, device=device))


def seasonal(n_seasons, sigma=0.0, dtype=torch.float32, device="cuda"):
    """Dummy-variable seasonality with period ``n_seasons``: the S-1 state
    entries sum (with the implicit current one) to noise."""
    device = resolve_device(device)
    s = int(n_seasons)
    if s < 2:
        raise ValueError("n_seasons must be >= 2")
    a = torch.zeros((s - 1, s - 1), dtype=dtype, device=device)
    a[0, :] = -1.0
    a[1:, :-1] = torch.eye(s - 2, dtype=dtype, device=device)
    sg = _as(sigma, dtype, device)
    q = torch.diag(torch.cat([(sg * sg).reshape(1), torch.zeros(
        s - 2, dtype=dtype, device=device)]))
    h = torch.zeros((s - 1,), dtype=dtype, device=device)
    h[0] = 1.0
    return Component(A=a, Q=q, h=h)


def autoregressive(phi, sigma=1.0, dtype=torch.float32, device="cuda"):
    """Stationary AR(1) disturbance component."""
    device = resolve_device(device)
    sg = _as(sigma, dtype, device)
    return Component(A=_as(phi, dtype, device).reshape(1, 1),
                     Q=(sg * sg).reshape(1, 1),
                     h=torch.ones((1,), dtype=dtype, device=device))


def structural(components, sigma_obs, m0=None, p0_scale=1e3,
               dtype=torch.float32):
    """Block-diagonal BSTS-style composition of :class:`Component`s into
    :class:`LGSSParams` (y_t = the components' observations summed +
    N(0, sigma_obs^2)), on the components' device. Every entry stays
    differentiable."""
    components = list(components)
    if not components:
        raise ValueError("need at least one component")
    device = components[0].A.device
    A = torch.block_diag(*[c.A for c in components]).to(dtype)
    Q = torch.block_diag(*[c.Q for c in components]).to(dtype)
    h = torch.cat([c.h.to(dtype) for c in components])
    d = A.shape[0]
    so = _as(sigma_obs, dtype, device)
    return LGSSParams(
        A=A, b=torch.zeros((d,), dtype=dtype, device=device), Q=Q,
        H=h[None, :], c=torch.zeros((1,), dtype=dtype, device=device),
        R=(so * so).reshape(1, 1),
        m0=(torch.zeros((d,), dtype=dtype, device=device) if m0 is None
            else _as(m0, dtype, device).expand((d,))),
        P0=float(p0_scale) * torch.eye(d, dtype=dtype, device=device))


class LGSSKernel:
    """Blocked-Gibbs kernel drawing a latent state trajectory EXACTLY from
    its full conditional by FFBS. Declare the trajectory as a flat
    ``(T*D,)`` block::

        BlockedGibbsSampler([
            ("x", T * D, LGSSKernel(ys, params_fn)),
            ("log_sigma", 1, <any kernel>),   # hypers see x via `others`
        ], n_chains, device=...)

    ys: (T, E) observations. params_fn: :class:`LGSSParams`, or a per-chain
    callable ``others {name: (size,)} -> LGSSParams`` (vmapped over the
    chains) so the matrices track live hyperparameter blocks. Noise: the
    FFBS normals ``z`` (C, T, D)."""

    def __init__(self, ys, params_fn, method="parallel", initial="state",
                 jitter=0.0):
        ys = torch.as_tensor(np.asarray(ys) if not isinstance(
            ys, torch.Tensor) else ys)
        self.ys = ys[:, None] if ys.ndim == 1 else ys
        self._params = params_fn
        self.method = method
        self.initial = initial
        self.jitter = float(jitter)
        self._held = {}

    def _ys(self, x):
        key = (x.device, x.dtype)
        if key not in self._held:
            self._held[key] = self.ys.to(x.device, x.dtype)
        return self._held[key]

    def draw_noise(self, gen, x, others):
        t_n = self.ys.shape[0]
        return torch.randn((x.shape[0], t_n, x.shape[1] // t_n),
                           generator=gen, dtype=x.dtype, device=x.device)

    def _draw(self, params, ys, z):
        return ffbs_sample(None, params, ys, method=self.method,
                           initial=self.initial, jitter=self.jitter, z=z)

    def apply(self, noise, x, others):
        ys = self._ys(x)
        if callable(self._params):
            draws = torch.func.vmap(
                lambda o, z: self._draw(self._params(o), ys, z))(others,
                                                                 noise)
        else:
            draws = self._draw(self._params, ys, noise)
        return draws.reshape(x.shape[0], -1).to(x.dtype)
