"""The port's linear-Gaussian state-space layer held against the JAX package.

- In float64 to 1e-9: both filters (time-invariant and every matrix
  time-varying, with and without missing steps, both initial conventions),
  ``lgss_loglik`` and its gradient in the noise scales, ``rts_smoother``,
  ``forecast``, the structural components, and ``ffbs_sample`` (both
  methods) and ``LGSSKernel`` replayed on JAX's own normals ``z``.
- The parallel and sequential filters agree in float32 (means 1e-4
  relative to the state scale, log-likelihood 1e-3 relative).
- A non-positive-definite innovation covariance gives a NaN
  log-likelihood, not a raise (JAX's Cholesky returns NaN).
- ``tests/test_lgss.py``'s oracles at its bounds: FFBS moments against the
  smoother and the LGSSKernel + conjugate variance Gibbs loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu.models import lgss as jl
from mcmcpp_tpu_torch.convert import lgss_params_from_numpy
from mcmcpp_tpu_torch.models import lgss as tl

torch.set_num_threads(1)

TOL = 1e-9
D, E, T = 2, 1, 9
F64 = torch.float64


def _raw(tv=False, t_n=T):
    rng = np.random.default_rng(3)
    A = np.array([[0.9, 0.2], [-0.1, 0.7]])
    b = np.array([0.1, -0.2])
    q = rng.standard_normal((D, D)) * 0.3
    Q = q @ q.T + 0.05 * np.eye(D)
    H = np.array([[1.0, 0.5]])
    c = np.array([0.3])
    R = np.array([[0.4]])
    m0, P0 = np.array([0.5, -0.5]), np.array([[0.8, 0.1], [0.1, 0.6]])
    if tv:  # every matrix with a time axis
        A = A + 0.05 * rng.standard_normal((t_n, D, D))
        b = b + 0.1 * rng.standard_normal((t_n, D))
        Q = Q * (1.0 + 0.2 * rng.random((t_n, 1, 1)))
        H = H + 0.2 * rng.standard_normal((t_n, E, D))
        c = c + 0.1 * rng.standard_normal((t_n, E))
        R = R * (1.0 + rng.random((t_n, 1, 1)))
    return A, b, Q, H, c, R, m0, P0


def _ys(t_n=T, missing=False):
    ys = np.random.default_rng(7).standard_normal((t_n, E))
    if missing:
        ys[[2, 5]] = np.nan
    return ys


def _pair(raw):
    with jax.enable_x64(True):
        jp = jl.lgss_params(*raw, dtype=jnp.float64)
    return jp, lgss_params_from_numpy(jp, dtype=F64, device="cpu")


KALMAN = jax.jit(jl.kalman_filter, static_argnames=("method", "initial"))


@pytest.mark.parametrize("tv", [False, True], ids=["ti", "tv"])
@pytest.mark.parametrize("missing", [False, True], ids=["full", "missing"])
@pytest.mark.parametrize("initial", ["state", "prior"])
def test_filters_smoother_forecast_match_jax_float64(tv, missing, initial):
    raw = _raw(tv)
    ys = _ys(missing=missing)
    jp, tp = _pair(raw)
    with jax.enable_x64(True):
        for method in ("parallel", "sequential"):
            want = KALMAN(jp, ys, method=method, initial=initial)
            got = tl.kalman_filter(tp, ys, method=method, initial=initial)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=TOL)
        jm, jP = jl.rts_smoother(jp, ys, initial=initial,
                                 filtered=KALMAN(jp, ys, initial=initial))
    tm, tP = tl.rts_smoother(tp, ys, initial=initial)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=TOL)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=0, atol=TOL)
    if not tv:
        with jax.enable_x64(True):
            want = jl.forecast(jp, ys, horizon=4, initial=initial)
        got = tl.forecast(tp, ys, horizon=4, initial=initial)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)
    else:
        with pytest.raises(ValueError, match="FUTURE"):
            tl.forecast(tp, ys)


def test_loglik_gradient_matches_jax_float64():
    A, b, _, H, c, _, m0, P0 = _raw()
    ys = _ys(missing=True)
    s0 = np.array([0.1, -0.3])

    def jll(s):
        return jl.lgss_loglik(jl.lgss_params(
            A, b, jnp.exp(s[0]) * jnp.eye(D), H, c, jnp.exp(s[1]), m0, P0,
            dtype=jnp.float64), ys, method="sequential")

    with jax.enable_x64(True):
        want = np.asarray(jax.grad(jll)(jnp.asarray(s0)))
    for method in ("parallel", "sequential"):
        s = torch.tensor(s0, requires_grad=True)
        ll = tl.lgss_loglik(tl.lgss_params(
            A, b, torch.exp(s[0]) * torch.eye(D, dtype=F64), H, c,
            torch.exp(s[1]), m0, P0, dtype=F64, device="cpu"), ys,
            method=method)
        (g,) = torch.autograd.grad(ll, s)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("tv", [False, True], ids=["ti", "tv"])
def test_ffbs_and_kernel_replay_jax_z_float64(tv):
    raw = _raw(tv)
    ys = _ys(missing=True)
    jp, tp = _pair(raw)
    keys = jax.random.split(jax.random.key(5), 3)
    with jax.enable_x64(True):
        zs = np.stack([np.asarray(jax.random.normal(k, (T, D), jnp.float64))
                       for k in keys])
        for method in ("parallel", "sequential"):
            draw = jax.jit(lambda k, m=method: jl.ffbs_sample(k, jp, ys,
                                                              method=m))
            want = np.stack([np.asarray(draw(k)) for k in keys])
            got = tl.ffbs_sample(None, tp, ys, method=method,
                                 z=torch.tensor(zs))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
            one = tl.ffbs_sample(None, tp, ys, method=method,
                                 z=torch.tensor(zs[0]))
            np.testing.assert_allclose(one.numpy(), want[0], rtol=0,
                                       atol=TOL)
        kern = jl.LGSSKernel(ys, jp)
        step = jax.jit(lambda k: kern.step(k, jnp.zeros(T * D), {}))
        want = np.stack([np.asarray(step(k)) for k in keys])
    got = tl.LGSSKernel(ys, tp).apply(torch.tensor(zs),
                                      torch.zeros((3, T * D), dtype=F64), {})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_structural_components_match_jax():
    with jax.enable_x64(True):
        jc = [jl.local_level(0.3, jnp.float64),
              jl.local_linear_trend(0.5, 0.1, jnp.float64),
              jl.seasonal(4, 0.2, jnp.float64),
              jl.autoregressive(0.6, 0.4, jnp.float64)]
        want = jl.structural(jc, 0.7, m0=1.0, p0_scale=10.0,
                             dtype=jnp.float64)
    tc = [tl.local_level(0.3, F64, "cpu"),
          tl.local_linear_trend(0.5, 0.1, F64, "cpu"),
          tl.seasonal(4, 0.2, F64, "cpu"), tl.autoregressive(0.6, 0.4, F64,
                                                             "cpu")]
    got = tl.structural(tc, 0.7, m0=1.0, p0_scale=10.0, dtype=F64)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=0)
    with pytest.raises(ValueError, match="n_seasons"):
        tl.seasonal(1, device="cpu")
    with pytest.raises(ValueError, match="component"):
        tl.structural([], 1.0)


def test_parallel_equals_sequential_float32_and_nan_cholesky():
    t_n = 64
    rng = np.random.default_rng(2)
    comp = [tl.local_linear_trend(0.3, 0.05, device="cpu"),
            tl.seasonal(7, 0.1, device="cpu")]
    p = tl.structural(comp, 0.5, p0_scale=100.0)
    ys = np.cumsum(rng.standard_normal(t_n)).astype(np.float32)
    ys[rng.random(t_n) < 0.1] = np.nan
    par = tl.kalman_filter(p, ys)
    seq = tl.kalman_filter(p, ys, method="sequential")
    scale = float(torch.abs(seq.means).max())
    np.testing.assert_allclose(par.means.numpy(), seq.means.numpy(), rtol=0,
                               atol=1e-4 * scale)
    assert float(par.loglik) == pytest.approx(float(seq.loglik), rel=1e-3)
    # a non-PD innovation covariance: NaN, as JAX's Cholesky gives
    bad = p._replace(R=-torch.ones((1, 1)) * 1e4)
    for method in ("parallel", "sequential"):
        assert not np.isfinite(float(tl.lgss_loglik(bad, ys, method=method)))
    with pytest.raises(ValueError, match="method"):
        tl.kalman_filter(p, ys, method="fast")
    with pytest.raises(ValueError, match="initial"):
        tl.kalman_filter(p, ys, initial="zero")
    with pytest.raises(ValueError, match="mask"):
        tl.kalman_filter(p, ys, mask=np.ones(3, bool))


def test_sequential_float32_stays_near_float64_on_a_diffuse_prior():
    """A repair: the reference's sequential filter does not symmetrize the
    filtered covariance, and in float32 on a diffuse structural model
    (trend + weekly season, P0 = 100 I, T = 1024) its means end 2.5% of the
    state scale off float64 (JAX, measured here). The port symmetrizes each
    step and stays within 1e-3 (like the parallel filter)."""
    t_n = 1024
    rng = np.random.default_rng(1301)

    def comps(lib, dtype):
        kw = {"dtype": dtype} if lib is jl else {"dtype": dtype,
                                                  "device": "cpu"}
        return [lib.local_linear_trend(0.05, 1e-5, **kw),
                lib.seasonal(7, 0.02, **kw)]

    p64 = tl.structural(comps(tl, F64), 0.5, p0_scale=100.0, dtype=F64)
    a, q, h = (p64.A.numpy(), p64.Q.numpy(), p64.H.numpy())
    noise = rng.standard_normal((t_n, 8)) @ np.linalg.cholesky(
        q + 1e-12 * np.eye(8)).T
    x = np.zeros((t_n, 8))
    for t in range(1, t_n):
        x[t] = a @ x[t - 1] + noise[t]
    y = (x @ h.T)[:, 0] + 0.5 * rng.standard_normal(t_n)
    ref = tl.kalman_filter(p64, y)
    scale = float(ref.means.abs().max())
    p32 = tl.structural(comps(tl, torch.float32), 0.5, p0_scale=100.0)
    for method in ("sequential", "parallel"):
        got = tl.kalman_filter(p32, y.astype(np.float32), method=method)
        err = float((got.means.double() - ref.means).abs().max()) / scale
        assert err < 1e-3, (method, err)
        assert float(got.loglik) == pytest.approx(float(ref.loglik),
                                                  rel=1e-5)
    jseq = KALMAN(jl.structural(comps(jl, jnp.float32), 0.5, p0_scale=100.0),
                  y.astype(np.float32), method="sequential")
    jerr = float(np.abs(np.asarray(jseq.means, np.float64)
                        - ref.means.numpy()).max()) / scale
    assert jerr > 1e-2, jerr  # the reference's drift, which the port fixes


def test_ffbs_moments_match_smoother():
    raw = _raw()
    ys = _ys()
    p = tl.lgss_params(*raw, dtype=F64, device="cpu")
    f = tl.kalman_filter(p, ys)
    n = 4000
    draws = tl.ffbs_sample(torch.Generator().manual_seed(1), p, filtered=f,
                           z=torch.randn((n, T, D), dtype=F64,
                                         generator=torch.Generator()
                                         .manual_seed(1))).numpy()
    means, covs = tl.rts_smoother(p, ys, filtered=f)
    covs = covs.numpy()
    np.testing.assert_allclose(draws.mean(0), means.numpy(),
                               atol=4.5 * np.sqrt(covs.max() / n) + 1e-3)
    np.testing.assert_allclose(draws.var(0), np.stack(
        [np.diag(c) for c in covs]), rtol=0.15, atol=5e-3)
    seq = tl.ffbs_sample(torch.Generator().manual_seed(2), p, filtered=f,
                         method="sequential")
    assert tuple(seq.shape) == (T, D) and torch.isfinite(seq).all()


def test_kernel_in_blocked_gibbs_conjugate_local_level():
    rng = np.random.default_rng(11)
    t_n, sig_q, sig_r = 60, 0.25, 0.7
    x_true = np.cumsum(rng.normal(0, sig_q, t_n)) + 1.0
    ys = (x_true + rng.normal(0, sig_r, t_n)).astype(np.float32)
    a0, b0 = 2.0, 1.0
    ys_t = torch.tensor(ys)

    def params_fn(others):
        return tl.lgss_params(A=1.0, b=0.0, Q=sig_q ** 2, H=1.0, c=0.0,
                              R=others["s2r"][0], m0=1.0, P0=4.0,
                              device="cpu")

    def sample_s2r(gen, others):
        b_n = b0 + 0.5 * torch.sum((ys_t - others["x"]) ** 2, -1,
                                   keepdim=True)
        return b_n / torch._standard_gamma(torch.full_like(b_n, a0 + 0.5
                                                           * t_n),
                                           generator=gen)

    gb = mt.BlockedGibbsSampler(
        [("x", t_n, tl.LGSSKernel(ys, params_fn)),
         ("s2r", 1, mt.ExactGibbsKernel(sample_s2r, batched=True))],
        n_chains=8, seed=0, device="cpu")
    gb.init({"x": np.zeros(t_n, np.float32), "s2r": np.ones(1, np.float32)})
    gb.run(400)
    s2r = gb.get_block("s2r")[100:].reshape(-1)
    x_draws = gb.get_block("x")[100:]
    assert 0.2 < s2r.mean() < 1.2, s2r.mean()
    assert np.sqrt(((x_draws.mean((0, 1)) - x_true) ** 2).mean()) < sig_r
