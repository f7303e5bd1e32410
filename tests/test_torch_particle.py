"""The port's particle filters, PMMH and PGAS held against the JAX package.

- Replays in float64: the bootstrap, auxiliary and guided filters, one
  PMMH step (C = 3 chains) and one ``ParticleGibbsKernel`` update, each fed
  the JAX package's own draws, re-derived from its keys exactly as
  ``mcmcpp_tpu/particle.py`` splits them (through test hooks that hand the
  port JAX's normals, the resampling uniforms as ``resample_u``, the
  categorical draws as Gumbel noise). The log-likelihood to 1e-9, states
  and trajectories to 1e-9.
- The statistical oracles of ``tests/test_particle.py`` at its bounds:
  unbiasedness against the Kalman evidence (bootstrap and auxiliary), the
  filtered means, ESS bounds, the fully adapted filter's variance
  collapse, PMMH against the exact grid posterior, PGAS against the RTS
  smoother, the smoother and the forecast against the exact moments, the
  stochastic-volatility smoke test; and the PF score against the exact
  Kalman score (``tests/test_smc2.py:314``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import particle as jp
from mcmcpp_tpu.models import lgss as jl
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import particle as tp
from mcmcpp_tpu_torch.models import lgss as tl

torch.set_num_threads(1)

REPLAY_TOL = 1e-9
SIG_Q, SIG_R, M0, P0 = 0.35, 0.6, 1.0, 2.0
LOG2PI = np.log(2 * np.pi)
F64 = torch.float64


def _data(t_n, seed=0, sig_q=SIG_Q, sig_r=SIG_R):
    rng = np.random.default_rng(seed)
    x = np.empty(t_n)
    x[0] = M0 + np.sqrt(P0) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = x[t - 1] + sig_q * rng.standard_normal()
    return x, (x + sig_r * rng.standard_normal(t_n)).astype(np.float32)


def _jax_ssm(sig_r=SIG_R):
    def init_sample(key, n, theta):
        return M0 + jnp.sqrt(P0) * jax.random.normal(key, (n, 1))

    def trans_sample(key, x, t, theta):
        return x + SIG_Q * jax.random.normal(key, x.shape)

    def obs_logpdf(y, x, t, theta):
        s = jnp.exp(theta[0]) if sig_r is None else sig_r
        z = (y[0] - x[:, 0]) / s
        return -0.5 * z * z - jnp.log(s) - 0.5 * LOG2PI

    def trans_logpdf(x_next, x, t, theta):
        z = (x_next[:, 0] - x[:, 0]) / SIG_Q
        return -0.5 * z * z - np.log(SIG_Q) - 0.5 * LOG2PI

    return jp.StateSpaceModel(init_sample, trans_sample, obs_logpdf,
                              trans_logpdf)


def _torch_ssm(sig_r=SIG_R, sig_q=SIG_Q, lead=()):
    """The local level's hooks. They broadcast over leading axes, so with
    ``lead=(C,)`` (the initial draw's batch) they also serve C filters at
    once with ``batched=True`` (θ (C, 1), particles (C, n, 1))."""
    def init_sample(gen, n, theta):
        return M0 + np.sqrt(P0) * torch.randn(lead + (n, 1), generator=gen,
                                              device=gen.device)

    def trans_sample(gen, x, t, theta):
        return x + sig_q * torch.randn(x.shape, generator=gen,
                                       dtype=x.dtype, device=x.device)

    def obs_logpdf(y, x, t, theta):
        log_s = theta[..., :1] if sig_r is None else np.log(sig_r)
        z = (y[0] - x[..., 0]) / (torch.exp(log_s) if sig_r is None
                                  else sig_r)
        return -0.5 * z * z - log_s - 0.5 * LOG2PI

    def trans_logpdf(x_next, x, t, theta):
        z = (x_next[..., 0] - x[..., 0]) / sig_q
        return -0.5 * z * z - np.log(sig_q) - 0.5 * LOG2PI

    return tp.StateSpaceModel(init_sample, trans_sample, obs_logpdf,
                              trans_logpdf)


def _lgss_j(sig_r=SIG_R, dtype=jnp.float32):
    return jl.lgss_params(A=1.0, b=0.0, Q=SIG_Q ** 2, H=1.0, c=0.0,
                          R=sig_r ** 2, m0=M0, P0=P0, dtype=dtype)


def _lgss_t(sig_r=SIG_R, dtype=F64):
    return tl.lgss_params(A=1.0, b=0.0, Q=SIG_Q ** 2, H=1.0, c=0.0,
                          R=sig_r ** 2, m0=M0, P0=P0, dtype=dtype,
                          device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_filter_draws(key, t_n, n):
    """What ``particle_filter`` draws from ``key`` (float64): the initial
    normals (n, 1), the resampling uniforms (T-1,) and each step's proposal
    normals (T-1, n, 1)."""
    k_init, k = jax.random.split(key)
    x0 = jax.random.normal(k_init, (n, 1))
    us, zs = [], []
    for _ in range(1, t_n):
        k, k_rs, k_prop = jax.random.split(k, 3)
        us.append(jax.random.uniform(k_rs, (), jnp.float64))
        zs.append(jax.random.normal(k_prop, (n, 1)))
    return np.asarray(x0), np.asarray(us), np.asarray(zs)


def _replay_ssm(x0, zs, noise_sd, prop_mean=None):
    """Torch hooks returning the JAX draws (``prop_mean`` makes the step a
    guided proposal's)."""
    base = _torch_ssm()

    def init_sample(gen, n, theta):
        return M0 + np.sqrt(P0) * _t(x0)

    def trans_sample(gen, x, t, theta):
        return x + noise_sd * _t(zs[t - 1])

    ssm = base._replace(init_sample=init_sample, trans_sample=trans_sample)
    if prop_mean is not None:
        ssm = ssm._replace(prop_sample=lambda gen, x, y, t, th: prop_mean(
            x, y) + noise_sd * _t(zs[t - 1]))
    return ssm


# the fully adapted model of tests/test_particle.py::
# test_fully_adapted_apf_collapses_variance
FA_SIG_R = 0.3
FA_Q, FA_R = SIG_Q ** 2, FA_SIG_R ** 2
FA_PREC = 1.0 / FA_Q + 1.0 / FA_R
FA_POST_SD, FA_PRED_SD = np.sqrt(1.0 / FA_PREC), np.sqrt(FA_Q + FA_R)


def _fa_hooks(lib):
    def prop_mean(x, y):
        return (x / FA_Q + y[0] / FA_R) / FA_PREC

    def prop_logpdf(xn, xp, y, t, th):
        z = (xn[:, 0] - prop_mean(xp[:, 0], y)) / FA_POST_SD
        return -0.5 * z * z - np.log(FA_POST_SD) - 0.5 * LOG2PI

    def lookahead_logpdf(y, xp, t, th):
        z = (y[0] - xp[:, 0]) / FA_PRED_SD
        return -0.5 * z * z - np.log(FA_PRED_SD) - 0.5 * LOG2PI

    return prop_mean, prop_logpdf, lookahead_logpdf


@pytest.mark.parametrize("mode", ["bootstrap", "auxiliary", "guided"])
def test_filter_replays_jax_draws_float64(mode):
    t_n, n = 20, 64
    sig_r = FA_SIG_R if mode == "guided" else SIG_R
    _, ys = _data(t_n, seed=3, sig_r=sig_r)
    key = jax.random.key(7)
    with jax.enable_x64(True):
        jssm = _jax_ssm(sig_r)
        prop_mean, prop_logpdf, look = _fa_hooks(jnp)
        sd = SIG_Q
        if mode == "auxiliary":
            jssm = jssm._replace(trans_mean=lambda x, t, th: x)
        if mode == "guided":
            jssm = jssm._replace(
                prop_sample=lambda k, x, y, t, th: prop_mean(x, y)
                + FA_POST_SD * jax.random.normal(k, x.shape),
                prop_logpdf=prop_logpdf, lookahead_logpdf=look)
            sd = FA_POST_SD
        res_j = jp.particle_filter(key, jssm, None, jnp.asarray(ys, jnp.float64),
                                   n, auxiliary=mode != "bootstrap")
        x0, us, zs = jax_filter_draws(key, t_n, n)
    tssm = _replay_ssm(x0, zs, sd, prop_mean if mode == "guided" else None)
    tssm = tssm._replace(obs_logpdf=_torch_ssm(sig_r).obs_logpdf)
    if mode == "auxiliary":
        tssm = tssm._replace(trans_mean=lambda x, t, th: x)
    if mode == "guided":
        tssm = tssm._replace(prop_logpdf=prop_logpdf, lookahead_logpdf=look)
    res_t = tp.particle_filter(torch.Generator(), tssm, None,
                               _t(ys.astype(np.float64)), n,
                               auxiliary=mode != "bootstrap",
                               resample_u=_t(us))
    assert abs(float(res_j.loglik) - float(res_t.loglik)) < REPLAY_TOL
    np.testing.assert_allclose(res_t.filter_means.numpy(),
                               np.asarray(res_j.filter_means), rtol=0,
                               atol=REPLAY_TOL)
    np.testing.assert_allclose(res_t.ess.numpy(), np.asarray(res_j.ess),
                               rtol=1e-9)


def test_pmmh_step_replays_jax_float64():
    t_n, n, c = 12, 16, 3
    _, ys = _data(t_n, seed=11)
    ys64 = ys.astype(np.float64)
    key = jax.random.key(5)
    with jax.enable_x64(True):
        js = jp.PMMHSampler(_jax_ssm(None), ys64, lambda th: -0.5 * th[0] ** 2,
                            1, n_particles=n, proposal_scale=0.4,
                            n_chains=c, dtype=jnp.float64)
        js.init(np.array([[0.0], [-0.5], [0.3]]))
        state0 = js.state
        new_j = js._step(key, state0, js._prop_chol)
        k_prop, k_pf, k_u = jax.random.split(key, 3)
        z = np.asarray(jax.random.normal(k_prop, (c, 1), jnp.float64))
        u = np.asarray(jax.random.uniform(k_u, (c,), jnp.float64,
                                          minval=1e-37))
        draws = [jax_filter_draws(k, t_n, n)
                 for k in jax.random.split(k_pf, c)]
    x0 = np.stack([d[0] for d in draws])             # (C, n, 1)
    us = np.stack([d[1] for d in draws], 1)          # (T-1, C)
    zs = np.stack([d[2] for d in draws], 1)          # (T-1, C, n, 1)

    def init_sample(gen, n_, theta):
        return M0 + np.sqrt(P0) * _t(x0)

    def trans_sample(gen, x, t, theta):
        return x + SIG_Q * _t(zs[t - 1])

    def obs_logpdf(y, x, t, theta):
        s = torch.exp(theta[:, :1])
        zz = (y[0] - x[..., 0]) / s
        return -0.5 * zz * zz - torch.log(s) - 0.5 * LOG2PI

    ssm = tp.StateSpaceModel(init_sample, trans_sample, obs_logpdf)
    ts = tp.PMMHSampler(ssm, ys64, lambda th: -0.5 * th[:, 0] ** 2, 1,
                        n_particles=n, proposal_scale=0.4, n_chains=c,
                        dtype=F64, batched=True, device="cpu")
    start = tp.PMMHState(*(_t(np.asarray(a)) for a in state0))
    new_t = ts.step(start, ts._prop_chol, z=_t(z), u=_t(u),
                    resample_u=_t(us))
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=REPLAY_TOL)


def test_pgas_update_replays_jax_float64():
    t_n, n, c = 10, 6, 2
    _, ys = _data(t_n, seed=31)
    ys64 = ys.astype(np.float64)
    rng = np.random.default_rng(1)
    x_ref = rng.normal(size=(c, t_n))
    keys = jax.random.split(jax.random.key(9), c)
    with jax.enable_x64(True):
        kern = jp.ParticleGibbsKernel(_jax_ssm(SIG_R), ys64, n_particles=n)
        want = np.stack([np.asarray(kern.step(k, jnp.asarray(x), {}))
                         for k, x in zip(keys, x_ref)])
        x0s, zs, gumbels = [], [], []
        for k in keys:
            k_init, k_scan, k_pick = jax.random.split(k, 3)
            x0s.append(np.asarray(jax.random.normal(k_init, (n, 1))))
            seq, zc = [], []
            for _ in range(1, t_n):
                k_scan, k_a, k_as, k_p = jax.random.split(k_scan, 4)
                seq += [np.asarray(jax.random.gumbel(k_a, (n, n))),
                        np.asarray(jax.random.gumbel(k_as, (n,)))]
                zc.append(np.asarray(jax.random.normal(k_p, (n, 1))))
            seq.append(np.asarray(jax.random.gumbel(k_pick, (n,))))
            gumbels.append(seq)
            zs.append(np.stack(zc))
    x0s, zs = np.stack(x0s), np.stack(zs)            # (C, n, 1), (C, T-1,..)
    pops = [_t(np.stack([g[i] for g in gumbels]))
            for i in range(len(gumbels[0]))]

    def gumbel(shape):
        g = pops.pop(0)
        assert tuple(g.shape) == tuple(shape)
        return g

    base = _torch_ssm(SIG_R)

    def obs_logpdf(y, x, t, theta):
        zz = (y[0] - x[..., 0]) / SIG_R
        return -0.5 * zz * zz - np.log(SIG_R) - 0.5 * LOG2PI

    def trans_logpdf(xn, x, t, theta):
        zz = (xn[..., 0] - x[..., 0]) / SIG_Q
        return -0.5 * zz * zz - np.log(SIG_Q) - 0.5 * LOG2PI

    ssm = base._replace(
        init_sample=lambda gen, n_, th: M0 + np.sqrt(P0) * _t(x0s),
        trans_sample=lambda gen, x, t, th: x + SIG_Q * _t(zs[:, t - 1]),
        obs_logpdf=obs_logpdf, trans_logpdf=trans_logpdf)
    kt = tp.ParticleGibbsKernel(ssm, ys64, n_particles=n, batched=True)
    got = kt.apply((None, gumbel), _t(x_ref), {})
    assert not pops
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REPLAY_TOL)


def _batched_logliks(ssm, ys, n, reps, seed, **kw):
    """``reps`` independent filters as one batch (the PMMH path)."""
    gen = torch.Generator().manual_seed(seed)
    hooks = tp.Hooks(ssm, None, (reps,), theta_dim=None)
    return tp.run_filter(gen, hooks, tp.as_series(ys), n, **kw).loglik


def test_pf_loglik_unbiased_vs_kalman():
    _, ys = _data(30)
    exact = float(jl.lgss_loglik(_lgss_j(), ys, method="sequential"))
    reps = 128
    lls = _batched_logliks(_torch_ssm(), ys, 256, reps, 42).double().numpy()
    assert np.isfinite(lls).all()
    ratio = np.exp(lls - exact)
    se = ratio.std(ddof=1) / np.sqrt(reps)
    assert abs(ratio.mean() - 1.0) < max(4.0 * se, 0.05), (ratio.mean(), se)
    assert lls.mean() < exact + 0.1


def test_pf_filtered_means_ess_and_no_resample_mode():
    _, ys = _data(40, seed=3)
    f = jl.kalman_filter(_lgss_j(), ys, method="sequential")
    res = mt.particle_filter(torch.Generator().manual_seed(7), _torch_ssm(),
                             None, ys, 8192)
    sd = np.sqrt(np.asarray(f.covs)[:, 0, 0])
    err = np.abs(res.filter_means.numpy()[:, 0] - np.asarray(f.means)[:, 0])
    assert (err < 8.0 * sd / np.sqrt(res.ess.numpy()) + 0.02).all(), \
        err.max()
    _, ys = _data(25, seed=5)
    res = mt.particle_filter(0, _torch_ssm(), None, ys, 128, device="cpu")
    ess = res.ess.numpy()
    assert (ess >= 1.0 - 1e-3).all() and (ess <= 128.0 + 1e-3).all()
    res0 = mt.particle_filter(0, _torch_ssm(), None, ys, 128, ess_frac=0.0,
                              device="cpu")
    assert np.isfinite(float(res0.loglik))
    assert res0.ess.numpy()[-1] <= ess[-1] + 1e-3


def test_apf_unbiased_and_fully_adapted_variance_collapse():
    sig_q, sig_r = 0.15, 0.5
    _, ys = _data(30, seed=4, sig_q=sig_q, sig_r=sig_r)
    exact = float(jl.lgss_loglik(jl.lgss_params(
        A=1.0, b=0.0, Q=sig_q ** 2, H=1.0, c=0.0, R=sig_r ** 2, m0=M0,
        P0=P0), ys, method="sequential"))
    ssm = _torch_ssm(sig_r, sig_q)._replace(trans_mean=lambda x, t, th: x)
    ll = _batched_logliks(ssm, ys, 128, 96, 11,
                          auxiliary=True).double().numpy()
    ratio = np.exp(ll - exact)
    se = ratio.std(ddof=1) / np.sqrt(96)
    assert abs(ratio.mean() - 1.0) < max(4.0 * se, 0.05), (ratio.mean(), se)

    _, ys = _data(40, seed=8, sig_r=FA_SIG_R)
    exact = float(jl.lgss_loglik(_lgss_j(FA_SIG_R), ys, method="sequential"))
    base = _torch_ssm(FA_SIG_R)
    prop_mean, prop_logpdf, look = _fa_hooks(torch)
    fa = base._replace(
        prop_sample=lambda g, x, y, t, th: prop_mean(x, y) + FA_POST_SD
        * torch.randn(x.shape, generator=g, dtype=x.dtype),
        prop_logpdf=prop_logpdf, lookahead_logpdf=look)
    ll_fa = _batched_logliks(fa, ys, 128, 64, 3,
                             auxiliary=True).double().numpy()
    ll_boot = _batched_logliks(base, ys, 128, 64, 3).double().numpy()
    assert ll_fa.var(ddof=1) < 0.3 * ll_boot.var(ddof=1)
    ratio = np.exp(ll_fa - exact)
    se = max(ratio.std(ddof=1) / np.sqrt(64), 1e-6)
    assert abs(ratio.mean() - 1.0) < max(4.0 * se, 0.02), (ratio.mean(), se)
    ll_g = _batched_logliks(fa._replace(lookahead_logpdf=None), ys, 128, 64,
                            3).double().numpy()
    assert ll_g.var(ddof=1) < 0.5 * ll_boot.var(ddof=1)


def test_filter_hook_validation_and_smoother_needs_trans_logpdf():
    _, ys = _data(10)
    with pytest.raises(ValueError, match="trans_mean"):
        mt.particle_filter(0, _torch_ssm(), None, ys, 32, auxiliary=True,
                           device="cpu")
    bad = _torch_ssm()._replace(prop_sample=lambda g, x, y, t, th: x)
    with pytest.raises(ValueError, match="prop_logpdf"):
        mt.particle_filter(0, bad, None, ys, 32, device="cpu")
    with pytest.raises(ValueError, match="trans_logpdf"):
        mt.particle_smoother(0, _torch_ssm()._replace(trans_logpdf=None),
                             None, ys, 32, 8, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        if not torch.cuda.is_available():
            mt.particle_filter(0, _torch_ssm(), None, ys, 32)


def _grid_posterior(ys):
    grid = np.linspace(-2.5, 1.5, 401)
    with jax.enable_x64(True):
        ll = np.asarray(jax.vmap(lambda th: jl.lgss_loglik(
            _lgss_j(jnp.exp(th), jnp.float64), jnp.asarray(ys, jnp.float64),
            method="sequential"))(
            jnp.asarray(grid)))
    logpost = ll - 0.5 * grid ** 2
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean = float(w @ grid)
    return mean, float(np.sqrt(w @ (grid - mean) ** 2))


def test_pmmh_matches_exact_grid_posterior_after_tune():
    """tests/test_particle.py's grid oracle, from the hopeless proposal
    scale 5.0 of its tune() test: tune() shrinks it, and the tuned chain
    hits the exact posterior at that test's bound. 64 chains for 100 kept
    steps give the JAX test's 4800 draws (16 chains, 300) in a third of the
    sequential steps; the hooks take the 64 filters as one batch."""
    _, ys = _data(40, seed=11)
    mean_true, sd_true = _grid_posterior(ys)
    c = 64
    s = mt.PMMHSampler(_torch_ssm(None, lead=(c,)), ys,
                       log_prior=lambda th: -0.5 * th[..., 0] ** 2,
                       n_params=1, n_particles=192, proposal_scale=5.0,
                       n_chains=c, seed=3, batched=True, device="cpu")
    s.init(np.zeros((c, 1), np.float32))
    s.tune(100, window=25)
    assert float(s._prop_chol[0, 0]) < 3.0
    assert s.run(125)
    acc = s.acceptance_fraction.mean()
    assert 0.08 < acc < 0.6, acc
    draws = s.get_samples(burn_in=50, flat=True)[:, 0]
    assert draws.size == 4800
    tol = 4.0 * sd_true / np.sqrt(draws.size / 20.0) + 0.05
    assert abs(draws.mean() - mean_true) < tol, (draws.mean(), mean_true)
    assert 0.5 * sd_true < draws.std() < 1.8 * sd_true
    lp = s.get_log_probs(flat=True)
    assert lp.shape == (125 * c,) and np.isfinite(lp).all()


def test_pmmh_tune_zero_spread_window_does_not_collapse():
    _, ys = _data(20, seed=2)
    s = mt.PMMHSampler(_torch_ssm(None), ys,
                       log_prior=lambda th: -0.5 * th[0] * th[0], n_params=1,
                       n_particles=32, proposal_scale=1e4, n_chains=8,
                       device="cpu")
    s.init(np.zeros((8, 1), np.float32))
    s.tune(50, window=50)
    assert float(s._prop_chol[0, 0]) > 1.0


def test_pmmh_rejects_non_finite_likelihood():
    """A proposal whose filter gives NaN is rejected, never adopted."""
    _, ys = _data(10)

    def loglik_fn(gen, theta):
        return torch.where(theta[0] > 0.0, torch.full_like(theta[0], np.nan),
                           -0.5 * theta[0] ** 2)

    s = mt.PMMHSampler(None, None, lambda th: 0.0 * th[0], 1,
                       proposal_scale=2.0, n_chains=64, loglik_fn=loglik_fn,
                       device="cpu")
    s.init(np.full((64, 1), -1.0))
    s.run(30)
    assert (s.get_samples(flat=True) <= 0.0).all()
    assert s.acceptance_fraction.mean() > 0.05


def test_pgas_trajectories_match_smoother():
    """tests/test_particle.py's smoother oracle: 48 chains for 50 kept
    sweeps pool 2400 draws (the JAX test's 8 chains for 290: 2320), all
    chains' conditional filters one batch (batched hooks)."""
    t_n, c = 25, 48
    _, ys = _data(t_n, seed=17)
    means, covs = jl.rts_smoother(_lgss_j(), ys, method="sequential")
    means, sds = np.asarray(means)[:, 0], np.sqrt(np.asarray(covs)[:, 0, 0])
    gb = mt.BlockedGibbsSampler(
        [("x", t_n, mt.ParticleGibbsKernel(_torch_ssm(lead=(c,)), ys,
                                           n_particles=48, batched=True))],
        n_chains=c, seed=2, device="cpu")
    gb.init({"x": np.zeros(t_n, np.float32)})
    gb.run(70)
    pooled = gb.get_block("x")[20:].reshape(-1, t_n).astype(np.float64)
    tol = 5.0 * sds / np.sqrt(pooled.shape[0] / 5.0) + 0.02
    assert (np.abs(pooled.mean(0) - means) < tol).all()
    np.testing.assert_allclose(pooled.std(0), sds, rtol=0.35, atol=0.03)


def test_pgas_with_conjugate_hyper_block_and_plain_csmc():
    t_n = 40
    x_true, ys = _data(t_n, seed=23)
    a0, b0 = 2.0, 1.0
    ys_t = torch.as_tensor(ys)

    def sample_s2r(gen, others):
        resid = ys_t - others["x"]
        b_n = b0 + 0.5 * torch.sum(resid * resid, -1, keepdim=True)
        return b_n / torch._standard_gamma(
            torch.full_like(b_n, a0 + 0.5 * t_n), generator=gen)

    gb = mt.BlockedGibbsSampler(
        [("x", t_n, mt.ParticleGibbsKernel(
            _torch_ssm(None), ys, n_particles=48,
            theta_fn=lambda o: 0.5 * torch.log(o["s2r"]))),
         ("s2r", 1, mt.ExactGibbsKernel(sample_s2r, batched=True))],
        n_chains=32, seed=0, device="cpu")
    gb.init({"x": np.zeros(t_n, np.float32), "s2r": np.ones(1, np.float32)})
    gb.run(100)
    s2r = gb.get_block("s2r")[40:].reshape(-1)
    xs = gb.get_block("x")[40:]
    assert 0.1 < s2r.mean() < 1.2, s2r.mean()
    assert np.sqrt(((xs.mean((0, 1)) - x_true) ** 2).mean()) < SIG_R
    # plain conditional SMC (no ancestor sampling) still runs
    no_trans = _torch_ssm()._replace(trans_logpdf=None)
    with pytest.raises(ValueError, match="trans_logpdf"):
        mt.ParticleGibbsKernel(no_trans, ys)
    with pytest.raises(ValueError, match="n_particles"):
        mt.ParticleGibbsKernel(_torch_ssm(), ys, n_particles=1)
    k2 = mt.ParticleGibbsKernel(no_trans, ys, n_particles=8,
                                ancestor_sampling=False)
    gen = torch.Generator().manual_seed(4)
    x = torch.zeros((3, t_n))
    out = k2.apply(k2.draw_noise(gen, x, {}), x, {})
    assert out.shape == (3, t_n) and torch.isfinite(out).all()


def test_particle_smoother_and_forecast_match_exact():
    t_n = 25
    _, ys = _data(t_n, seed=29)
    means, covs = jl.rts_smoother(_lgss_j(), ys, method="sequential")
    means, sds = np.asarray(means)[:, 0], np.sqrt(np.asarray(covs)[:, 0, 0])
    res = mt.particle_smoother(torch.Generator().manual_seed(5),
                               _torch_ssm(), None, ys, n_particles=2048,
                               n_draws=512)
    traj = res.trajectories.numpy()[:, :, 0]
    assert traj.shape == (512, t_n)
    tol = 5.0 * sds / np.sqrt(64.0) + 0.02
    assert (np.abs(traj.mean(0) - means) < tol).all()
    np.testing.assert_allclose(traj.std(0), sds, rtol=0.4, atol=0.03)
    filt = mt.particle_filter(torch.Generator().manual_seed(5), _torch_ssm(),
                              None, ys, 2048)
    rmse_s = np.sqrt(((res.smoothed_means.numpy()[:, 0] - means) ** 2).mean())
    rmse_f = np.sqrt(((filt.filter_means.numpy()[:-1, 0] - means[:-1])
                      ** 2).mean())
    assert rmse_s < rmse_f

    t_n, h = 30, 5
    _, ys = _data(t_n, seed=19)
    gen = torch.Generator().manual_seed(0)
    res = mt.particle_filter(gen, _torch_ssm(), None, ys, 4096,
                             return_particles=True)
    xs, yd = mt.particle_forecast(
        gen, _torch_ssm(), None, res.particles[-1], res.log_weights[-1],
        t_n, h, obs_sample=lambda g, x, t, th: x + SIG_R * torch.randn(
            x.shape, generator=g))
    f_mean, f_cov, _, y_cov = jl.forecast(_lgss_j(), ys, horizon=h,
                                          method="sequential")
    f_sd = np.sqrt(np.asarray(f_cov)[:, 0, 0])
    xs = xs.numpy()[:, :, 0]
    assert xs.shape == (h, 4096)
    assert (np.abs(xs.mean(1) - np.asarray(f_mean)[:, 0])
            < 6.0 * f_sd / np.sqrt(1024.0) + 0.02).all()
    np.testing.assert_allclose(xs.std(1), f_sd, rtol=0.1)
    np.testing.assert_allclose(yd.numpy()[:, :, 0].std(1),
                               np.sqrt(np.asarray(y_cov)[:, 0, 0]), rtol=0.1)


def test_stochastic_volatility_smoke():
    rng = np.random.default_rng(9)
    t_n, mu, phi, sig = 120, -1.0, 0.95, 0.3
    x = np.empty(t_n)
    x[0] = mu + sig / np.sqrt(1 - phi ** 2) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = mu + phi * (x[t - 1] - mu) + sig * rng.standard_normal()
    ys = (np.exp(x / 2) * rng.standard_normal(t_n)).astype(np.float32)
    ssm = mt.StateSpaceModel(
        lambda g, n, th: mu + sig / np.sqrt(1 - phi ** 2) * torch.randn(
            (n, 1), generator=g),
        lambda g, xp, t, th: mu + phi * (xp - mu) + sig * torch.randn(
            xp.shape, generator=g),
        lambda y, xp, t, th: -0.5 * (xp[:, 0] + y[0] ** 2 * torch.exp(
            -xp[:, 0]) + LOG2PI))
    res = mt.particle_filter(torch.Generator().manual_seed(1), ssm, None, ys,
                             1024)
    assert np.isfinite(float(res.loglik))
    assert np.corrcoef(res.filter_means.numpy()[:, 0], x)[0, 1] > 0.5


def test_pf_score_matches_exact_kalman_score():
    """tests/test_smc2.py:314: the PF log-likelihood's autograd gradient in
    log σ_r (through the weights, not the resampling indices) against the
    exact Kalman score, at that test's bound."""
    _, ys = _data(30, seed=5)
    th0 = np.log(SIG_R)
    score_true = float(jax.grad(lambda th: jl.lgss_loglik(_lgss_j(
        jnp.exp(th)), ys, method="sequential"))(jnp.float32(th0)))
    theta = torch.full((32, 1), th0, dtype=torch.float32, requires_grad=True)
    hooks = tp.Hooks(_torch_ssm(None, lead=(32,)), theta, (32,),
                     batched=True)
    ll = tp.run_filter(torch.Generator().manual_seed(2), hooks,
                       tp.as_series(ys), 512).loglik
    (grad,) = torch.autograd.grad(ll.sum(), theta)
    g = grad.numpy()[:, 0].astype(np.float64)
    assert np.isfinite(g).all()
    se = g.std(ddof=1) / np.sqrt(32.0)
    assert abs(g.mean() - score_true) < max(
        6.0 * se, 0.15 * abs(score_true) + 0.3), (g.mean(), score_true, se)
