"""The port's Rao-Blackwellised filter and IF2 held against the JAX package.

- Replays in float64: one RBPF run on the 2-regime switching model (its
  regime draws handed over as JAX's Gumbel noise, its resampling uniforms
  as ``resample_u``): the log-likelihood, filtered means and regime
  probabilities to 1e-9; and two IF2 passes (the swarm's and every step's
  perturbation normals, the resampling uniforms, the hooks' normals): the
  swarm and the per-pass log-likelihoods to 1e-9.
- The oracles of ``tests/test_rbpf.py`` and ``tests/test_if2.py`` at their
  bounds: the single-regime filter and forecast against Kalman, the
  switching log-likelihood and regime probability against enumeration,
  the Rao-Blackwell variance ordering, state tracking, PMMH through
  ``loglik_fn`` against the exact grid, validation; IF2 against the
  Kalman MLE (swarm concentration, log-likelihood trace) and its shapes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu import StateSpaceModel as JStateSpaceModel
from mcmcpp_tpu import if2 as jif2
from mcmcpp_tpu import rbpf as jr
from mcmcpp_tpu.models import lgss as jl
from mcmcpp_tpu_torch import particle as tp

# the package exports the function if2 under the module's name
tif2_mod = importlib.import_module("mcmcpp_tpu_torch.if2")

torch.set_num_threads(1)

REPLAY_TOL = 1e-9
TRANS = np.array([[0.9, 0.1], [0.2, 0.8]], np.float32)
A_K = np.stack([np.eye(1), 0.6 * np.eye(1)]).astype(np.float32)
B_K = np.zeros((2, 1), np.float32)
Q_K = np.stack([0.1 * np.eye(1), 0.6 * np.eye(1)]).astype(np.float32)
H_K = np.stack([np.eye(1), np.eye(1)]).astype(np.float32)
C_K = np.zeros((2, 1), np.float32)
R_K = np.stack([0.25 * np.eye(1), 0.25 * np.eye(1)]).astype(np.float32)
M0, P0 = np.zeros(1, np.float32), 2.0 * np.eye(1, dtype=np.float32)
INIT = np.array([0.5, 0.5], np.float32)
PIECES = (TRANS, A_K, B_K, Q_K, H_K, C_K, R_K, M0, P0)


def _switch_model(k=2):
    if k == 1:
        return mt.switching_model(np.ones((1, 1), np.float32),
                                  *(a[:1] for a in PIECES[1:7]), M0, P0,
                                  device="cpu")
    return mt.switching_model(*PIECES, init_probs=INIT, device="cpu")


def _switch_data(t_n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 2)
    x = rng.normal(0.0, np.sqrt(2.0))
    ys, zs = [], []
    for t in range(t_n):
        if t > 0:
            z = rng.choice(2, p=TRANS[z])
            x = A_K[z, 0, 0] * x + np.sqrt(Q_K[z, 0, 0]) * rng.standard_normal()
        ys.append(x + 0.5 * rng.standard_normal())
        zs.append(z)
    return np.array(zs), np.asarray(ys, np.float32)


def _enum_truth(ys):
    """Exact log p(y) and P(z_T = 1 | y) over all 2^T regime paths, each
    through the port's time-varying Kalman filter in float64."""
    from scipy.special import logsumexp

    t_n = len(ys)
    terms, z_last = [], []
    for code in range(2 ** t_n):
        path = [(code >> t) & 1 for t in range(t_n)]
        lp = np.log(INIT[path[0]]) + sum(
            np.log(TRANS[path[t - 1], path[t]]) for t in range(1, t_n))
        p = mt.models.lgss.LGSSParams(*(torch.tensor(a[path], dtype=torch.float64)
                                        for a in (A_K, B_K, Q_K, H_K, C_K,
                                                  R_K)),
                                      torch.tensor(M0, dtype=torch.float64),
                                      torch.tensor(P0, dtype=torch.float64))
        terms.append(lp + float(mt.models.lgss.lgss_loglik(
            p, ys.astype(np.float64)[:, None])))
        z_last.append(path[-1])
    terms = np.asarray(terms)
    w = np.exp(terms - terms.max())
    w /= w.sum()
    return float(logsumexp(terms)), float(w[np.asarray(z_last) == 1].sum())


def test_rbpf_replays_jax_draws_float64():
    t_n, n = 15, 32
    _, ys = _switch_data(t_n, seed=4)
    f64 = [a.astype(np.float64) for a in PIECES]
    key = jax.random.key(3)
    with jax.enable_x64(True):
        jmodel = jr.switching_model(*f64, init_probs=INIT.astype(np.float64))
        want = jr.rao_blackwell_filter(key, jmodel, ys.astype(np.float64), n)
        k_init, k = jax.random.split(key)
        g0 = np.asarray(jax.random.gumbel(k_init, (n, 2), jnp.float64))
        us, gs = [], []
        for _ in range(1, t_n):
            k, k_rs, k_z = jax.random.split(k, 3)
            us.append(float(jax.random.uniform(k_rs, (), jnp.float64)))
            gs.append(np.asarray(jax.random.gumbel(k_z, (n, 2), jnp.float64)))
    model = mt.switching_model(*f64, init_probs=INIT.astype(np.float64),
                               dtype=torch.float64, device="cpu")
    log_init = torch.log(torch.tensor(INIT, dtype=torch.float64))
    log_trans = torch.log(torch.tensor(TRANS, dtype=torch.float64))
    model = model._replace(
        z_init_sample=lambda g, n_: torch.argmax(torch.tensor(g0) + log_init,
                                                 -1),
        z_trans_sample=lambda g, z, t: torch.argmax(
            torch.tensor(gs[t - 1]) + log_trans[z], -1))
    got = mt.rao_blackwell_filter(torch.Generator(), model,
                                  ys.astype(np.float64), n,
                                  resample_u=torch.tensor(us))
    assert abs(float(got.loglik) - float(want.loglik)) < REPLAY_TOL
    for a, b in ((got.x_means, want.x_means), (got.z_stats, want.z_stats),
                 (got.final_means, want.final_means),
                 (got.final_covs, want.final_covs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=REPLAY_TOL)


def test_single_regime_filter_and_forecast_match_kalman():
    rng = np.random.default_rng(3)
    ys = np.cumsum(rng.standard_normal(40)).astype(np.float32)
    model = _switch_model(k=1)
    res = mt.rao_blackwell_filter(0, model, ys, 64, device="cpu")
    lg = jl.lgss_params(A=1.0, b=0.0, Q=0.1, H=1.0, c=0.0, R=0.25, m0=0.0,
                        P0=2.0)
    assert float(res.loglik) == pytest.approx(float(jl.lgss_loglik(
        lg, ys, method="sequential")), abs=5e-3)
    assert res.ess.numpy() == pytest.approx(64.0, abs=1e-3)
    ys = ys[:30]
    res = mt.rao_blackwell_filter(0, model, ys, 32, device="cpu")
    ms, cs, zs = mt.rbpf_forecast(1, model, res.final_z, res.final_means,
                                  res.final_covs, res.final_log_weights, 30,
                                  4, device="cpu")
    f_m, f_c, _, _ = jl.forecast(lg, ys, horizon=4, method="sequential")
    np.testing.assert_allclose(ms.numpy(), np.asarray(f_m), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cs.numpy(), np.asarray(f_c), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(zs.numpy(), 1.0, atol=1e-6)


def test_switching_loglik_and_regimes_match_enumeration():
    _, ys = _switch_data(8, seed=5)
    logz, p_last1 = _enum_truth(ys)
    gen = torch.Generator().manual_seed(1)
    runs = [mt.rao_blackwell_filter(gen, _switch_model(), ys, 1024)
            for _ in range(16)]
    lls = np.array([float(r.loglik) for r in runs])
    assert abs(lls.mean() - logz) < 0.05, (lls.mean(), logz)
    assert lls.std() < 0.1
    p1 = np.mean([r.z_stats.numpy()[-1, 1] for r in runs])
    assert abs(p1 - p_last1) < 0.05, (p1, p_last1)


def test_rao_blackwell_variance_below_plain_pf_and_tracking():
    _, ys = _switch_data(30, seed=9)
    log_init = torch.log(torch.tensor(INIT))
    log_trans = torch.log(torch.tensor(TRANS))
    a_k, q_k = torch.tensor(A_K[:, 0, 0]), torch.tensor(Q_K[:, 0, 0])

    def gumbel(g, shape):
        return -torch.log(-torch.log(torch.rand(shape, generator=g)))

    def init_sample(g, n, th):
        z = torch.argmax(gumbel(g, (n, 2)) + log_init, -1).float()
        x = np.sqrt(2.0) * torch.randn((n,), generator=g)
        return torch.stack([z, x], 1)

    def trans_sample(g, zx, t, th):
        z = torch.argmax(gumbel(g, (zx.shape[0], 2))
                         + log_trans[zx[:, 0].long()], -1)
        x = a_k[z] * zx[:, 1] + torch.sqrt(q_k[z]) * torch.randn(
            (zx.shape[0],), generator=g)
        return torch.stack([z.float(), x], 1)

    def obs_logpdf(y, zx, t, th):
        zc = y[0] - zx[:, 1]
        return -0.5 * zc * zc / 0.25 - 0.5 * np.log(2.0 * np.pi * 0.25)

    gen = torch.Generator().manual_seed(7)
    ll_rb = np.array([float(mt.rao_blackwell_filter(
        gen, _switch_model(), ys, 128).loglik) for _ in range(48)])
    ll_pf = tp.run_filter(
        gen, tp.Hooks(mt.StateSpaceModel(init_sample, trans_sample,
                                         obs_logpdf), None, (48,),
                      theta_dim=None),
        tp.as_series(ys), 128, stats=False).loglik.double().numpy()
    assert ll_rb.var(ddof=1) < 0.5 * ll_pf.var(ddof=1)
    assert abs(ll_rb.mean() - ll_pf.mean()) < max(
        4.0 * ll_pf.std(ddof=1) / np.sqrt(48.0), 0.2)

    _, ys = _switch_data(60, seed=13)
    res = mt.rao_blackwell_filter(2, _switch_model(), ys, 512, device="cpu")
    assert np.abs(res.x_means.numpy()[:, 0] - ys).mean() < 1.0
    probs = res.z_stats.numpy()
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)
    # the switching forecast: variance grows, regimes drift to (2/3, 1/3)
    _, ys = _switch_data(40, seed=7)
    res = mt.rao_blackwell_filter(0, _switch_model(), ys, 1024, device="cpu")
    ms, cs, zs = mt.rbpf_forecast(1, _switch_model(), res.final_z,
                                  res.final_means, res.final_covs,
                                  res.final_log_weights, 40, 12,
                                  device="cpu")
    v = cs.numpy()[:, 0, 0]
    assert v[-1] > v[0]
    np.testing.assert_allclose(zs.numpy()[-1], [2 / 3, 1 / 3], atol=0.08)


def test_pmmh_with_exact_loglik_matches_grid_and_validation():
    """tests/test_rbpf.py: PMMH's ``loglik_fn`` override with the exact
    Kalman likelihood (a batched scalar Kalman filter here) is plain MH on
    the hyperparameter posterior and hits the dense grid."""
    rng = np.random.default_rng(0)
    x = np.cumsum(0.35 * rng.standard_normal(50)) + 1.0
    ys = (x + 0.6 * rng.standard_normal(50)).astype(np.float32)
    grid = np.linspace(-2.5, 1.5, 401)
    ll = np.asarray(jax.vmap(lambda g: jl.lgss_loglik(jl.lgss_params(
        A=1.0, b=0.0, Q=0.35 ** 2, H=1.0, c=0.0, R=jnp.exp(2.0 * g), m0=1.0,
        P0=2.0), ys, method="sequential"))(jnp.asarray(grid, jnp.float32)),
        np.float64)
    logpost = ll - 0.5 * grid ** 2
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean_true = float(w @ grid)
    sd_true = float(np.sqrt(w @ (grid - mean_true) ** 2))
    yt = torch.tensor(ys)

    def exact_ll(gen, th):
        r = torch.exp(2.0 * th[:, 0])
        m, p = torch.ones_like(r), 2.0 * torch.ones_like(r)
        total = torch.zeros_like(r)
        for t in range(len(ys)):
            if t:
                p = p + 0.35 ** 2
            s = p + r
            total = total - 0.5 * (np.log(2 * np.pi) + torch.log(s)
                                   + (yt[t] - m) ** 2 / s)
            m, p = m + p / s * (yt[t] - m), p - p * p / s
        return total

    s = mt.PMMHSampler(None, None, lambda th: -0.5 * th[:, 0] ** 2, 1,
                       proposal_scale=0.3, n_chains=16, seed=1,
                       loglik_fn=exact_ll, batched=True, device="cpu")
    s.init(np.zeros((16, 1), np.float32))
    s.run(400)
    draws = s.get_samples(burn_in=100, flat=True)[:, 0]
    tol = 4.0 * sd_true / np.sqrt(draws.size / 15.0) + 0.05
    assert abs(draws.mean() - mean_true) < tol
    assert 0.6 * sd_true < draws.std() < 1.6 * sd_true
    with pytest.raises(ValueError, match="trans_probs"):
        mt.switching_model(np.ones((2, 3)), *PIECES[1:], device="cpu")
    with pytest.raises(ValueError, match="regime slices"):
        mt.switching_model(TRANS, A_K[:1], *PIECES[2:], device="cpu")
    with pytest.raises(ValueError, match="ssm or a loglik_fn"):
        mt.PMMHSampler(ssm=None, ys=None, log_prior=lambda th: 0.0,
                       n_params=1, device="cpu")


# -- IF2 (tests/test_if2.py) ---------------------------------------------------

A_TRUE, Q_TRUE, LOG_SR_TRUE = 0.8, 0.3, np.log(0.5)
SQ = np.float32(np.sqrt(Q_TRUE))
C0 = 0.5 * np.log(2 * np.pi)


def _if2_data(t_n=150):
    rng = np.random.default_rng(7)
    x, ys = 0.0, np.empty(t_n, np.float32)
    for t in range(t_n):
        x = A_TRUE * x + np.sqrt(Q_TRUE) * rng.standard_normal()
        ys[t] = x + np.exp(LOG_SR_TRUE) * rng.standard_normal()
    return ys


def _if2_obs(lib):
    return lambda y, x, t, th: (-0.5 * ((y[0] - x[:, 0]) / lib.exp(th[:, 1]))
                                ** 2 - th[:, 1] - C0)


def _if2_ssm():
    return mt.StateSpaceModel(
        init_sample=lambda g, n, th: SQ * torch.randn((n, 1), generator=g),
        trans_sample=lambda g, x, t, th: th[:, 0:1] * x + SQ * torch.randn(
            x.shape, generator=g),
        obs_logpdf=_if2_obs(torch))


def test_if2_replays_jax_passes_float64():
    ys = _if2_data(12).astype(np.float64)
    n, p, iters = 24, 2, 2
    theta0, sigma0 = np.array([0.5, 0.0]), np.array([0.05, 0.08])
    key = jax.random.key(4)
    with jax.enable_x64(True):
        jssm = JStateSpaceModel(
            init_sample=lambda k, n_, th: SQ * jax.random.normal(k, (n_, 1)),
            trans_sample=lambda k, x, t, th: th[:, 0:1] * x
            + SQ * jax.random.normal(k, x.shape),
            obs_logpdf=_if2_obs(jnp))
        want = jif2(key, jssm, ys, n, theta0, sigma0, n_iters=iters)
        k_swarm, k = jax.random.split(key)
        swarm0 = np.asarray(jax.random.normal(k_swarm, (n, p), jnp.float64))
        passes = []
        for _ in range(iters):
            k, k_pass = jax.random.split(k)
            k_init, k_p0, k_scan = jax.random.split(k_pass, 3)
            rec = {"x0": np.asarray(jax.random.normal(k_init, (n, 1))),
                   "p0": np.asarray(jax.random.normal(k_p0, (n, p),
                                                      jnp.float64)),
                   "us": [], "pert": [], "zs": []}
            for _ in range(1, len(ys)):
                k_scan, k_rs, k_th, k_x = jax.random.split(k_scan, 4)
                rec["us"].append(float(jax.random.uniform(k_rs, (),
                                                          jnp.float64)))
                rec["pert"].append(np.asarray(jax.random.normal(
                    k_th, (n, p), jnp.float64)))
                rec["zs"].append(np.asarray(jax.random.normal(k_x, (n, 1))))
            rec["u_last"] = float(jax.random.uniform(
                jax.random.fold_in(k_pass, 0x1F2), (), jnp.float64))
            passes.append(rec)
    swarm = torch.tensor(theta0 + sigma0 * swarm0)
    sig0 = torch.tensor(sigma0)
    yt = torch.tensor(ys)[:, None]
    lls = []
    for m, rec in enumerate(passes):
        ssm = mt.StateSpaceModel(
            init_sample=lambda g, n_, th, r=rec: SQ * torch.tensor(r["x0"]),
            trans_sample=lambda g, x, t, th, r=rec: th[:, 0:1] * x
            + SQ * torch.tensor(r["zs"][t - 1]),
            obs_logpdf=_if2_obs(torch))
        noise = (torch.tensor(rec["p0"]), torch.tensor(rec["us"]),
                 torch.tensor(np.stack(rec["pert"])),
                 torch.tensor(rec["u_last"]))
        swarm, ll = tif2_mod.one_pass(None, ssm, yt, swarm,
                                      sig0 * 0.9 ** (m + 1), noise=noise)
        lls.append(float(ll))
    np.testing.assert_allclose(swarm.numpy(), np.asarray(want.swarm), rtol=0,
                               atol=REPLAY_TOL)
    np.testing.assert_allclose(lls, np.asarray(want.loglik_trace), rtol=0,
                               atol=REPLAY_TOL)


def test_if2_recovers_the_kalman_mle():
    """tests/test_if2.py's oracle (2000 particles, 40 passes, T = 150) at its
    bounds, and the shapes test."""
    from scipy.optimize import minimize

    ys = _if2_data()
    loglik = jax.jit(lambda a, log_sr: jl.lgss_loglik(jl.lgss_params(
        A=a, b=0.0, Q=Q_TRUE, H=1.0, c=0.0, R=jnp.exp(2 * log_sr), m0=0.0,
        P0=0.0), ys, method="sequential", initial="prior"))

    def exact(theta):
        return float(loglik(float(theta[0]), float(theta[1])))

    res = minimize(lambda th: -exact(th), x0=[0.5, 0.0], method="Nelder-Mead",
                   options={"xatol": 1e-5, "fatol": 1e-8})
    mle = res.x
    fit = mt.if2(0, _if2_ssm(), ys, n_particles=2000,
                 theta0=np.array([0.5, 0.0], np.float32), sigma0=0.05,
                 n_iters=40, cooling=0.9, device="cpu")
    est = fit.theta.numpy()
    assert abs(est[0] - mle[0]) < 0.05, (est, mle)
    assert abs(est[1] - mle[1]) < 0.10, (est, mle)
    assert np.linalg.norm(est - mle) < 0.3 * np.linalg.norm(
        np.array([0.5, 0.0]) - mle)
    sd = fit.theta_sd_trace.numpy()
    assert (sd[-1] < sd[0] / 5.0).all()
    ll = fit.loglik_trace.numpy()
    assert ll[-5:].mean() > ll[0] + 1.0
    assert ll[-5:].mean() == pytest.approx(exact(mle), abs=3.0)

    r = mt.if2(1, _if2_ssm(), ys[:40], n_particles=256,
               theta0=np.array([0.5, 0.0], np.float32), sigma0=[0.05, 0.08],
               n_iters=3, device="cpu")
    assert tuple(r.theta.shape) == (2,) and tuple(r.swarm.shape) == (256, 2)
    assert tuple(r.theta_trace.shape) == (3, 2)
    assert tuple(r.theta_sd_trace.shape) == (3, 2)
    assert tuple(r.loglik_trace.shape) == (3,)
    assert torch.isfinite(r.loglik_trace).all()
