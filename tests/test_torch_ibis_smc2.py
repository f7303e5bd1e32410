"""The port's IBIS and SMC² held against the JAX package.

- Replays: one resampling IBIS stage (float64, the new state to 1e-9) and
  one rejuvenating SMC² stage (float32, 1e-4: JAX's move does not trace
  under x64), each from the JAX package's draws re-derived from its keys
  as ``_stage_impl`` splits them (the resampling offset, the moves' normals
  and uniforms, and for SMC² every x-filter's resampling uniforms and the
  hooks' normals, handed over by batched test hooks in the port's call
  order).
- A grouped (``max_chunk_steps``) and a per-stage run are bitwise equal,
  for both engines (``tests/test_ibis.py``, ``tests/test_smc2.py:349``).
- The oracles of ``tests/test_ibis.py`` and ``tests/test_smc2.py`` at their
  bounds: IBIS's online posterior and evidence against the conjugate closed
  form, the prequential decomposition, the 2-d regression on dict rows;
  SMC²'s posterior and evidence against the exact grid, the prequential
  sum, online == batch, the state estimate against Kalman, the exchange
  step, the degenerate-cloud guard, the export's shapes, validation.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu import IBISSampler as JIBIS
from mcmcpp_tpu import SMC2Sampler as JSMC2
from mcmcpp_tpu import StateSpaceModel as JSSM
from mcmcpp_tpu.models import lgss as jl
from mcmcpp_tpu.utils.buffers import pad_to_capacity
from mcmcpp_tpu_torch import ibis as ti
from mcmcpp_tpu_torch import smc2 as ts2

torch.set_num_threads(1)

REPLAY_TOL = 1e-9
F32_TOL = 1e-4
TAU, SIG = 2.0, 1.0
LOG2PI = np.log(2 * np.pi)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- IBIS (tests/test_ibis.py) ---------------------------------------------------

def _ibis_data(seed=0, n=60, theta=0.8):
    rng = np.random.default_rng(seed)
    return (theta + SIG * rng.standard_normal(n)).astype(np.float32)


def _posterior_moments(ys):
    prec = 1.0 / TAU ** 2 + len(ys) / SIG ** 2
    return (np.sum(ys) / SIG ** 2) / prec, 1.0 / prec


def _log_marginal(ys):
    n, s = len(ys), float(np.sum(ys))
    ss = float(np.sum(np.asarray(ys, np.float64) ** 2))
    c = 1.0 + n * TAU ** 2 / SIG ** 2
    quad = ss / SIG ** 2 - (TAU ** 2 / SIG ** 4) * s ** 2 / c
    return -0.5 * (n * LOG2PI + n * np.log(SIG ** 2) + np.log(c) + quad)


def _ibis(seed=0, **kw):
    kw.setdefault("n_particles", 2048)
    kw.setdefault("batch_size", 4)
    return mt.IBISSampler(
        log_prior_fn=lambda t: -0.5 * t[0] ** 2 / TAU ** 2,
        loglike_point_fn=lambda t, y: -0.5 * (y - t[0]) ** 2 / SIG ** 2
        - 0.5 * np.log(2 * np.pi * SIG ** 2),
        prior_sample_fn=lambda g, n: TAU * torch.randn((n, 1), generator=g),
        n_params=1, seed=seed, device="cpu", **kw)


def test_ibis_stage_replays_jax_float64():
    ys = _ibis_data(seed=3, n=12).astype(np.float64)
    n = 64
    with jax.enable_x64(True):
        js = JIBIS(
            log_prior_fn=lambda t: -0.5 * t[0] ** 2 / TAU ** 2,
            loglike_point_fn=lambda t, y: -0.5 * (y - t[0]) ** 2,
            prior_sample_fn=lambda k, m: TAU * jax.random.normal(k, (m, 1)),
            n_particles=n, n_params=1, batch_size=4, n_mcmc=3,
            target_ess=0.999, dtype=jnp.float64, max_chunk_steps=None)
        js.update(ys[:8])
        state0 = js.state
        padded, _ = pad_to_capacity(jnp.asarray(ys), 12)
        key = jax.random.key(11)
        new_j, logz_j, resampled, _ = js._stage_impl(
            key, state0, padded, jnp.int32(8), jnp.int32(4))
        assert int(resampled) == 1
        k_res, k = jax.random.split(key)
        u0 = float(jax.random.uniform(k_res, (), jnp.float64))
        moves = []
        for _ in range(3):
            k, k_prop, k_acc = jax.random.split(k, 3)
            moves.append((_t(jax.random.normal(k_prop, (n, 1), jnp.float64)),
                          _t(jax.random.uniform(k_acc, (n,)))))
    ts = mt.IBISSampler(lambda t: -0.5 * t[0] ** 2 / TAU ** 2,
                        lambda t, y: -0.5 * (y - t[0]) ** 2, None, n, 1,
                        batch_size=4, n_mcmc=3, target_ess=0.999,
                        dtype=torch.float64, device="cpu")
    start = ti.IBISState(*(_t(a) for a in state0))
    new_t, logz_t, moved = ts.stage(start, _t(ys), 8, 4,
                                    noise=ti.StageNoise(_t(u0), moves))
    assert moved
    assert abs(float(logz_t) - float(logz_j)) < REPLAY_TOL
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=REPLAY_TOL)


def test_ibis_online_posterior_evidence_and_prequential():
    ys = _ibis_data()
    s = _ibis()
    s.update(ys[:30])
    m_half, v_half = s.moments()
    mean_t, var_t = _posterior_moments(ys[:30])
    assert m_half[0] == pytest.approx(mean_t, abs=0.05)
    assert v_half[0, 0] == pytest.approx(var_t, rel=0.2)
    assert s.log_evidence == pytest.approx(_log_marginal(ys[:30]), abs=0.1)
    s.update(ys[30:])
    m, v = s.moments()
    mean_t, var_t = _posterior_moments(ys)
    assert m[0] == pytest.approx(mean_t, abs=0.04)
    assert v[0, 0] == pytest.approx(var_t, rel=0.2)
    assert s.log_evidence == pytest.approx(_log_marginal(ys), abs=0.15)
    assert s.n_resamples >= 1
    draws = s.posterior(4000, seed=1)
    assert draws.shape == (4000, 1)
    assert draws.mean() == pytest.approx(mean_t, abs=0.05)

    ys = _ibis_data(seed=3, n=24)
    s = _ibis(seed=1, batch_size=1)
    s.update(ys)
    assert len(s.log_evidence_trace) == 24
    assert sum(s.log_evidence_trace) == pytest.approx(s.log_evidence,
                                                      abs=1e-3)
    for t in (0, 5, 15, 23):
        if t == 0:
            pm, pv = 0.0, TAU ** 2 + SIG ** 2
        else:
            pm, pv = _posterior_moments(ys[:t])
            pv = pv + SIG ** 2
        assert s.log_evidence_trace[t] == pytest.approx(
            norm.logpdf(ys[t], pm, np.sqrt(pv)), abs=0.1), t
    # one host sync a stage (its ESS test), one a group for the trace
    assert s.host_syncs == 24 + 1


def test_ibis_chunked_equals_per_stage_bitwise():
    ys = _ibis_data(seed=21, n=70)
    a = _ibis(seed=4, n_particles=128, batch_size=1)
    b = _ibis(seed=4, n_particles=128, batch_size=1, max_chunk_steps=None)
    a.update(ys)
    b.update(ys)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert a.n_resamples == b.n_resamples
    assert a.log_evidence_trace == b.log_evidence_trace
    assert len(a.log_evidence_trace) == 70


def test_ibis_multidim_regression_dict_rows_and_validation():
    rng = np.random.default_rng(11)
    n = 80
    X = rng.standard_normal((n, 2)).astype(np.float32)
    y = (X @ np.array([1.0, -0.5]) + 0.5 * rng.standard_normal(n)).astype(
        np.float32)
    sig2, tau2 = 0.25, 4.0
    prec = X.T @ X / sig2 + np.eye(2) / tau2
    post_mean = np.linalg.solve(prec, X.T @ y / sig2)
    s = mt.IBISSampler(
        log_prior_fn=lambda t: -0.5 * torch.sum(t * t) / tau2,
        loglike_point_fn=lambda t, row: -0.5 * (
            row["y"] - torch.dot(row["x"], t)) ** 2 / sig2,
        prior_sample_fn=lambda g, m: np.sqrt(tau2) * torch.randn(
            (m, 2), generator=g),
        n_particles=2048, n_params=2, batch_size=8, seed=4, device="cpu")
    s.update({"x": X, "y": y})
    m, v = s.moments()
    np.testing.assert_allclose(m, post_mean, atol=0.05)
    np.testing.assert_allclose(v, np.linalg.inv(prec), rtol=0.35, atol=5e-4)

    s = _ibis()
    with pytest.raises(RuntimeError, match="update"):
        _ = s.log_evidence
    with pytest.raises(RuntimeError, match="update"):
        s.moments()
    with pytest.raises(ValueError, match="batch_size"):
        _ibis(batch_size=0)
    bad = mt.IBISSampler(lambda t: 0.0 * t[0], lambda t, y: 0.0 * t[0],
                         lambda g, m: torch.zeros((m, 3)), 64, 2,
                         device="cpu")
    with pytest.raises(ValueError, match="prior_sample"):
        bad.update(np.zeros(4, np.float32))


# -- SMC² (tests/test_smc2.py) -----------------------------------------------------

SIG_Q, SIG_R, M0, P0 = 0.35, 0.6, 1.0, 2.0


def _ssm(sig_r=None):
    def init_sample(gen, n, theta):
        return M0 + np.sqrt(P0) * torch.randn((n, 1), generator=gen)

    def trans_sample(gen, x, t, theta):
        return x + SIG_Q * torch.randn(x.shape, generator=gen)

    def obs_logpdf(y, x, t, theta):
        s = torch.exp(theta[0]) if sig_r is None else torch.tensor(sig_r)
        z = (y[0] - x[:, 0]) / s
        return -0.5 * z * z - torch.log(s) - 0.5 * LOG2PI

    return mt.StateSpaceModel(init_sample, trans_sample, obs_logpdf)


def _smc2_data(t_n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.empty(t_n)
    x[0] = M0 + np.sqrt(P0) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = x[t - 1] + SIG_Q * rng.standard_normal()
    return x, (x + SIG_R * rng.standard_normal(t_n)).astype(np.float32)


def _log_prior(th):
    return -0.5 * th[0] * th[0] - 0.5 * LOG2PI


def _smc2(ys=None, seed=0, m=512, nx=64, **kw):
    s = mt.SMC2Sampler(_ssm(), _log_prior,
                       lambda g, n: torch.randn((n, 1), generator=g),
                       n_theta=m, n_params=1, n_particles=nx, seed=seed,
                       device="cpu", **kw)
    if ys is not None:
        s.update(ys)
    return s


def _grid_truth(ys):
    from scipy.special import logsumexp

    grid = np.linspace(-2.5, 1.5, 401)
    with jax.enable_x64(True):
        ll = np.asarray(jax.vmap(lambda th: jl.lgss_loglik(jl.lgss_params(
            A=1.0, b=0.0, Q=SIG_Q ** 2, H=1.0, c=0.0, R=jnp.exp(th) ** 2,
            m0=M0, P0=P0, dtype=jnp.float64), jnp.asarray(ys, jnp.float64),
            method="sequential"))(jnp.asarray(grid)))
    logpost = ll - 0.5 * grid ** 2 - 0.5 * LOG2PI
    logz = logsumexp(logpost) + np.log(grid[1] - grid[0])
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean = float(w @ grid)
    return mean, float(np.sqrt(w @ (grid - mean) ** 2)), float(logz)


def test_smc2_stage_replays_jax_float32():
    """Row t = 5 of a stream absorbed by the JAX sampler, rejuvenated
    (target_ess 0.999), replayed by the port from the JAX draws. In float32:
    JAX's move does not trace under x64 (its int32 acceptance counter meets
    ``jnp.sum``'s int64), so the state is held to 1e-4."""
    _, ys = _smc2_data(8, seed=3)
    m, n, t_row, n_mcmc = 6, 5, 5, 2

    def jax_ssm():
        def obs(y, x, t, th):
            s = jnp.exp(th[0])
            z = (y[0] - x[:, 0]) / s
            return -0.5 * z * z - jnp.log(s) - 0.5 * LOG2PI

        return JSSM(lambda k, n_, th: M0 + jnp.sqrt(P0) * jax.random.normal(
                        k, (n_, 1)),
                    lambda k, x, t, th: x + SIG_Q * jax.random.normal(
                        k, x.shape), obs)

    js = JSMC2(jax_ssm(), _log_prior,
               lambda k, n_: jax.random.normal(k, (n_, 1)), n_theta=m,
               n_params=1, n_particles=n, n_mcmc=n_mcmc, target_ess=0.999,
               dtype=jnp.float32, max_chunk_steps=None)
    js.update(ys[:t_row])
    state0 = js.state
    padded, _ = pad_to_capacity(jnp.asarray(ys[:, None]), len(ys))
    key = jax.random.key(2)
    new_j, logz_j, moved, _ = js._stage_impl(key, state0, padded,
                                             jnp.int32(t_row))
    assert int(moved) == 1
    # the draws, in the port's order
    inits, trans = [], []
    k_adv, k_res, k_move = jax.random.split(key, 3)
    adv = [jax.random.split(k, 3) for k in jax.random.split(k_adv, m)]
    adv_u = [float(jax.random.uniform(k[1], (), jnp.float32))
             for k in adv]
    trans.append(np.stack([np.asarray(jax.random.normal(k[2], (n, 1)))
                           for k in adv]))
    u0 = float(jax.random.uniform(k_res, (), jnp.float32))
    moves, k = [], k_move
    for _ in range(n_mcmc):
        k, k_prop, k_pf, k_u = jax.random.split(k, 4)
        z = np.asarray(jax.random.normal(k_prop, (m, 1), jnp.float32))
        pf_u = np.zeros((t_row, m))
        pf_init, pf_trans = [], [[] for _ in range(t_row)]
        for j, kj in enumerate(jax.random.split(k_pf, m)):
            k0, ks = jax.random.split(kj)
            pf_init.append(np.asarray(jax.random.normal(k0, (n, 1))))
            for r in range(1, t_row + 1):
                ks, k_rs, k_p = jax.random.split(ks, 3)
                pf_u[r - 1, j] = float(jax.random.uniform(
                    k_rs, (), jnp.float32))
                pf_trans[r - 1].append(np.asarray(jax.random.normal(
                    k_p, (n, 1))))
        inits.append(np.stack(pf_init))
        trans.extend(np.stack(x) for x in pf_trans)
        u = np.asarray(jax.random.uniform(k_u, (m,), jnp.float32,
                                          minval=1e-37))
        moves.append((_t(z), _t(pf_u), _t(u)))
    inits, trans = [_t(a) for a in inits], [_t(a) for a in trans]

    def obs_logpdf(y, x, t, th):
        s = torch.exp(th[:, :1])
        zz = (y[0] - x[..., 0]) / s
        return -0.5 * zz * zz - torch.log(s) - 0.5 * LOG2PI

    ssm = mt.StateSpaceModel(
        lambda g, n_, th: M0 + np.sqrt(P0) * inits.pop(0),
        lambda g, x, t, th: x + SIG_Q * trans.pop(0), obs_logpdf)
    ts = mt.SMC2Sampler(ssm, lambda th: -0.5 * th[:, 0] ** 2 - 0.5 * LOG2PI,
                        None, n_theta=m, n_params=1, n_particles=n,
                        n_mcmc=n_mcmc, target_ess=0.999, dtype=torch.float32,
                        batched=True, device="cpu")
    start = ts2.SMC2State(*(_t(a) for a in state0))
    new_t, logz_t, moved_t, _ = ts.stage(
        start, _t(ys[:, None]), t_row,
        noise=ts2.StageNoise(_t(adv_u), _t(u0), moves))
    assert moved_t and not inits and not trans
    assert abs(float(logz_t) - float(logz_j)) < F32_TOL
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_smc2_matches_exact_grid_posterior_and_evidence():
    _, ys = _smc2_data(40, seed=11)
    mean_true, sd_true, logz_true = _grid_truth(ys)
    s = _smc2(ys, seed=3)
    mean, cov = s.moments()
    assert abs(mean[0] - mean_true) < 6.0 * sd_true / np.sqrt(64.0) + 0.05
    assert 0.6 * sd_true < np.sqrt(cov[0, 0]) < 1.6 * sd_true
    assert abs(s.log_evidence - logz_true) < 1.0
    assert s.n_resamples > 0
    # one host sync a stage, one a group of 32 for the increments
    assert s.host_syncs == 40 + 2


def test_smc2_prequential_online_batch_and_chunking():
    _, ys = _smc2_data(25, seed=2)
    s = _smc2(ys, seed=1, m=256, nx=32)
    assert len(s.log_evidence_trace) == 25
    assert s.log_evidence == pytest.approx(float(np.sum(
        s.log_evidence_trace)), abs=1e-4)
    _, ys = _smc2_data(24, seed=7)
    a = _smc2(ys, seed=9, m=128, nx=32)
    b = _smc2(None, seed=9, m=128, nx=32)
    for i in range(0, 24, 5):
        b.update(ys[i:i + 5])
    np.testing.assert_allclose(a.state.theta.numpy(), b.state.theta.numpy(),
                               rtol=2e-6, atol=1e-6)
    assert a.log_evidence == pytest.approx(b.log_evidence, abs=1e-4)
    # grouped (32) and per-stage runs: bitwise equal
    _, ys = _smc2_data(40, seed=17)
    a = _smc2(ys, seed=8, m=64, nx=16, max_chunk_steps=32)
    b = _smc2(ys, seed=8, m=64, nx=16, max_chunk_steps=None)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert a.n_resamples == b.n_resamples
    assert a.log_evidence_trace == b.log_evidence_trace


def test_smc2_state_estimate_tightening_and_export():
    _, ys = _smc2_data(30, seed=5)
    s = mt.SMC2Sampler(
        _ssm(sig_r=SIG_R), lambda th: 0.0 * th[0],
        lambda g, n: 0.01 * torch.randn((n, 1), generator=g), n_theta=64,
        n_params=1, n_particles=256, device="cpu")
    s.update(ys)
    f = jl.kalman_filter(jl.lgss_params(A=1.0, b=0.0, Q=SIG_Q ** 2, H=1.0,
                                        c=0.0, R=SIG_R ** 2, m0=M0, P0=P0),
                         ys, method="sequential")
    m_true = float(np.asarray(f.means)[-1, 0])
    sd_true = float(np.sqrt(np.asarray(f.covs)[-1, 0, 0]))
    assert abs(s.state_estimate()[0] - m_true) < 6.0 * sd_true / 16.0 + 0.05

    _, ys = _smc2_data(60, seed=13)
    s = _smc2(None, seed=2, m=256, nx=32)
    s.update(ys[:10])
    _, cov_early = s.moments()
    s.update(ys[10:])
    assert s.moments()[1][0, 0] < cov_early[0, 0]

    s = _smc2(_smc2_data(12, seed=1)[1], seed=0, m=64, nx=16)
    d = mt.smc2_to_inference_dict(s, n_draws=100)
    assert d["posterior"]["theta"].shape == (1, 100, 1)
    assert d["sample_stats"]["log_evidence"].shape == (1, 100)
    assert np.isfinite(d["sample_stats"]["prequential_logp"][0, :12]).all()
    assert d["sample_stats"]["filtered_state_0"].shape == (1, 100)
    with pytest.raises(TypeError, match="SMC2Sampler"):
        mt.smc2_to_inference_dict(object())
    d = mt.ibis_to_inference_dict(_ibis(n_particles=64).update(
        _ibis_data(n=8)), n_draws=50)
    assert d["posterior"]["theta"].shape == (1, 50, 1)
    assert d["sample_stats"]["n_resamples"].shape == (1, 50)
    with pytest.raises(TypeError, match="IBISSampler"):
        mt.ibis_to_inference_dict(s)
    with pytest.raises(ValueError, match="prior_sample"):
        mt.SMC2Sampler(_ssm(), _log_prior,
                       lambda g, n: torch.randn((n, 2), generator=g),
                       n_theta=16, n_params=1, n_particles=8,
                       device="cpu").init()
    with pytest.raises(RuntimeError, match="update"):
        _smc2(None).log_evidence


def test_smc2_exchange_step_and_degenerate_guard():
    _, ys = _smc2_data(40, seed=11)
    mean_true, sd_true, _ = _grid_truth(ys)
    s = _smc2(None, seed=5, m=256, nx=2, grow_particles=True,
              grow_threshold=0.4, max_particles=64)
    s.update(ys)
    assert s.n_growths >= 1, s.last_rejuvenation_accept
    assert s.n_x == 2 * 2 ** s.n_growths and s.n_x <= 64
    assert s.state.xs.shape[1] == s.n_x
    assert math.isfinite(s.log_evidence)
    assert abs(s.moments()[0][0] - mean_true) < 8.0 * sd_true / np.sqrt(
        32.0) + 0.1
    s = _smc2(None, seed=5, m=128, nx=4)
    s.update(_smc2_data(30, seed=11)[1])
    assert s.n_growths == 0 and s.n_x == 4
    s = mt.SMC2Sampler(_ssm(), _log_prior, lambda g, n: torch.zeros((n, 1)),
                       n_theta=64, n_params=1, n_particles=32, seed=0,
                       target_ess=1.0, n_mcmc=5, device="cpu")
    s.update(_smc2_data(20, seed=3)[1])
    assert float(torch.std(s.state.theta)) > 1e-3
