"""The port's SMC sampler held against the JAX package.

- ``_find_next_beta`` and ``ess_from_log_weights`` agree with JAX in
  float64 to 1e-12.
- ``systematic_resample`` from JAX's own uniform picks the same indices in
  float64. In float32 the two packages' cumsums associate differently, so an
  index may differ where a grid point lies within a few ulps of a
  cumulative weight; the float32 case allows a mismatch only there and
  counts them.
- One whole stage replayed from JAX's draws (its key chain re-derived as
  ``SMCSampler._stage_impl`` splits it) for each mutation: ensemble
  (StretchMove), waste-free ensemble, MALA, HMC and flow (refit and
  independence Metropolis) in float64 (the new state to 1e-9), and
  FusedStretchMove in float32 (JAX's Pallas kernel in interpret mode, whose
  uniforms are 2^-25, against the port's plain split path on the CPU:
  atol 1e-5).
- The statistical oracles of ``tests/test_smc_vi.py`` at its bounds: the
  conjugate 2-D model's log Z and posterior moments for the ensemble,
  FusedStretchMove, waste-free (at 8192 particles, see the case), MALA and
  flow mutations, and the 10-D correlated model for HMC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import smc as js
from mcmcpp_tpu.neutra import RealNVP as JRealNVP
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import smc as ts
from mcmcpp_tpu_torch.convert import flow_params_from_numpy
from mcmcpp_tpu_torch.optim import adam_init
from mcmcpp_tpu_torch.ops.random import UNIT_FLOOR
from tests.test_torch_movers import jax_partner_noise

torch.set_num_threads(1)

REPLAY_TOL = 1e-9
S2 = 1.0 / (1.0 / 4.0 + 1.0)


def logz_conj(dim):
    return dim * (-0.5 * np.log(2 * np.pi * 5.0) - 0.5 / 5.0)


def conj_model(lib, dim):
    """Prior N(0, 4I), likelihood N(1, I) (``tests/test_smc_vi.py:28``)."""
    log = np.log

    def lp(t):
        return -0.5 * lib.sum(t ** 2, -1) / 4.0 - dim / 2 * log(
            2 * np.pi * 4.0)

    def ll(t):
        return -0.5 * lib.sum((t - 1.0) ** 2, -1) - dim / 2 * log(2 * np.pi)

    return lp, ll


def jax_prior(dim):
    return lambda key, n: 2.0 * jax.random.normal(key, (n, dim))


def torch_prior(dim):
    return lambda gen, n: 2.0 * torch.randn((n, dim), generator=gen,
                                            device=gen.device)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_find_next_beta_and_ess_match_jax_float64():
    rng = np.random.default_rng(0)
    with jax.enable_x64(True):
        find = jax.jit(js._find_next_beta, static_argnums=(2, 3))
        for scale, beta in ((1.0, 0.0), (30.0, 0.2), (300.0, 0.7)):
            ll = -scale * rng.exponential(size=500)
            want = find(jnp.asarray(ll), jnp.asarray(beta), 0.5, 500)
            got = ts._find_next_beta(_t(ll), torch.tensor(beta,
                                                          dtype=torch.float64),
                                     0.5, 500)
            assert abs(float(got) - float(want)) <= 1e-12
            lw = (float(want) - beta) * ll
            assert float(ts.ess_from_log_weights(_t(lw))) == pytest.approx(
                float(js.ess_from_log_weights(jnp.asarray(lw))), rel=1e-12)


def test_systematic_resample_float64_equal_float32_near_grid_only():
    rng = np.random.default_rng(1)
    resample = jax.jit(js.systematic_resample, static_argnums=2)
    for i, (n_w, n) in enumerate(((4, 400), (5000, 777))):
        log_w = rng.normal(scale=3.0, size=n_w)
        key = jax.random.key(i)
        with jax.enable_x64(True):
            want = np.asarray(resample(key, jnp.asarray(log_w), n))
            u0 = float(jax.random.uniform(key, (), jnp.float64))
        got = ts.systematic_resample(torch.tensor(u0, dtype=torch.float64),
                                     _t(log_w), n).numpy()
        np.testing.assert_array_equal(got, want)
        # float32: a different pick only where a grid point sits within a
        # few ulps of a cumulative weight
        lw32 = log_w.astype(np.float32)
        want32 = np.asarray(resample(key, jnp.asarray(lw32), n))
        u32 = jax.random.uniform(key, (), jnp.float32)
        got32 = ts.systematic_resample(torch.tensor(np.asarray(u32)),
                                       _t(lw32), n).numpy()
        diff = np.nonzero(got32 != want32)[0]
        w = np.exp(log_w - log_w.max())
        cum = np.cumsum(w) / w.sum()
        pts = (float(u32) + np.arange(n)) / n
        gap = np.min(np.abs(cum[None, :] - pts[diff, None]), axis=1) \
            if diff.size else np.zeros(0)
        assert np.all(gap < 8 * np.finfo(np.float32).eps), (diff, gap)
        assert np.all(np.abs(got32[diff] - want32[diff]) == 1)
        assert diff.size <= 2  # seen: 0 in these cases


# -- one stage replayed from JAX's draws -----------------------------------


def _half_noise(mutation, key, half, dim, dt):
    """One half-step's draws of the JAX stage in the port's layout."""
    if mutation == "ensemble":
        kp, ka = jax.random.split(key)
        kj, kz = jax.random.split(kp)
        return (jax_partner_noise(kj, half, half, 1, "roll"),
                _t(jax.random.uniform(kz, (half,), dt)),
                _t(-jax.random.exponential(ka, (half,), dt)))
    if mutation == "hmc":
        kp, kj, ka = jax.random.split(key, 3)
        return (_t(jax.random.normal(kp, (half, dim), dt)),
                _t(jax.random.uniform(kj, (half,), dt, 0.5, 1.5)),
                _t(-jax.random.exponential(ka, (half,), dt)))
    kp, ka = jax.random.split(key)  # mala, flow
    return (_t(jax.random.normal(kp, (half, dim), dt)),
            _t(-jax.random.exponential(ka, (half,), dt)))


def _stage_noise(j, key, n_fit=0, batch=0):
    """The port's StageNoise of ``j._stage_impl(key, ...)``."""
    dt = j.dtype
    k_rs, k_mut, k_fit = jax.random.split(key, 3)
    m = j.n if j.waste_free_k is None else j.n // (j.waste_free_k + 1)
    half = m // 2
    if j.waste_free_k is None:
        keys, k = [], k_mut
        for _ in range(j.n_mcmc):
            k, ks = jax.random.split(k)
            keys.append(ks)
    else:
        keys = list(jax.random.split(k_mut, j.waste_free_k))
    steps = [tuple(_half_noise(j.mutation, kk, half, j.n_params, dt)
                   for kk in jax.random.split(k)) for k in keys]
    fit = None
    if j.mutation == "flow":
        fit = torch.stack([_t(jax.random.randint(k, (batch,), 0, m))
                           for k in jax.random.split(k_fit, n_fit)])
    return ts.StageNoise(_t(jax.random.uniform(k_rs, (), dt)), steps, fit)


def _replay_stage(mutation, dim=2, n=64, waste_free_k=None, n_mcmc=2):
    kw = dict(n_mcmc=n_mcmc, waste_free_k=waste_free_k, mutation=mutation,
              flow_fit_steps=6, flow_batch=16, hmc_steps=3)
    with jax.enable_x64(True):
        jlp, jll = conj_model(jnp, dim)
        j = js.SMCSampler(jlp, jll, jax_prior(dim), n, dim, seed=3,
                          dtype=jnp.float64,
                          flow=JRealNVP(dim, n_layers=2, hidden=8,
                                        dtype=jnp.float64), **kw)
        j.init()
        tlp, tll = conj_model(torch, dim)
        t = mt.SMCSampler(tlp, tll, None, n, dim, dtype=torch.float64,
                          batched=True, device="cpu",
                          flow=mt.RealNVP(dim, n_layers=2, hidden=8,
                                          dtype=torch.float64), **kw)
        if t._flow is not None:
            params = jax.tree_util.tree_leaves(j._flow_carry[0])
            flow_params_from_numpy(t._flow, [np.asarray(x) for x in params])
            t._flow_opt_state = adam_init(t._flow.param_list())
        t.state = ts.SMCState(*(_t(x) for x in j.state))
        for stage in range(2):
            key = jax.random.key(100 + stage)
            noise = _stage_noise(j, key, n_fit=6, batch=16)
            j.state, j._flow_carry = j._stage(key, j.state, j._flow_carry)
            t.state = t.apply_stage(t.state, noise)
            for name, a, b in zip(ts.SMCState._fields, j.state, t.state):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=REPLAY_TOL, atol=REPLAY_TOL,
                                           err_msg=name)
        if t._flow is not None:
            for a, b in zip(jax.tree_util.tree_leaves(j._flow_carry[0]),
                            t._flow.param_list()):
                np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                           rtol=REPLAY_TOL, atol=REPLAY_TOL)
    assert 0.0 < float(t.state.beta) <= 1.0
    return t


@pytest.mark.parametrize("mutation,waste_free_k", [
    ("ensemble", None), ("ensemble", 3), ("mala", None), ("hmc", None),
    ("flow", None)])
def test_stage_replays_jax_float64(mutation, waste_free_k):
    t = _replay_stage(mutation, waste_free_k=waste_free_k)
    assert t.state.particles.shape == (64, 2)


def test_fused_stretch_stage_replays_jax_interpret():
    """The ensemble mutation with FusedStretchMove: JAX's Pallas kernel
    (interpret mode: u = ue = 2^-25) traces the tempered logp into its body;
    the port runs its split path's plain versions on the tempered logp."""
    from mcmcpp_tpu.movers.fused import FusedStretchMove as JFused

    dim, n, half = 2, 64, 32
    jlp, jll = conj_model(jnp, dim)
    j = js.SMCSampler(jlp, jll, jax_prior(dim), n, dim, n_mcmc=2, seed=5,
                      mover=JFused(tile=32, interpret=True))
    j.init()
    tlp, tll = conj_model(torch, dim)
    t = mt.SMCSampler(tlp, tll, None, n, dim, n_mcmc=2, batched=True,
                      mover=mt.FusedStretchMove(), device="cpu")
    t.state = ts.SMCState(*(_t(x) for x in j.state))
    floor = torch.full((half,), UNIT_FLOOR)

    def fused_noise(key):
        shift = jax.random.randint(jax.random.split(key)[1], (), 0, half,
                                   dtype=jnp.int32)
        return (torch.tensor([int(shift)], dtype=torch.int32), floor,
                floor.clone())

    for stage in range(2):
        key = jax.random.key(7 + stage)
        k_rs, k_mut, _ = jax.random.split(key, 3)
        keys, k = [], k_mut
        for _ in range(2):
            k, ks = jax.random.split(k)
            keys.append(ks)
        noise = ts.StageNoise(
            _t(jax.random.uniform(k_rs, (), jnp.float32)),
            [tuple(fused_noise(kk) for kk in jax.random.split(k))
             for k in keys])
        j.state, _ = j._stage(key, j.state, None)
        t.state = t.apply_stage(t.state, noise)
        for name, a, b in zip(ts.SMCState._fields, j.state, t.state):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


# -- statistical oracles (tests/test_smc_vi.py's bounds) --------------------


def _run(dim=2, n=2048, **kw):
    lp, ll = conj_model(torch, dim)
    s = mt.SMCSampler(lp, ll, torch_prior(dim), n, dim, batched=True,
                      device="cpu", **kw).run()
    assert float(s.state.beta) == 1.0
    return s


@pytest.mark.parametrize("case", ["ensemble", "fused", "waste_free", "mala",
                                  "flow"])
def test_conjugate_evidence_and_moments(case):
    kw, atol_mean, atol_var, atol_z = {
        "ensemble": (dict(n_mcmc=5, seed=0), 0.08, 0.1, 0.15),
        "fused": (dict(n_mcmc=5, seed=0, mover=mt.FusedStretchMove()),
                  0.08, 0.1, 0.15),
        # 8192 particles, not the JAX test's 2048: at 2048 (M = 256 seeds,
        # two stages) the posterior mean's spread over seeds is 0.05-0.09
        # in both packages (JAX: up to 0.17 from 0.8 over 12 seeds), so one
        # seed passes the 0.08 bound by luck or not; at 8192 the port's
        # spread is 0.03 (largest deviation 0.055 over 12 seeds)
        "waste_free": (dict(n=8192, waste_free_k=7, seed=0), 0.08, 0.1,
                       0.2),
        "mala": (dict(n_mcmc=5, seed=0, mutation="mala"), 0.08, 0.12, 0.15),
        "flow": (dict(n_mcmc=5, seed=0, mutation="flow",
                      flow=mt.RealNVP(2, n_layers=4, hidden=32)),
                 0.08, 0.12, 0.2),
    }[case]
    s = _run(**kw)
    p = s.particles
    np.testing.assert_allclose(p.mean(0), [S2, S2], atol=atol_mean)
    np.testing.assert_allclose(p.var(0), [S2, S2], atol=atol_var)
    assert s.log_evidence == pytest.approx(logz_conj(2), abs=atol_z)
    assert all(b2 > b1 for b1, b2 in zip(s.beta_ladder, s.beta_ladder[1:]))


def test_hmc_mutation_10d_correlated():
    """``TestHMCMutation.test_evidence_and_moments_10d_correlated``: prior
    N(0, 4I), likelihood N(1; θ, C) with C equicorrelated (ρ = 0.5)."""
    dim, rho = 10, 0.5
    c = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    lam = torch.from_numpy(np.linalg.inv(c).astype(np.float32))
    _, logdet_c = np.linalg.slogdet(c)
    marg = c + 4.0 * np.eye(dim)
    y = np.ones(dim)
    logz = float(-0.5 * y @ np.linalg.inv(marg) @ y
                 - 0.5 * np.linalg.slogdet(marg)[1]
                 - dim / 2 * np.log(2 * np.pi))
    post_cov = np.linalg.inv(np.linalg.inv(c) + np.eye(dim) / 4.0)
    post_mean = post_cov @ (np.linalg.inv(c) @ y)
    lp, _ = conj_model(torch, dim)

    def ll(t):
        d = t - 1.0
        return (-0.5 * torch.sum((d @ lam) * d, -1)
                - dim / 2 * np.log(2 * np.pi) - 0.5 * logdet_c)

    s = mt.SMCSampler(lp, ll, torch_prior(dim), 2048, dim, n_mcmc=3, seed=0,
                      mutation="hmc", batched=True, device="cpu").run()
    assert float(s.state.beta) == 1.0
    assert s.log_evidence == pytest.approx(logz, abs=0.35)
    np.testing.assert_allclose(s.particles.mean(0), post_mean, atol=0.1)
    np.testing.assert_allclose(s.particles.var(0), np.diag(post_cov),
                               atol=0.15)


def test_validation_and_cuda_without_gpu():
    lp, ll = conj_model(torch, 2)
    with pytest.raises(ValueError, match="unknown mutation"):
        mt.SMCSampler(lp, ll, None, 64, 2, mutation="nuts", device="cpu")
    with pytest.raises(ValueError, match="hmc_steps"):
        mt.SMCSampler(lp, ll, None, 64, 2, mutation="hmc", hmc_steps=0,
                      device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        mt.SMCSampler(lp, ll, None, 64, 2, waste_free_k=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mt.SMCSampler(lp, ll, None, 64, 2)
