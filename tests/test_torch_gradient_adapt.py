"""Adaptation in the port's gradient engines, against the JAX package.

Replays (the JAX package's own draws, re-derived from its keys): a whole
HMC warmup, diagonal and dense (dual averaging, Welford moments, the metric
rebuilt every step); ChEES's whole-batch step, with its trajectory-length
gradient; MEADS's fold step and its tuning (the power-iteration eigenvalue,
the fold parameters). Halton's sequence equals JAX's bit for bit.

Mirrors of the non-slow tests of ``tests/test_gradient.py`` (ChEES's
trajectory growth, determinism, continuous adaptation and re-warmup),
``tests/test_meads.py`` and ``tests/test_dense_metric.py``, at 64 chains or
fewer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.gradient import chees as jchees
from mcmcpp_tpu.gradient import hmc as jhmc
from mcmcpp_tpu.gradient import meads as jmeads
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.gradient import chees as tchees
from mcmcpp_tpu_torch.gradient import hmc as thmc
from mcmcpp_tpu_torch.gradient import meads as tmeads
from mcmcpp_tpu_torch.gradient.metric import DenseMassMatrix
from tests.test_torch_gradient import (  # noqa: F401 (a fixture)
    C,
    F32,
    P,
    TOL,
    _state,
    _t,
    assert_states,
    problem,
)

torch.set_num_threads(1)

DIM = 4


def _ar1(dim=DIM, rho=0.5):
    idx = np.arange(dim)
    cov = rho ** np.abs(idx[:, None] - idx[None, :])
    return mt.GaussianTarget.from_cov(cov, device="cpu"), cov


def _wide(dim=8):
    """The unwhitened anisotropic Gaussian of the ChEES tests."""
    scales = torch.linspace(1.0, 5.0, dim)
    return (lambda t: -0.5 * torch.sum((t / scales) ** 2, dim=-1)), scales


# -- replays -----------------------------------------------------------------


@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_whole_warmup_replays_jax(metric):
    """50 warmup steps of HMC on the AR(1) Gaussian, every step's noise the
    JAX sampler's (``warmup``: one split for the run key, one per step,
    one per chain): the final per-chain step sizes, the mass matrix and the
    positions agree within 1e-4 relative.

    The replay is chaotic, so it runs in float64 on both sides with one
    leapfrog step a transition. Early warmup drives the step size past the
    leapfrog's stability limit, dual averaging feeds the acceptance back
    into it with a gain above one, and the shared Welford metric couples
    every chain: a difference of one float64 ulp at the start grew to 1e-9
    relative over 50 steps with one leapfrog step, and to 0.2 with six (and
    so would any float32 replay). The single-transition replays of
    ``tests/test_torch_gradient.py`` hold the float32 arithmetic and the
    eight-step leapfrog."""
    from tests.targets import correlated_gaussian_logp_factory

    n_chains, n_steps = 32, 50
    f64 = jnp.float64

    def noise(key):
        k_mom, k_acc = jax.random.split(key)
        return (jax.random.normal(k_mom, (P,), f64),
                -jax.random.exponential(k_acc, (), f64))

    with jax.enable_x64(True):
        logp, cov = correlated_gaussian_logp_factory(dim=P, rho=0.5,
                                                     dtype=f64)
        j = jref.HMCSampler(logp, n_chains=n_chains, n_params=P, seed=4,
                            n_leapfrog=1, metric=metric, dtype=f64)
        j.init_ball(np.zeros(P), scale=1.0, seed=5)
        start = np.asarray(j.state.position)
        _, key = jax.random.split(j._key)
        j.warmup(n_steps)
        draw = jax.jit(lambda k: (
            jax.random.split(k)[0],
            jax.vmap(noise)(jax.random.split(jax.random.split(k)[1],
                                             n_chains))))
        noises = []
        for _ in range(n_steps):
            key, (z, log_u) = draw(key)
            noises.append((_t(z), _t(log_u)))
        j_step, j_pos = np.asarray(j.step_size), np.asarray(j.state.position)
        j_mass = ([np.asarray(x) for x in j.inv_mass] if metric == "dense"
                  else [np.asarray(j.inv_mass)])
    prec = torch.from_numpy(np.linalg.inv(cov))
    t = mt.HMCSampler(lambda x: -0.5 * torch.sum((x @ prec) * x, dim=-1),
                      n_chains, P, seed=99, n_leapfrog=1, metric=metric,
                      dtype=torch.float64, device="cpu")
    t.init(start)
    feed = iter(noises)
    t._kernel.draw_noise = lambda gen, state, host_gen=None: next(feed)
    t.warmup(n_steps)
    assert t.step_size.dtype == torch.float64
    np.testing.assert_allclose(t.step_size.numpy(), j_step, rtol=1e-4)
    t_mass = t.inv_mass if metric == "dense" else [t.inv_mass]
    for a, b in zip(t_mass, j_mass):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(t.state.position.numpy(), j_pos, rtol=1e-4,
                               atol=1e-8)


def test_chees_batch_step_replays_jax(problem):
    pb = problem
    im_j, im_t = jnp.asarray(pb["var"]), _t(pb["var"])
    key = jax.random.key(11)
    eps, traj, u = 0.3, 1.7, float(jchees.halton2(jnp.int32(5)))
    js = jchees.chees_batch_step(pb["jt"].logp)
    state_j = jhmc.HMCState(jnp.asarray(pb["q"]), jnp.asarray(pb["lp"]),
                            jnp.asarray(pb["g"]))
    sj, (apj, accj, tgj, nj, divj, enj) = jax.jit(js)(
        key, state_j, jnp.float32(eps), im_j, jnp.float32(traj),
        jnp.float32(u))
    k_mom, k_acc = jax.random.split(key)
    noise = (_t(jax.random.normal(k_mom, (C, P), F32)),
             _t(-jax.random.exponential(k_acc, (C,), F32)))
    st, (apt, acct, tgt, nt, divt, ent) = tchees.chees_batch_step(
        pb["tt"]).apply(noise, _state(pb), eps, im_t, traj, u)
    assert nt == int(nj) == tchees.n_leapfrog(eps, traj, u, 1024)
    gap = np.log(np.maximum(np.asarray(apj), 1e-30)) - noise[1].numpy()
    assert_states(st, sj, acct, accj, gap)
    np.testing.assert_allclose(float(tgt), float(tgj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ent.numpy(), np.asarray(enj), rtol=TOL,
                               atol=TOL)


def test_halton_equals_jax():
    i = np.arange(300, dtype=np.int32)
    np.testing.assert_array_equal(tchees.halton2(i),
                                  np.asarray(jchees.halton2(jnp.asarray(i))))


def test_meads_fold_step_replays_jax(problem):
    pb = problem
    rng = np.random.default_rng(5)
    p = rng.normal(size=(C, P)).astype(np.float32)
    # the fold's tuning from the other half of the batch, both packages
    q_prev = (pb["q"][::-1] * 1.7).copy()
    g_prev = np.asarray(jax.vmap(jax.grad(pb["jt"].logp))(q_prev))
    sd_j, eps_j, delta_j = jmeads._fold_parameters(
        jnp.asarray(q_prev), jnp.asarray(g_prev), 0.5, F32)
    sd_t, eps_t, delta_t = tmeads.fold_parameters(_t(q_prev), _t(g_prev), 0.5)
    for a, b in ((sd_t, sd_j), (eps_t, eps_j), (delta_t, delta_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    np.testing.assert_allclose(
        float(tmeads.max_eig_cov(_t(q_prev))),
        float(jmeads.max_eig_cov(jnp.asarray(q_prev))), rtol=1e-4)
    key = jax.random.key(13)
    lp_grad = jax.vmap(jax.value_and_grad(pb["jt"].logp))
    eps_big = jnp.float32(4.0) * eps_j  # a mix of accepts and rejects
    out_j = jax.jit(jmeads.ghmc_fold_step(lp_grad))(
        key, jnp.asarray(pb["q"]), jnp.asarray(p), jnp.asarray(pb["lp"]),
        jnp.asarray(pb["g"]), sd_j, eps_big, delta_j)
    k_ref, k_acc = jax.random.split(key)
    noise = (_t(jax.random.normal(k_ref, (C, P), F32)),
             _t(-jax.random.exponential(k_acc, (C,), F32)))
    out_t = tmeads.ghmc_fold_step(pb["tt"]).apply(
        noise, _t(pb["q"]), _t(p), _t(pb["lp"]), _t(pb["g"]), _t(sd_j),
        _t(eps_big), _t(delta_j))
    gap = np.log(np.maximum(np.asarray(out_j[4]), 1e-30)) - noise[1].numpy()
    assert_states(out_t[:4], out_j[:4], out_t[5], out_j[5], gap)
    for a, b in zip(out_t[4:], out_j[4:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


# -- ChEES (tests/test_gradient.py) ----------------------------------------------


def test_halton_low_discrepancy():
    """Any prefix of length 2^k hits each of the 2^k bins exactly once."""
    u = tchees.halton2(np.arange(64))
    assert np.all((u > 0) & (u < 1))
    for k in (8, 16, 32, 64):
        assert sorted(np.floor(u[:k] * k).astype(int)) == list(range(k))


def test_chees_trajectory_adapts_up_for_wide_target():
    """Mass adaptation off: the optimal trajectory ~ (π/2)·σ_max is many
    steps, so the adapted T must grow to several leapfrog steps."""
    logp, scales = _wide()
    s = mt.CheesHMCSampler(logp, 64, 8, seed=3, step_size=0.1, device="cpu")
    s.init_ball(np.zeros(8), scale=1.0, seed=4)
    s.warmup(400, adapt_mass=False)
    assert isinstance(s.step_size, float)
    assert s.traj_length > 2 * s.step_size, (s.traj_length, s.step_size)
    assert 2.0 < s.traj_length < 25.0, s.traj_length
    s.run(400)
    np.testing.assert_allclose(s.get_samples(flat=True).std(axis=0),
                               scales.numpy(), rtol=0.15)


def _chees(seed, continuous_adapt=False, warmup=60, steps=100):
    target, cov = _ar1()
    s = mt.CheesHMCSampler(target, 32, DIM, seed=seed, device="cpu",
                           continuous_adapt=continuous_adapt)
    s.init_ball(np.zeros(DIM), scale=1.0, seed=seed + 1)
    s.warmup(warmup)
    s.run(steps)
    return s, cov


@pytest.mark.parametrize("continuous_adapt", [False, True])
def test_chees_deterministic_given_seed(continuous_adapt):
    s1, _ = _chees(11, continuous_adapt)
    s2, _ = _chees(11, continuous_adapt)
    assert s1.current_traj_length() == s2.current_traj_length()
    np.testing.assert_array_equal(s1.get_samples(), s2.get_samples())


def test_chees_continuous_adapt_moments():
    """Diminishing adaptation leaves the stationary distribution intact."""
    s, cov = _chees(0, True, warmup=150, steps=400)
    flat = s.get_samples(burn_in=50, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(DIM), atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.3)


def test_chees_continuous_adapt_recovers_from_short_warmup():
    """A deliberately tiny trajectory at the start: the in-sampling ascent
    grows T, and a further run moves log T far less (diminishing rate)."""
    logp, _ = _wide()
    s = mt.CheesHMCSampler(logp, 64, 8, seed=3, step_size=0.25,
                           init_traj_length=0.3, continuous_adapt=True,
                           device="cpu")
    s.init_ball(np.zeros(8), scale=1.0, seed=4)
    t0 = s.current_traj_length()
    s.run(200)
    t1 = s.current_traj_length()
    assert t1 > 3.0 * t0, (t0, t1)
    s.run(200)
    t2 = s.current_traj_length()
    assert abs(np.log(t2 / t1)) < 0.5 * abs(np.log(t1 / t0)), (t0, t1, t2)


def test_chees_rewarmup_resets_continuous_adapt_and_the_trajectory():
    """A second warmup restarts continuous adaptation from its own T, and
    the runs after it use that T (the port builds no program to cache)."""
    target, _ = _ar1()
    s = mt.CheesHMCSampler(target, 8, DIM, seed=7, continuous_adapt=True,
                           device="cpu")
    s.init_ball(np.zeros(DIM), scale=1.0, seed=8)
    s.warmup(40)
    s.run(50)
    assert s._sadapt is not None
    s.warmup(40)
    assert s._sadapt is None
    assert s.current_traj_length() == s.traj_length
    s.continuous_adapt = False
    seen = []
    apply = s._kernel.apply
    s._kernel.apply = lambda *a: seen.append(a[4]) or apply(*a)
    s.run(3)
    assert seen == [s.traj_length] * 3


# -- MEADS (tests/test_meads.py) -------------------------------------------------


def test_max_eig_matches_eigvalsh():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 5))
    chol = np.linalg.cholesky(a @ a.T + np.eye(5))
    x = (rng.standard_normal((8192, 5)) @ chol.T).astype(np.float32)
    want = np.linalg.eigvalsh(np.cov(x.T)).max()
    assert abs(float(tmeads.max_eig_cov(_t(x))) - want) / want < 0.02
    assert float(tmeads.max_eig_cov(torch.ones((16, 3)))) == 0.0


def test_meads_acceptance_determinism_validation():
    target, _ = _ar1()

    def go(seed=0, n_chains=64, steps=60):
        s = mt.MEADSSampler(target, n_chains, DIM, seed=seed, device="cpu")
        s.init_ball(np.zeros(DIM), scale=1.0, seed=seed + 1)
        s.warmup(steps)
        s.run(steps)
        return s

    s = go()
    # eps at half the leapfrog stability limit: acceptance should be high
    assert s.last_mean_accept > 0.6
    assert s.state.momentum.shape == (64, DIM)
    np.testing.assert_array_equal(go(7, 16, 20).get_samples(),
                                  go(7, 16, 20).get_samples())
    with pytest.raises(ValueError, match="not divisible"):
        mt.MEADSSampler(target, 30, DIM, n_folds=4, device="cpu")
    with pytest.raises(ValueError, match=">= 4 chains per fold"):
        mt.MEADSSampler(target, 8, DIM, n_folds=4, device="cpu")


# -- the dense metric (tests/test_dense_metric.py) --------------------------------


def test_welford_covariance_matches_numpy_and_shrinks():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 3))
    chol = np.linalg.cholesky(a @ a.T + np.eye(3))
    x = (rng.standard_normal((4096, 3)) @ chol.T).astype(np.float32)
    w = thmc.welford_init((3, 3), torch.float32, "cpu")
    for i in range(0, 4096, 256):  # batched folds, like warmup
        w = thmc.welford_update_batch(w, _t(x[i:i + 256]))
    np.testing.assert_allclose(
        thmc.welford_covariance(w, regularize=False).numpy(), np.cov(x.T),
        rtol=0.02, atol=0.02)
    empty = thmc.welford_init((3, 3), torch.float32, "cpu")
    np.testing.assert_allclose(thmc.welford_covariance(empty).numpy(),
                               1e-3 * np.eye(3), atol=1e-6)


def test_dense_sampler_determinism_validation_and_frozen_mass():
    target, _ = _ar1()

    def go(adapt_mass=True):
        s = mt.HMCSampler(target, 8, DIM, seed=11, n_leapfrog=8,
                          metric="dense", device="cpu")
        s.init_ball(np.zeros(DIM), scale=0.5, seed=12)
        s.warmup(30, adapt_mass=adapt_mass)
        s.run(30)
        return s

    a = go()
    assert isinstance(a.inv_mass, DenseMassMatrix)
    np.testing.assert_array_equal(a.get_samples(), go().get_samples())
    frozen = go(adapt_mass=False)
    np.testing.assert_array_equal(frozen.inv_mass.cov.numpy(),
                                  np.eye(DIM, dtype=np.float32))
    with pytest.raises(ValueError, match="metric must be"):
        mt.HMCSampler(target, 4, DIM, metric="full", device="cpu")
