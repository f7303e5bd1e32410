"""pCN and elliptical slice sampling in the port against the JAX package,
on the CPU.

One pCN step and one elliptical slice step replay JAX's ``_step`` with the
draws JAX made from its key (the prior normals, log u; the slice height's
uniform, the initial angle and every shrink iteration's uniforms): positions
and log-likelihoods within 1e-5 (float32: the prior product sums in another
order, and torch's sin and cos may differ from XLA's in the last bit), the
accept masks and the cap's fallback equal. The elliptical loop's host test
every ``CHECK_EVERY`` iterations gives the bits of a test every iteration.
The rest mirrors ``tests/test_pcn.py`` and ``tests/test_elliptical.py`` at
small sizes (C ≤ 64), with their bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import PCNSampler as JPCN
from mcmcpp_tpu.elliptical import EllipticalSliceSampler as JESS
import mcmcpp_tpu_torch as mt

torch.set_num_threads(1)

DIM = 4
TOL = 1e-5
F32 = jnp.float32


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gauss():
    """The JAX tests' conjugate problem: prior N(0, Σ) with Σ = AAᵀ/4 + I,
    y ~ N(f, 0.5 I); the closed-form posterior."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((DIM, DIM))
    prior_cov = a @ a.T / DIM + np.eye(DIM)
    chol = np.linalg.cholesky(prior_cov)
    sigma2 = 0.5
    y = rng.standard_normal(DIM) * 1.5
    post_cov = np.linalg.inv(np.linalg.inv(prior_cov) + np.eye(DIM) / sigma2)
    post_mean = post_cov @ (y / sigma2)
    yj, yt = jnp.asarray(y, F32), torch.from_numpy(y.astype(np.float32))

    def jl(f):
        return -0.5 * jnp.sum((yj - f) ** 2) / sigma2

    def tl(f):
        return -0.5 * torch.sum((yt - f) ** 2) / sigma2

    return dict(jl=jl, tl=tl, chol=chol, post_mean=post_mean,
                post_cov=post_cov)


def _close(t_state, j_state, fields):
    for name in fields:
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("beta", [0.4, 1.0])
def test_pcn_step_replays_jax(gauss, beta):
    c = 64
    j = JPCN(gauss["jl"], prior_mean=np.full(DIM, 0.3),
             prior_chol=gauss["chol"], beta=beta, n_chains=c, seed=1)
    j.init_prior(seed=2)
    t = mt.PCNSampler(gauss["tl"], prior_mean=np.full(DIM, 0.3),
                      prior_chol=gauss["chol"], beta=beta, n_chains=c,
                      device="cpu")
    t.init(np.asarray(j.state.position))
    np.testing.assert_allclose(t.state.loglike.numpy(),
                               np.asarray(j.state.loglike), rtol=TOL)
    state = j.state
    for i in range(3):
        key = jax.random.key(10 + i)
        k_nu, k_acc = jax.random.split(key)
        noise = (_t(jax.random.normal(k_nu, (c, DIM), F32)),
                 _t(-jax.random.exponential(k_acc, (c,), F32)))
        new_j = j._step(key, state)
        new_t = t.apply(noise, mt.pcn.PCNState(
            _t(state.position), _t(state.loglike), _t(state.accepted)))
        _close(new_t, new_j, ("position", "loglike"))
        np.testing.assert_array_equal(new_t.accepted.numpy(),
                                      np.asarray(new_j.accepted))
        state = new_j
    n_acc = int(np.asarray(state.accepted).sum())
    assert 0 < n_acc


def jax_ess_noise(key, c, max_shrink):
    """``EllipticalSliceSampler._step``'s draws from ``key``: z, u, theta
    and the shrink loop's uniform planes, one per iteration."""
    k_nu, k_u, k_theta, k_shrink = jax.random.split(key, 4)
    planes, k = [], k_shrink
    for _ in range(max_shrink):
        k, sub = jax.random.split(k)
        planes.append(_t(jax.random.uniform(sub, (c,), F32)))
    return (_t(jax.random.normal(k_nu, (c, DIM), F32)),
            _t(jax.random.uniform(k_u, (c,), F32, minval=1e-37)),
            _t(jax.random.uniform(k_theta, (c,), F32, 0.0, 2.0 * jnp.pi)),
            lambda j: planes[j])


@pytest.mark.parametrize("max_shrink,check_every", [(64, 4), (64, 1),
                                                    (3, 4), (2, 1)])
def test_elliptical_step_replays_jax(gauss, max_shrink, check_every,
                                     monkeypatch):
    """max_shrink 2 and 3 leave chains at the cap, which keep their state
    in both packages."""
    c = 64
    j = JESS(gauss["jl"], prior_mean=np.zeros(DIM), prior_chol=gauss["chol"],
             n_chains=c, seed=1, max_shrink=max_shrink)
    j.init_prior(seed=2)
    t = mt.EllipticalSliceSampler(
        gauss["tl"], prior_mean=np.zeros(DIM), prior_chol=gauss["chol"],
        n_chains=c, max_shrink=max_shrink, device="cpu")
    monkeypatch.setattr(mt.elliptical, "CHECK_EVERY", check_every)
    t.init(np.asarray(j.state.position))
    state = j.state
    kept = 0
    for i in range(3):
        key = jax.random.key(20 + i)
        new_j = j._step(key, state)
        new_t = t.apply(jax_ess_noise(key, c, max_shrink),
                        mt.elliptical.EllipticalState(_t(state.position),
                                                      _t(state.loglike)))
        _close(new_t, new_j, ("position", "loglike"))
        kept += int(np.all(np.asarray(new_j.position)
                           == np.asarray(state.position), axis=1).sum())
        state = new_j
    if max_shrink < 4:
        assert kept > 0  # the cap's fallback was exercised
    assert t.counters["steps"] == 3
    assert t.counters["syncs"] <= t.counters["iterations"]


def test_elliptical_check_interval_gives_the_same_bits(gauss, monkeypatch):
    """A host test every iteration, every 4 and every 64 (one test, at the
    cap): the same draws give the same bits."""
    outs = []
    for every in (1, 4, 64):
        t = mt.EllipticalSliceSampler(
            gauss["tl"], prior_mean=np.zeros(DIM), prior_chol=gauss["chol"],
            n_chains=32, seed=3, device="cpu")
        monkeypatch.setattr(mt.elliptical, "CHECK_EVERY", every)
        t.init_prior(seed=4)
        noise = list(t.draw_noise()[:3])
        gen = torch.Generator().manual_seed(5)
        planes = [torch.rand(32, generator=gen) for _ in range(64)]
        outs.append((t.apply((*noise, lambda j: planes[j]), t.state),
                     dict(t.counters)))
    for state, _ in outs[1:]:
        for a, b in zip(state, outs[0][0]):
            assert torch.equal(a, b)
    assert outs[0][1]["syncs"] == outs[0][1]["iterations"]
    assert outs[2][1]["syncs"] == 1


# -- pCN mirrors (tests/test_pcn.py) ------------------------------------------


def test_pcn_gaussian_posterior_moments(gauss):
    s = mt.PCNSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                      prior_chol=gauss["chol"], beta=0.35, n_chains=64,
                      seed=1, device="cpu")
    s.init_prior(seed=2)
    s.run(500)
    s.chain.clear()
    s.run(3000, thin=2)
    flat = s.get_samples(flat=True)
    np.testing.assert_allclose(
        flat.mean(axis=0), gauss["post_mean"],
        atol=5 * np.sqrt(gauss["post_cov"].max() / 500))
    np.testing.assert_allclose(np.cov(flat.T), gauss["post_cov"], atol=0.12)
    assert 0.1 < s.acceptance_fraction < 0.9


def _gp_chol(p):
    x = np.linspace(0.0, 1.0, p)
    k = np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.2) ** 2)
    return np.linalg.cholesky(k + 1e-6 * np.eye(p))


def test_pcn_acceptance_dimension_robust():
    """THE pCN property (Cotter et al. 2013 §4): at a fixed β and a
    likelihood of fixed information, acceptance stays flat as the GP grid
    refines P = 32 -> P = 256 (the JAX test's 64 -> 1024, cut for the
    CPU)."""
    rates = {}
    for p in (32, 256):
        s = mt.PCNSampler(
            lambda f: -0.5 * torch.square(torch.mean(f) - 0.7) / 0.01,
            prior_mean=np.zeros(p), prior_chol=_gp_chol(p), beta=0.3,
            n_chains=64, seed=3, device="cpu")
        s.init_prior(seed=4)
        s.run(400)
        rates[p] = s.acceptance_fraction
    assert 0.15 < rates[32] < 0.95 and 0.15 < rates[256] < 0.95
    assert abs(rates[32] - rates[256]) < 0.08, rates


def test_pcn_beta_one_is_prior_independence_sampler(gauss):
    prior_cov = gauss["chol"] @ gauss["chol"].T
    s = mt.PCNSampler(lambda f: torch.zeros(()), prior_mean=np.full(DIM, 2.0),
                      prior_chol=gauss["chol"], beta=1.0, n_chains=64, seed=5,
                      device="cpu")
    s.init_prior(seed=6)
    s.run(400)
    flat = s.get_samples(burn_in=50, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), 2.0, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), prior_cov, atol=0.15)
    assert s.acceptance_fraction == 1.0


def test_pcn_validation(gauss):
    tl, chol = gauss["tl"], gauss["chol"]
    for beta in (0.0, 1.5):
        with pytest.raises(ValueError, match="beta"):
            mt.PCNSampler(tl, prior_mean=np.zeros(DIM), prior_chol=chol,
                          beta=beta, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        mt.PCNSampler(tl, prior_mean=np.zeros(DIM), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        mt.PCNSampler(tl, prior_mean=np.zeros(DIM), prior_chol=chol,
                      prior_scale=np.ones(DIM), device="cpu")
    with pytest.raises(ValueError, match="prior_chol"):
        mt.PCNSampler(tl, prior_mean=np.zeros(DIM), prior_chol=chol[:2],
                      device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        mt.PCNSampler(tl, prior_mean=np.zeros(DIM), prior_chol=chol,
                      device="cpu").run(5)


def test_pcn_tune_reaches_target_band_and_freezes(gauss):
    s = mt.PCNSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                      prior_chol=gauss["chol"], beta=1.0, n_chains=64,
                      seed=21, device="cpu")
    s.init_prior(seed=22)
    s.tune(n_steps=800, target=0.3, window=20)
    assert s.beta < 1.0
    frozen = s.beta
    assert s.total_steps == 0
    s.run(1200)
    assert s.beta == frozen
    assert 0.15 < s.acceptance_fraction < 0.5, s.acceptance_fraction
    flat = s.get_samples(burn_in=200, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), gauss["post_mean"],
                               atol=0.2)


def test_pcn_tune_raises_uninitialized_and_bad_target(gauss):
    s = mt.PCNSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                      prior_chol=gauss["chol"], device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        s.tune()
    s.init_prior(seed=23)
    with pytest.raises(ValueError, match="target"):
        s.tune(target=1.5)


def test_pcn_post_tune_run_uses_the_tuned_beta(gauss):
    """β is a plain float read every step (no program per β to go stale):
    the run after ``tune`` accepts at the tuned β's rate."""
    s = mt.PCNSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                      prior_chol=gauss["chol"], beta=1.0, n_chains=64,
                      seed=24, device="cpu")
    s.init_prior(seed=25)
    s.run(50)
    acc_before = s.acceptance_fraction
    s.chain.clear()
    s.tune(n_steps=400, target=0.3, window=20)
    s.run(400)
    assert s.beta != 1.0
    assert s.acceptance_fraction > acc_before + 0.05


# -- elliptical mirrors (tests/test_elliptical.py) ----------------------------


def test_elliptical_gaussian_posterior_moments(gauss):
    s = mt.EllipticalSliceSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                                  prior_chol=gauss["chol"], n_chains=64,
                                  seed=1, device="cpu")
    s.init_prior(seed=2)
    s.run(200)
    s.chain.clear()
    s.run(1000)
    flat = s.get_samples(flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), gauss["post_mean"],
                               atol=4 * np.sqrt(gauss["post_cov"].max()
                                                / 400))
    np.testing.assert_allclose(np.cov(flat.T), gauss["post_cov"], atol=0.1)
    np.testing.assert_allclose(
        s.get_log_likes()[-1],
        torch.func.vmap(gauss["tl"])(torch.from_numpy(
            s.get_samples()[-1])).numpy(), rtol=1e-5, atol=1e-5)


def test_elliptical_constant_likelihood_reduces_to_prior(gauss):
    prior_cov = gauss["chol"] @ gauss["chol"].T
    s = mt.EllipticalSliceSampler(lambda f: torch.zeros(()),
                                  prior_mean=np.full(DIM, 2.0),
                                  prior_chol=gauss["chol"], n_chains=64,
                                  seed=3, device="cpu")
    s.init_prior(seed=4)
    s.run(800)
    flat = s.get_samples(burn_in=100, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), np.full(DIM, 2.0),
                               atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), prior_cov, atol=0.25)
    # every proposal meets a flat likelihood's threshold at once: one host
    # test a step, after the first group of CHECK_EVERY iterations
    assert s.counters["syncs"] == s.counters["steps"] == 800
    assert s.counters["iterations"] == 4 * 800


def test_elliptical_diag_prior_scale_path():
    scales = np.array([0.5, 1.0, 2.0], np.float32)
    s = mt.EllipticalSliceSampler(lambda f: torch.zeros(()),
                                  prior_mean=np.zeros(3), prior_scale=scales,
                                  n_chains=64, seed=5, device="cpu")
    s.init_prior(seed=6)
    s.run(800)
    flat = s.get_samples(burn_in=100, flat=True)
    np.testing.assert_allclose(flat.std(axis=0), scales, rtol=0.1)


def test_elliptical_deterministic_given_seed(gauss):
    def go():
        s = mt.EllipticalSliceSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                                      prior_chol=gauss["chol"], n_chains=8,
                                      seed=11, device="cpu")
        s.init_prior(seed=12)
        s.run(30)
        return s.get_samples()

    np.testing.assert_array_equal(go(), go())


def test_elliptical_leftover_transitions_advance_state(gauss):
    s = mt.EllipticalSliceSampler(gauss["tl"], prior_mean=np.zeros(DIM),
                                  prior_chol=gauss["chol"], n_chains=8,
                                  seed=21, device="cpu")
    s.init_prior(seed=22)
    before = s.state.position.clone()
    assert s.run(1, thin=2)  # n_store = 0, leftover = 1
    assert s.get_samples().shape[0] == 0
    assert not torch.equal(s.state.position, before)


def test_elliptical_validation(gauss):
    tl, chol = gauss["tl"], gauss["chol"]
    with pytest.raises(ValueError, match="exactly one"):
        mt.EllipticalSliceSampler(tl, prior_mean=np.zeros(DIM), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        mt.EllipticalSliceSampler(tl, prior_mean=np.zeros(DIM),
                                  prior_chol=chol, prior_scale=np.ones(DIM),
                                  device="cpu")
    with pytest.raises(ValueError, match="prior_chol"):
        mt.EllipticalSliceSampler(tl, prior_mean=np.zeros(DIM),
                                  prior_chol=chol[:2], device="cpu")
    with pytest.raises(ValueError, match="positions"):
        mt.EllipticalSliceSampler(tl, prior_mean=np.zeros(DIM),
                                  prior_chol=chol, n_chains=4,
                                  device="cpu").init(np.zeros((3, DIM)))
    with pytest.raises(RuntimeError, match="init"):
        mt.EllipticalSliceSampler(tl, prior_mean=np.zeros(DIM),
                                  prior_chol=chol, device="cpu").run(2)


def test_batched_likelihoods_match_per_chain(gauss):
    """``batched=True`` takes a (C, P) -> (C,) likelihood: the same draws
    give the same bits as the vmapped per-chain one."""
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        DIM).astype(np.float32) * 1.5)

    def per_chain(f):
        return -0.5 * torch.sum((y - f) ** 2) / 0.5

    def batched(f):
        return -0.5 * torch.sum((y - f) ** 2, dim=-1) / 0.5

    for cls in (mt.PCNSampler, mt.EllipticalSliceSampler):
        runs = []
        for fn, b in ((per_chain, False), (batched, True)):
            s = cls(fn, prior_mean=np.zeros(DIM), prior_chol=gauss["chol"],
                    n_chains=16, seed=7, batched=b, device="cpu")
            s.init_prior(seed=8)
            s.run(10)
            runs.append(s.get_samples())
        np.testing.assert_array_equal(*runs)
