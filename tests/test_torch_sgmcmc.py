"""SGLD and SGHMC: the port replays the JAX package's step, and mirrors the
non-slow tests of ``tests/test_sgmcmc.py``.

Conjugate Gaussian with an analytic posterior: y_i ~ N(theta, I), theta ~
N(0, I), N = 2048 rows, P = 3. The replays hand the port the minibatch rows
and the normals that the JAX step drew (``sgmcmc.py:250-263``,
``:283-302``) at a step of the decay schedule past its start: positions,
velocities and the stored minibatch logp estimate at rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.gradient.sgmcmc import SGState as JSGState
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.gradient.sgmcmc import SGState

torch.set_num_threads(1)

DIM, N_DATA, C = 3, 2048, 16


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    theta_true = np.array([0.5, -0.3, 0.2], np.float32)
    y = (theta_true + rng.standard_normal((N_DATA, DIM))).astype(np.float32)
    prec = 1.0 + N_DATA
    return y, (y.sum(axis=0) / prec), 1.0 / prec


def logprior(t):
    return -0.5 * torch.sum(t * t, dim=-1)


def loglike(t, batch):
    d = batch[None, :, :] - t[:, None, :]
    return -0.5 * torch.sum(d * d, dim=(1, 2))


def j_logprior(t):
    return -0.5 * jnp.sum(t * t)


def j_loglike(t, batch):
    d = batch - t[None, :]
    return -0.5 * jnp.sum(d * d)


@pytest.mark.parametrize("cls", ["SGLDSampler", "SGHMCSampler"])
def test_step_replays_jax(problem, cls):
    y = problem[0]
    kw = dict(batch_size=64, step_size=1e-3, step_size_decay=(100.0, 0.55))
    j = getattr(jref, cls)(j_logprior, j_loglike, y, n_chains=C,
                           n_params=DIM, seed=1, **kw)
    t = getattr(mt, cls)(logprior, loglike, y, C, DIM, device="cpu", **kw)
    rng = np.random.default_rng(2)
    pos = (0.3 * rng.normal(size=(C, DIM))).astype(np.float32)
    vel = (0.01 * rng.normal(size=(C, DIM))).astype(np.float32)
    key = jax.random.key(3)
    sj, (pj, lpj) = jax.jit(j._step)(
        key, JSGState(jnp.asarray(pos), jnp.asarray(vel), jnp.int32(37)))
    k_batch, k_noise = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.randint(
                 k_batch, (64,), 0, N_DATA))).long(),
             torch.from_numpy(np.array(jax.random.normal(
                 k_noise, (C, DIM), jnp.float32))))
    st, (pt, lpt) = t.apply(noise, SGState(torch.from_numpy(pos),
                                           torch.from_numpy(vel), 37))
    assert st.step == int(sj.step) == 38
    for a, b in ((st.position, sj.position), (st.velocity, sj.velocity),
                 (pt, pj), (lpt, lpj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_decay_schedule(problem):
    s = mt.SGLDSampler(logprior, loglike, problem[0], 8, DIM, batch_size=128,
                       seed=1, step_size=1e-4, step_size_decay=(100.0, 0.55),
                       device="cpu")
    assert abs(float(s._eps_at(0)) - 1e-4) < 1e-9
    e1k = float(s._eps_at(1000))
    assert abs(e1k - 1e-4 * 11.0 ** -0.55) / e1k < 1e-4
    s.init_ball(np.zeros(DIM), scale=0.1, seed=2)
    assert s.run(50)
    assert s.get_samples().shape == (50, 8, DIM) and s.state.step == 50


def test_deterministic_given_seed(problem):
    def go(cls):
        s = cls(logprior, loglike, problem[0], 8, DIM, batch_size=64, seed=7,
                step_size=1e-4, device="cpu")
        s.init_ball(np.zeros(DIM), scale=0.1, seed=8)
        s.run(40, thin=3)  # 13 stored, one leftover step
        assert s.state.step == 40
        return s.get_samples()

    for cls in (mt.SGLDSampler, mt.SGHMCSampler):
        np.testing.assert_array_equal(go(cls), go(cls))


def test_validation(problem):
    y = problem[0]
    with pytest.raises(ValueError, match="batch_size"):
        mt.SGLDSampler(logprior, loglike, y, 8, DIM, batch_size=0,
                       device="cpu")
    with pytest.raises(ValueError, match="step_size_decay"):
        mt.SGLDSampler(logprior, loglike, y, 8, DIM, batch_size=64,
                       step_size_decay=(0.0, 0.5), device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        mt.SGLDSampler(logprior, loglike, {"a": y, "b": y[:5]}, 8, DIM,
                       batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="friction"):
        mt.SGHMCSampler(logprior, loglike, y, 8, DIM, batch_size=64,
                        friction=0.0, device="cpu")


def test_logp_estimate_tracks_full_logp(problem):
    """The stored minibatch estimate is unbiased for prior + full-data
    loglike (a wrong N/B scale shows here)."""
    y = problem[0]
    s = mt.SGLDSampler(logprior, loglike, y, 8, DIM, batch_size=256, seed=3,
                       step_size=1e-10, device="cpu")
    theta = np.full((8, DIM), 0.45, np.float32)
    s.init(theta)
    s.run(300)
    t = torch.from_numpy(theta[:1])
    full = float(logprior(t) + loglike(t, torch.from_numpy(y)))
    assert abs(s.get_log_probs().mean() - full) / abs(full) < 0.02


@pytest.mark.parametrize("cls,step", [(mt.SGLDSampler, 2e-5),
                                      (mt.SGHMCSampler, 1e-5)])
def test_posterior_moments(problem, cls, step):
    """The slow JAX test at 16 chains × 1500 steps: the mean within 4
    posterior sd, the variance ratio in (0.5, 2.5)."""
    y, post_mean, post_var = problem
    s = cls(logprior, loglike, y, 16, DIM, batch_size=256, seed=1,
            step_size=step, device="cpu")
    s.init_ball(np.zeros(DIM), scale=0.1, seed=2)
    s.run(1500)
    flat = s.get_samples(burn_in=500, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), post_mean,
                               atol=4 * np.sqrt(post_var))
    ratio = flat.var(axis=0) / post_var
    assert np.all(ratio > 0.5) and np.all(ratio < 2.5), ratio
