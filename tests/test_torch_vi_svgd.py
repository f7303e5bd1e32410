"""The port's ADVI and SVGD held against the JAX package.

- ADVI, mean-field and full-rank: 20 steps of ``fit`` replayed in float64
  on the JAX package's ε (``fold_in(key, i)`` per step): the ELBO trace, the
  variational parameters and the Adam state agree to 1e-9.
- SVGD: one step, and ten, from the same cloud in float64, for an odd and an
  even particle count (the median of N² distances, even for even N, is the
  mean of the two middle order statistics in both): agree to 1e-9; the
  median itself equals ``jnp.median`` on 2^16 + 2^15 distances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import svgd as jsvgd
from mcmcpp_tpu import vi as jvi
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import svgd as tsvgd
from mcmcpp_tpu_torch.optim import adam_leaves

torch.set_num_threads(1)

TOL = 1e-9
P = 3
COV = np.array([[1.0, 0.6, 0.2], [0.6, 1.0, 0.3], [0.2, 0.3, 2.0]])
PREC = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0, 0.5])


def jax_logp(t):
    d = t - jnp.asarray(MEAN)
    return -0.5 * d @ (jnp.asarray(PREC) @ d) + 0.1 * jnp.sin(t[0])


def torch_logp(t):
    d = t - torch.from_numpy(MEAN)
    return (-0.5 * torch.sum((d @ torch.from_numpy(PREC)) * d, -1)
            + 0.1 * torch.sin(t[..., 0]))


@pytest.mark.parametrize("full_rank", [False, True])
def test_advi_fit_replays_jax_float64(full_rank):
    n_steps, n_mc, lr = 20, 8, 0.05
    with jax.enable_x64(True):
        j = jvi.ADVI(jax_logp, P, full_rank=full_rank, n_mc=n_mc,
                     learning_rate=lr, seed=3, dtype=jnp.float64)
        _, k = jax.random.split(j._key)
        eps = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(k, i), (n_mc, P), jnp.float64))
            for i in range(n_steps)])
        j.fit(n_steps)
        j_params = [np.asarray(x) for x in j.params]
        j_opt = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            j.opt_state)]
        j_mean, j_cov = j.mean, j.cov
    t = mt.ADVI(torch_logp, P, full_rank=full_rank, n_mc=n_mc,
                learning_rate=lr, dtype=torch.float64, batched=True,
                device="cpu")
    t.fit(n_steps, noise=torch.from_numpy(eps))
    np.testing.assert_allclose(t.elbo_trace, j.elbo_trace, rtol=TOL,
                               atol=TOL)
    for a, b in zip(j_params, t.params):
        np.testing.assert_allclose(b.numpy(), a, rtol=TOL, atol=TOL)
    got = adam_leaves(t.opt_state)
    assert len(got) == len(j_opt) == 5
    for a, b in zip(j_opt, got):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=1e-12)
    np.testing.assert_allclose(t.mean, j_mean, rtol=TOL)
    np.testing.assert_allclose(t.cov, j_cov, rtol=TOL, atol=TOL)
    assert t.sample(7).shape == (7, P)


def test_advi_recovers_gaussian_full_rank():
    """``tests/test_smc_vi.py::test_advi_recovers_gaussian`` (full rank) at
    its bounds."""
    cov = np.array([[1.0, 0.6], [0.6, 1.0]], np.float32)
    prec = torch.from_numpy(np.linalg.inv(cov))
    mean = torch.tensor([1.0, -2.0])

    def logp(t):
        d = t - mean
        return -0.5 * torch.sum((d @ prec) * d, -1)

    vi = mt.ADVI(logp, 2, full_rank=True, n_mc=32, learning_rate=0.05,
                 batched=True, device="cpu").fit(2000)
    np.testing.assert_allclose(vi.mean, [1.0, -2.0], atol=0.1)
    np.testing.assert_allclose(vi.cov, cov, atol=0.15)
    t = vi.elbo_trace
    assert np.mean(t[-100:]) > np.mean(t[:100])


def test_median_matches_jnp_median():
    rng = np.random.default_rng(0)
    for n in (1 << 16, (1 << 16) + (1 << 15) + 1):
        x = rng.exponential(size=n).astype(np.float32)
        want = float(jnp.median(jnp.asarray(x)))
        assert float(tsvgd.median(torch.from_numpy(x))) == want
    # an even count whose middle pair differs: the mean, not the lower one
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tsvgd.median(x)) == 2.5 == float(jnp.median(
        jnp.asarray(x.numpy())))


@pytest.mark.parametrize("n", [7, 8])
def test_svgd_steps_replay_jax_float64(n):
    x0 = np.random.default_rng(n).normal(size=(n, P)) * 1.5
    with jax.enable_x64(True):
        j = jsvgd.SVGD(jax_logp, n, P, step_size=0.1, dtype=jnp.float64)
        j.init(x0)
        j1 = np.asarray(j.fit(1).particles)
        j10 = j.fit(10)
        j10 = (np.asarray(j10.particles), np.asarray(j10.grad_norm_history))
    t = mt.SVGD(torch_logp, n, P, step_size=0.1, dtype=torch.float64,
                batched=True, device="cpu")
    t.init(x0)
    t1 = t.fit(1).particles.numpy()
    t10 = t.fit(10)
    np.testing.assert_allclose(t1, j1, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t10.particles.numpy(), j10[0], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t10.grad_norm_history.numpy(), j10[1],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t.get_samples(), j10[0], rtol=TOL, atol=TOL)


def test_svgd_fixed_bandwidth_and_validation():
    x0 = np.random.default_rng(3).normal(size=(6, P))
    with jax.enable_x64(True):
        j = jsvgd.SVGD(jax_logp, 6, P, bandwidth=0.7, dtype=jnp.float64)
        want = np.asarray(j.init(x0).fit(3).particles)
    t = mt.SVGD(torch_logp, 6, P, bandwidth=0.7, dtype=torch.float64,
                batched=True, device="cpu")
    np.testing.assert_allclose(t.init(x0).fit(3).particles.numpy(), want,
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="bandwidth"):
        mt.SVGD(torch_logp, 6, P, bandwidth=-1.0, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        mt.SVGD(torch_logp, 6, P, device="cpu").get_samples()
    if not torch.cuda.is_available():
        for make in (lambda: mt.SVGD(torch_logp, 6, P),
                     lambda: mt.ADVI(torch_logp, P)):
            with pytest.raises(RuntimeError, match="is_available"):
                make()
