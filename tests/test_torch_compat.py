"""The port's emcee surface, mirroring ``tests/test_compat_emcee.py`` with the
sampler on the CPU, and held against the JAX package's facade where the two
share no random stream: the same start through both gives chains of the same
shapes, per-walker acceptance in the same window, and moments within the
tolerances of the JAX test.
"""

import numpy as np
import pytest
import torch

from mcmcpp_tpu.compat.emcee import EnsembleSampler as JaxEmcee
from mcmcpp_tpu_torch import DESnookerMove, DRAMMove, StretchMove
from mcmcpp_tpu_torch.compat.emcee import EnsembleSampler, State
from tests.targets import skewed_gaussian_cov, skewed_gaussian_logp

torch.set_num_threads(1)

EPS = 0.13


def skewed(t):
    a, b = t[0] / 2 - t[1], t[0] / 2 + t[1]
    return -0.5 * (a * a / EPS + b * b)


def test_emcee_workflow_end_to_end_beside_the_jax_facade():
    rng = np.random.default_rng(0)
    nwalkers, ndim = 64, 2
    p0 = rng.normal(scale=0.3, size=(nwalkers, ndim))
    s = EnsembleSampler(nwalkers, ndim, skewed, seed=5, device="cpu")
    j = JaxEmcee(nwalkers, ndim, skewed_gaussian_logp, seed=5)
    state = s.run_mcmc(p0, 100, store=False)
    j.run_mcmc(p0, 100, store=False)
    assert isinstance(state, State)
    assert state.coords.shape == (nwalkers, ndim)
    assert state.log_prob.shape == (nwalkers,)
    assert isinstance(state.coords, np.ndarray)
    np.testing.assert_allclose(
        state.log_prob, [float(skewed_gaussian_logp(x)) for x in state.coords],
        rtol=1e-5, atol=1e-5)
    s.run_mcmc(None, 300)  # continue from the current state, emcee-style
    j.run_mcmc(None, 300)
    for a, b in [(s.get_chain(), j.get_chain()),
                 (s.get_chain(discard=50, thin=2), j.get_chain(discard=50,
                                                               thin=2)),
                 (s.get_chain(flat=True), j.get_chain(flat=True)),
                 (s.get_log_prob(discard=50), j.get_log_prob(discard=50)),
                 (s.acceptance_fraction, j.acceptance_fraction)]:
        assert a.shape == b.shape and a.dtype == b.dtype
    chain = s.get_chain(discard=50, flat=True)
    np.testing.assert_allclose(np.cov(chain.T), skewed_gaussian_cov(),
                               atol=0.15)
    af = s.acceptance_fraction
    assert af.shape == (nwalkers,)
    assert 0.3 < af.mean() < 0.95
    assert abs(af.mean() - j.acceptance_fraction.mean()) < 0.05
    tau = s.get_autocorr_time(discard=50, quiet=True)
    assert tau.shape == (ndim,) and np.all(tau > 0)
    np.testing.assert_allclose(
        tau, j.get_autocorr_time(discard=50, quiet=True), rtol=0.5)


def test_args_kwargs_partial_application():
    def logp(theta, scale, offset=0.0):
        return -0.5 * ((theta[0] - offset) / scale) ** 2

    s = EnsembleSampler(32, 1, logp, args=(2.0,), kwargs={"offset": 1.0},
                        device="cpu")
    s.run_mcmc(np.random.default_rng(1).normal(size=(32, 1)), 400)
    flat = s.get_chain(discard=100, flat=True)
    assert abs(flat.mean() - 1.0) < 0.4
    assert abs(flat.std() - 2.0) < 0.5


def test_moves_list_maps_to_mixture():
    s = EnsembleSampler(
        64, 2, skewed, device="cpu",
        moves=[(StretchMove(a=2.0), 0.7), (DESnookerMove(), 0.3)],
    )
    s.run_mcmc(np.random.default_rng(2).normal(size=(64, 2)), 100)
    assert s.get_chain().shape[0] == 100
    assert type(s.backend.mover).__name__ == "MixtureMover"
    s2 = EnsembleSampler(64, 2, skewed, moves=[StretchMove()], device="cpu")
    s2.run_mcmc(np.random.default_rng(3).normal(size=(64, 2)), 10)
    assert isinstance(s2.backend.mover, StretchMove)
    s3 = EnsembleSampler(64, 2, skewed, moves=[DRAMMove()], device="cpu")
    s3.run_mcmc(np.random.default_rng(5).normal(size=(64, 2)), 50)
    assert s3.get_chain().shape == (50, 64, 2)
    assert np.isfinite(s3.get_log_prob()).all()


def test_autocorr_time_raises_when_too_short():
    s = EnsembleSampler(32, 2, skewed, device="cpu")
    s.run_mcmc(np.random.default_rng(4).normal(size=(32, 2)), 60)
    # 60 stored steps << 50*tau (tau ~ 5-7): emcee's length criterion
    with pytest.raises(RuntimeError, match="shorter than"):
        s.get_autocorr_time()
    with pytest.raises(RuntimeError, match="shorter than 200 times"):
        s.get_autocorr_time(tol=200)
    assert np.all(s.get_autocorr_time(quiet=True) > 0)


def test_thin_by_scales_tau_units_and_first_run_needs_a_state():
    s = EnsembleSampler(64, 1, lambda t: -0.5 * t[0] ** 2, seed=9,
                        device="cpu")
    with pytest.raises(ValueError, match="initial_state required"):
        s.run_mcmc(None, 10)
    s.run_mcmc(np.random.default_rng(5).normal(size=(64, 1)), 100, thin_by=4)
    assert s.get_chain().shape == (100, 64, 1)
    assert s.backend.state.step == 400
    assert s.run_mcmc(None, 10) is not None
    s.reset()
    assert s.get_chain().shape == (0, 64, 1)


def test_blobs_roundtrip():
    def logp_with_blobs(t):
        return -0.5 * (t * t).sum(), t.sum(), t * 2.0  # scalar + vector blob

    s = EnsembleSampler(16, 2, logp_with_blobs, seed=0, device="cpu")
    s.blob_chunk_rows = 100  # several device batches, the last one ragged
    s.run_mcmc(np.random.default_rng(0).normal(size=(16, 2)), 30)
    chain = s.get_chain()
    b_sum, b_vec = s.get_blobs()
    assert b_sum.shape == (30, 16) and b_vec.shape == (30, 16, 2)
    np.testing.assert_allclose(b_sum, chain.sum(-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b_vec, 2.0 * chain, rtol=1e-6)
    bf = s.get_blobs(discard=10, thin=2, flat=True)
    assert bf[0].shape == (10 * 16,) and bf[1].shape == (10 * 16, 2)
    init = np.random.default_rng(5).normal(size=(16, 2))
    s1 = EnsembleSampler(16, 2, lambda t: (-0.5 * (t * t).sum(), t[0]),
                         seed=7, device="cpu")
    s1.run_mcmc(init, 5)
    assert s1.get_blobs().shape == (5, 16)
    s0 = EnsembleSampler(16, 2, lambda t: -0.5 * (t * t).sum(), seed=7,
                         device="cpu")
    s0.run_mcmc(init, 5)
    assert s0.get_blobs() is None
    # same seed, same start: the blob channel does not touch the sampling
    np.testing.assert_array_equal(s0.get_chain(), s1.get_chain())
    np.testing.assert_array_equal(s0.get_log_prob(), s1.get_log_prob())
    with pytest.raises(ValueError, match="1-tuple"):
        EnsembleSampler(16, 2, lambda t: (-0.5 * (t * t).sum(),),
                        device="cpu")


def test_sample_generator_matches_emcee_surface():
    s = EnsembleSampler(32, 2, skewed, device="cpu")
    init = np.random.default_rng(6).normal(size=(32, 2))
    seen = []
    for state in s.sample(init, iterations=5, thin_by=2):
        assert state.coords.shape == (32, 2)
        assert np.isfinite(state.log_prob).all()
        seen.append(state.coords.copy())
    assert len(seen) == 5
    assert s.get_chain().shape == (5, 32, 2)
    np.testing.assert_array_equal(s.get_chain()[-1], seen[-1])
    next(iter(s.sample(iterations=1)))
    assert s.get_chain().shape == (6, 32, 2)
    for _ in s.sample(iterations=2, store=False):
        pass
    assert s.get_chain().shape == (6, 32, 2)


def test_device_passes_through_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        EnsembleSampler(16, 2, skewed)  # the default device is the card
    s = EnsembleSampler(16, 2, skewed, device="cpu", store_dtype="bfloat16")
    assert s.backend.device.type == "cpu"
    assert s.backend.chain.dtype == "bfloat16"
