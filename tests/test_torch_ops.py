"""The port's elementwise ops, partner selection and ACT against the JAX
package, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu.analysis.autocorr import autocorr_time as j_autocorr_time
from mcmcpp_tpu.analysis.autocorr import normalized_autocov as j_autocov
from mcmcpp_tpu.ops.gw import gw_logpdf as j_gw_logpdf
from mcmcpp_tpu.ops.gw import gw_sample as j_gw_sample
from mcmcpp_tpu_torch.analysis import autocorr_time, normalized_autocov
from mcmcpp_tpu_torch.ops.gw import gw_logpdf, gw_sample
from mcmcpp_tpu_torch.ops.partner import (
    distinct_shifts,
    rolled_partners,
    select_partners,
)

torch.set_num_threads(1)

# float32 elementwise formulas evaluated in the same order: ULP level; the
# absolute floor covers log g(z) near 0, where -0.5·log z - log(norm)
# cancels and one ULP of either term is a large relative error
GW_RTOL = 1e-6
GW_ATOL = 1e-7
# float32 FFTs of two libraries, averaged over walkers, then the same
# numpy window
ACT_RTOL = 1e-4


@pytest.mark.parametrize("a", [2.0, 1.5, 3.0])
def test_gw_sample_matches_jax(a):
    u = np.random.default_rng(0).uniform(size=1000).astype(np.float32)
    u[:2] = [0.0, np.nextafter(np.float32(1), np.float32(0))]
    got = gw_sample(torch.from_numpy(u), a).numpy()
    np.testing.assert_allclose(got, np.asarray(j_gw_sample(jnp.asarray(u), a)),
                               rtol=GW_RTOL)
    assert got.min() >= 1 / a * (1 - 1e-6)
    assert got.max() <= a * (1 + 1e-6)


@pytest.mark.parametrize("a", [2.0, 1.5, 3.0])
def test_gw_logpdf_matches_jax(a):
    z = np.random.default_rng(1).uniform(0.2, 3.5, size=1000).astype(
        np.float32)
    got = gw_logpdf(torch.from_numpy(z), a).numpy()
    want = np.asarray(j_gw_logpdf(jnp.asarray(z), a))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got).any() and np.isfinite(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=GW_RTOL,
                               atol=GW_ATOL)


@pytest.mark.parametrize("r", [0, 1, 17, 63])
def test_roll_partners_equal_jnp_roll(r):
    other = np.random.default_rng(r).normal(size=(64, 5)).astype(np.float32)
    got = select_partners(torch.from_numpy(other), 64,
                          torch.tensor([r], dtype=torch.int32))[0]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.roll(other, -r, axis=0)))


def test_rolled_partners_stack_k_shifts():
    other = np.arange(12, dtype=np.float32).reshape(6, 2)
    shifts = torch.tensor([2, 5], dtype=torch.int32)
    got = rolled_partners(torch.from_numpy(other), shifts).numpy()
    for j, r in enumerate([2, 5]):
        np.testing.assert_array_equal(got[j], np.roll(other, -r, axis=0))


def test_distinct_shifts_distinct_and_in_range():
    gen = torch.Generator().manual_seed(0)
    for _ in range(200):
        s = distinct_shifts(gen, 5, 4, "cpu")
        assert s.dtype == torch.int32 and s.shape == (4,)
        assert len(set(s.tolist())) == 4
        assert 0 <= int(s.min()) and int(s.max()) < 5
    with pytest.raises(ValueError):
        distinct_shifts(gen, 3, 4, "cpu")


def _ar1(phi, n_steps, n_walkers, n_params=1, seed=0):
    """AR(1) chains (S, W, P); true integrated ACT (1 + phi)/(1 - phi)."""
    rng = np.random.default_rng(seed)
    x = np.empty((n_steps, n_walkers, n_params))
    x[0] = rng.normal(size=(n_walkers, n_params)) / np.sqrt(1 - phi ** 2)
    eps = rng.normal(size=(n_steps, n_walkers, n_params))
    for t in range(1, n_steps):
        x[t] = phi * x[t - 1] + eps[t]
    return x.astype(np.float32)


@pytest.mark.parametrize(
    "phi,n_steps,method",
    [(0.5, 4000, "sokal"), (0.9, 4000, "sokal"), (0.9, 4000, "geyer"),
     (0.99, 60, "sokal")],
)
def test_autocorr_time_matches_jax(phi, n_steps, method):
    x = _ar1(phi, n_steps, 16, n_params=2)
    got = autocorr_time(x, method=method, device="cpu")
    want = np.asarray(j_autocorr_time(x, method=method))
    np.testing.assert_allclose(got, want, rtol=ACT_RTOL)
    assert np.all(got > 0)
    if n_steps > 1000:
        np.testing.assert_allclose(got, (1 + phi) / (1 - phi), rtol=0.3)


@pytest.mark.parametrize("case", ["never_closes", "closes"])
def test_sokal_window_flag_matches_jax(case):
    """The negative never-closed flag, compared on ρ itself: for a real
    series the zero-padded autocovariance of the centered data sums to ½
    over all lags, so τ returns to 0 at the last lag and the window always
    closes by then; ρ ≡ 1 (τ(m) = 2m+1) is the never-closing input."""
    from mcmcpp_tpu.analysis.autocorr import _sokal_window_tau as j_window
    from mcmcpp_tpu_torch.analysis.autocorr import _sokal_window_tau

    rho = (np.ones(128) if case == "never_closes"
           else 0.9 ** np.arange(128.0))
    got = _sokal_window_tau(rho, 4.0)
    assert got == j_window(rho, 4.0)
    assert (got < 0) == (case == "never_closes")


def test_autocorr_time_walker_chunk_and_2d():
    x = _ar1(0.7, 2000, 12)[:, :, 0]
    full = autocorr_time(x, device="cpu")
    assert isinstance(full, float)
    np.testing.assert_allclose(
        autocorr_time(x, walker_chunk=5, device="cpu"), full, rtol=1e-6)
    np.testing.assert_allclose(full, float(j_autocorr_time(x)),
                               rtol=ACT_RTOL)
    sub = autocorr_time(x, walkers_to_use=6, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    assert 0 < sub < 3 * full


def test_normalized_autocov_matches_jax():
    x = _ar1(0.8, 500, 3)[:, :, 0].T
    got = normalized_autocov(x, device="cpu")
    np.testing.assert_allclose(got, np.asarray(j_autocov(x)), rtol=ACT_RTOL,
                               atol=1e-5)
    assert got.shape == (3, 500) and np.allclose(got[:, 0], 1.0)
    np.testing.assert_allclose(normalized_autocov(x[0], device="cpu"),
                               got[0], rtol=1e-6)
