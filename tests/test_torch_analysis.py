"""The port's Analysis layer against the JAX package's, on one seeded AR(1)
chain.

The numpy/scipy modules are copies, so their functions must give the JAX
package's numbers exactly where they are numpy alone (batch means,
multivariate ESS, the histograms, the percentiles, the streaming ACT, HDI,
nested R-hat, the posterior-predictive p-value). The functions that stand on
``autocorr_time`` (``effective_sample_size``, ``ess_bulk``, ``ess_tail``,
``mcse_mean``, ``mcse_quantile``, ``summary``'s ess columns) inherit the FFT of
their package (``jnp.fft`` there, ``torch.fft`` here, both float32): rtol 1e-4.
The covariance is a float32 sum over 2000 to 6400 rows, taken by torch here and
by XLA there in another order: rtol 5e-6 of the entry plus 5e-6 of the largest
variance (1.3e-6 is what the two show; float64 numpy is held to 1e-5).
"""

import numpy as np
import pytest
import torch

from mcmcpp_tpu import analysis as jan
from mcmcpp_tpu_torch import analysis as pan

torch.set_num_threads(1)

S, W, P = 400, 16, 3
FFT_RTOL = 1e-4
COV_RTOL = 5e-6


@pytest.fixture(scope="module")
def chain():
    """A stationary AR(1) chain (S, W, P) with phi = 0.5, 0.7, 0.85, offset
    and scaled per parameter, float32 as a sampler stores it."""
    rng = np.random.default_rng(0)
    phi = np.array([0.5, 0.7, 0.85])
    x = np.zeros((S, W, P))
    x[0] = rng.standard_normal((W, P))
    for t in range(1, S):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi ** 2) * rng.standard_normal(
            (W, P))
    return (x * [1.0, 3.0, 0.2] + [0.0, -2.0, 5.0]).astype(np.float32)


EXACT = [
    ("batch_means_ess", {}),
    ("batch_means_ess", {"n_batches": 10}),
    ("multivariate_ess", {}),
    ("nested_rhat", {"n_superchains": 4}),
    ("hdi", {"prob": 0.9}),
]
VIA_FFT = [
    ("effective_sample_size", {}),
    ("ess_bulk", {}),
    ("ess_tail", {}),
    ("ess_tail", {"prob": 0.1}),
    ("mcse_mean", {}),
    ("mcse_quantile", {"prob": 0.1}),
    ("mcse_quantile", {"prob": 0.5}),
    ("potential_scale_reduction", {}),
    ("potential_scale_reduction", {"rank_normalized": False}),
]


@pytest.mark.parametrize("name,kw", EXACT,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(EXACT)])
def test_numpy_copies_equal_exactly(chain, name, kw):
    got = getattr(pan, name)(chain, **kw)
    want = getattr(jan, name)(chain, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.isfinite(np.asarray(got)).all()


@pytest.mark.parametrize("name,kw", VIA_FFT,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(VIA_FFT)])
def test_fft_based_functions_agree(chain, name, kw):
    got = np.asarray(getattr(pan, name)(chain, **kw))
    want = np.asarray(getattr(jan, name)(chain, **kw))
    assert got.shape == want.shape == (P,)
    np.testing.assert_allclose(got, want, rtol=FFT_RTOL)
    assert np.isfinite(got).all()


def test_min_ess_required_and_ppc_pvalue(chain):
    for p, alpha, eps in [(1, 0.05, 0.05), (3, 0.05, 0.05), (10, 0.01, 0.1)]:
        assert pan.min_ess_required(p, alpha=alpha, eps=eps) == \
            jan.min_ess_required(p, alpha=alpha, eps=eps)
    rng = np.random.default_rng(1)
    obs, rep = rng.standard_normal(50), rng.standard_normal((200, 50))
    assert pan.ppc_pvalue(np.max, obs, rep) == jan.ppc_pvalue(np.max, obs, rep)


def test_summary_field_by_field(chain):
    got, want = pan.summary(chain, prob=0.9), jan.summary(chain, prob=0.9)
    assert list(got) == list(want)
    for key in want:
        if key in ("ess", "ess_bulk", "ess_tail", "mcse"):
            np.testing.assert_allclose(got[key], want[key], rtol=FFT_RTOL)
        else:
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["mean"], [0.0, -2.0, 5.0], atol=0.5)


def test_streaming_act_equals_jax_and_tracks_the_batch_estimate(chain):
    acts = [m.StreamingACT(max_lag=64) for m in (pan, jan)]
    for act in acts:
        for i in range(0, S, 90):
            act.update(chain[i:i + 90])
    np.testing.assert_array_equal(acts[0].autocorr_time(),
                                  acts[1].autocorr_time())
    np.testing.assert_array_equal(acts[0].normalized_autocov(),
                                  acts[1].normalized_autocov())
    np.testing.assert_array_equal(
        pan.autocorr_time_streaming(np.array_split(chain, 5), 64),
        jan.autocorr_time_streaming(np.array_split(chain, 5), 64))
    np.testing.assert_allclose(acts[0].autocorr_time(),
                               pan.autocorr_time(chain), rtol=0.05)
    with pytest.raises(ValueError, match="max_lag"):
        pan.StreamingACT(max_lag=0)


def test_corner_histograms_equal(chain, tmp_path):
    got = pan.CornerHistograms(n_bins=12).calculate(chain)
    want = jan.CornerHistograms(n_bins=12).calculate(chain)
    assert got.n_params == want.n_params == P
    for (gc, ge), (wc, we) in zip(got.hist1d, want.hist1d):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(ge, we)
        assert gc.sum() == S * W
    assert sorted(got.hist2d) == sorted(want.hist2d) == [(0, 1), (0, 2),
                                                        (1, 2)]
    for key in want.hist2d:
        for g, w in zip(got.hist2d[key], want.hist2d[key]):
            np.testing.assert_array_equal(g, w)
    got.save_csv(tmp_path / "p")
    want.save_csv(tmp_path / "j")
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "p").iterdir())
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_percentile_and_maximum_finder_equal(chain, tmp_path):
    got = pan.PercentileAndMaximumFinder(n_bins=256).process_chain_data(chain)
    want = jan.PercentileAndMaximumFinder(n_bins=256).process_chain_data(chain)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.edges, want.edges)
    for i in range(P):
        for pct in (2.5, 15.866, 50.0, 84.134, 97.5):
            v = got.get_value_from_percentile(i, pct)
            assert v == want.get_value_from_percentile(i, pct)
            assert got.get_percentile_from_value(i, v) == \
                want.get_percentile_from_value(i, v)
            assert got.get_percentile_from_value(i, v) == pytest.approx(
                pct, abs=0.5)
        assert got.get_peak_location(i) == want.get_peak_location(i)
    got.save_csv(tmp_path / "p")
    want.save_csv(tmp_path / "j")
    for f in (tmp_path / "j").iterdir():
        assert f.read_bytes() == (tmp_path / "p" / f.name).read_bytes()
    with pytest.raises(RuntimeError, match="process_chain_data"):
        pan.PercentileAndMaximumFinder().get_peak_location(0)


@pytest.mark.parametrize("kw", [{}, {"thin": 3}, {"burn_in": 50, "thin": 2}])
def test_covariance_and_correlation_against_jax(chain, kw):
    got = pan.covariance_matrix(chain, device="cpu", **kw)
    want = jan.covariance_matrix(chain, **kw)
    assert got.dtype == np.float64 and got.shape == (P, P)
    np.testing.assert_allclose(got, want, rtol=COV_RTOL,
                               atol=COV_RTOL * np.diag(want).max())
    np.testing.assert_allclose(
        pan.correlation_matrix(chain, device="cpu", **kw),
        jan.correlation_matrix(chain, **kw), rtol=COV_RTOL, atol=COV_RTOL)
    # a tensor is reduced where it lies; the flat (N, P) form agrees
    t = torch.from_numpy(chain)
    np.testing.assert_array_equal(pan.covariance_matrix(t, **kw), got)
    flat = chain[kw.get("burn_in", 0)::kw.get("thin", 1)].reshape(-1, P)
    np.testing.assert_array_equal(
        pan.covariance_matrix(flat, device="cpu"), got)
    ref = np.cov(flat.astype(np.float64).T)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.diag(ref).max())


def test_covariance_float64_stays_on_the_host(chain):
    x64 = chain.astype(np.float64)
    got = pan.covariance_matrix(x64)  # no device asked: np.cov, as in JAX
    np.testing.assert_array_equal(got, jan.covariance_matrix(x64))
    np.testing.assert_array_equal(
        got, pan.covariance_matrix(torch.from_numpy(x64)))
    with pytest.raises(ValueError, match=r"\(S, W, P\) or \(N, P\)"):
        pan.covariance_matrix(chain[0, 0], device="cpu")


def test_covariance_never_falls_back_to_the_cpu(chain):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        pan.covariance_matrix(chain)


def test_analysis_exports_the_jax_names_that_are_ported():
    ported = {"autocorr_time", "autocorr_time_streaming", "StreamingACT",
              "normalized_autocov", "covariance_matrix",
              "correlation_matrix", "CornerHistograms",
              "PercentileAndMaximumFinder", "effective_sample_size",
              "batch_means_ess", "ess_bulk", "ess_tail", "multivariate_ess",
              "min_ess_required", "potential_scale_reduction", "mcse_mean",
              "hdi", "ppc_pvalue", "summary"}
    assert ported <= set(pan.__all__) <= set(jan.__all__) | {
        "mcse_quantile", "nested_rhat"}
    for name in pan.__all__:
        assert hasattr(jan, name), name


def test_throughput_monitor_and_trace_profile(chain, tmp_path):
    """Mirrors ``tests/test_utils.py``."""
    from mcmcpp_tpu_torch.utils import ThroughputMonitor, trace_profile

    mon = ThroughputMonitor(n_walkers=100)
    with mon.measure(steps=50):
        pass
    assert mon.updates == 5000 and mon.updates_per_s > 0
    rate = ThroughputMonitor(n_walkers=W)
    with rate.measure(steps=S):
        pass
    ess_rate = rate.ess_per_s(chain)
    assert ess_rate.shape == (P,) and np.all(ess_rate > 0)
    with trace_profile(tmp_path / "trace") as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key or "matmul" in e.key
               for e in prof.key_averages())
