"""The rest of the port's Analysis layer against the JAX package's, on the
same seeded inputs.

- the numpy/scipy copies (``importance``, ``power_scaling``,
  ``model_compare``, ``rstar``): bit for bit (``rstar`` in a subprocess, as
  the JAX tests run it: sklearn's OpenMP runtime beside XLA's in one
  process has aborted the interpreter; without sklearn it raises
  ``ImportError``);
- ``scores``: equal to JAX's, 1e-12 relative, and to float64 numpy
  (1e-12; the energy score's Gram-identity distances 1e-9);
- ``ksd``: the blocked Stein sum against JAX's (float32: 1e-5 relative) and
  against a float64 brute force (1e-4, the JAX test's bound), including the
  many-block path; the bias it must detect;
- ``bridge``: within the JAX test's 0.05 of the analytic log Z;
- ``global_stats`` in one process: equal to the port's local functions
  (the same tolerances as ``tests/test_global_stats.py``), two emulated
  shards reproduce the whole ensemble, a multi-process run raises, and the
  numbers equal the JAX package's global functions;
- ``sbc``: the statistics equal JAX's on the same ranks; the exact-posterior
  pipeline calibrated and a broken one flagged; ``sbc_model`` on a DSL
  ``Model`` calibrated.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import analysis as jan
from mcmcpp_tpu_torch import analysis as pan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_rng = np.random.default_rng(0)


def _same(a, b):
    """Bit-for-bit equal results (numbers, arrays, named tuples, dicts)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


LL = [_rng.normal(-1.0, 0.3, size=(400, 25)) + _rng.normal(0, s, size=25)
      for s in (0.2, 0.5, 0.9)]
DRAWS = _rng.normal(size=(400, 3))
LOG_PRIOR = -0.5 * (DRAWS ** 2).sum(1)
LOG_LIK = -0.5 * ((DRAWS - 0.5) ** 2).sum(1) * 4


@pytest.mark.parametrize("call", [
    ("importance", "hill_khat", lambda m: (LL[0][:, 0],)),
    ("importance", "truncated_weights", lambda m: (LL[1],)),
    ("model_compare", "waic", lambda m: (LL[0],)),
    ("model_compare", "loo", lambda m: (LL[1],)),
    ("model_compare", "stacking_weights",
     lambda m: ({f"m{i}": m.loo(x) for i, x in enumerate(LL)},)),
    ("model_compare", "pseudo_bma_weights",
     lambda m: ({f"m{i}": m.loo(x) for i, x in enumerate(LL)},)),
    ("model_compare", "compare",
     lambda m: ({f"m{i}": m.loo(x) for i, x in enumerate(LL)},)),
    ("model_compare", "stacked_predictive_resample",
     lambda m: ({"a": DRAWS, "b": DRAWS + 1.0}, {"a": 0.3, "b": 0.7})),
    ("power_scaling", "powerscale", lambda m: (DRAWS, LOG_PRIOR, 0.8)),
    ("power_scaling", "powerscale_sensitivity",
     lambda m: (DRAWS, LOG_PRIOR, LOG_LIK)),
], ids=lambda c: f"{c[0]}.{c[1]}")
def test_numpy_modules_are_bit_for_bit(call):
    mod, fn, args = call
    jm = __import__(f"mcmcpp_tpu.analysis.{mod}", fromlist=[fn])
    pm = __import__(f"mcmcpp_tpu_torch.analysis.{mod}", fromlist=[fn])
    _same(getattr(pm, fn)(*args(pm)), getattr(jm, fn)(*args(jm)))


# both rstar modules are numpy alone (sklearn is imported when rstar runs):
# the subprocess loads them by path, without importing either package
_LOAD_RSTAR = """
import importlib.util, json, sys
import numpy as np

def load(path):
    spec = importlib.util.spec_from_file_location(path, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.rstar
"""


def _run_py(script):
    r = subprocess.run([sys.executable, "-c", _LOAD_RSTAR + script],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.splitlines()[-1])


def test_rstar_equals_jax_in_a_subprocess():
    out = _run_py("""
jr = load("mcmcpp_tpu/analysis/rstar.py")
pr = load("mcmcpp_tpu_torch/analysis/rstar.py")
rng = np.random.default_rng(0)
x = rng.normal(size=(150, 4, 2))
x[:, 0] += 0.8
kw = dict(seed=1, max_iter=20, n_threads=1)
print(json.dumps([pr(x, **kw), jr(x, **kw)]))
""")
    assert out[0] == out[1] and out[0] > 1.1


def test_rstar_without_sklearn_raises_import_error():
    out = _run_py("""
sys.modules["sklearn"] = None
rstar = load("mcmcpp_tpu_torch/analysis/rstar.py")
try:
    rstar(np.zeros((10, 2, 1)))
except ImportError as e:
    print(json.dumps(str(e)))
""")
    assert "scikit-learn" in out


# -- scores ----------------------------------------------------------------------


def test_scores_match_jax_and_numpy():
    x = _rng.normal(size=(5, 64))
    y = _rng.normal(size=5)
    with jax.enable_x64(True):
        jc = np.asarray(jan.crps_ensemble(x, y))
        je = float(jan.energy_score(x[:3].T, x[:3, 0] * 0.5))
    pc = pan.crps_ensemble(x, y, device="cpu")
    assert isinstance(pc, np.ndarray)
    np.testing.assert_allclose(pc, jc, rtol=1e-12)
    # float64 numpy: E|X − y| − ½ E|X − X'| over distinct pairs
    pair = np.abs(x[:, :, None] - x[:, None, :]).sum((1, 2)) / (64 * 63)
    np.testing.assert_allclose(
        pc, np.abs(x - y[:, None]).mean(1) - 0.5 * pair, rtol=1e-12)
    pt = pan.crps_ensemble(torch.as_tensor(x), torch.as_tensor(y))
    assert isinstance(pt, torch.Tensor)
    np.testing.assert_allclose(pt.numpy(), pc, rtol=1e-15)
    d = x[:3].T
    ob = x[:3, 0] * 0.5
    pe = pan.energy_score(d, ob, device="cpu")
    dist = np.linalg.norm(d[:, None] - d[None], axis=-1).sum() / (64 * 63)
    want = np.linalg.norm(d - ob, axis=1).mean() - 0.5 * dist
    # the pairwise distances come from the Gram identity in both packages,
    # exact to ~eps·‖x‖²/‖x − x'‖; direct differences agree to 1e-9
    assert float(pe) == pytest.approx(want, rel=1e-9)
    assert float(pe) == pytest.approx(je, rel=1e-12)
    with pytest.raises(ValueError, match="at least 2"):
        pan.crps_ensemble(np.zeros((3, 1)), np.zeros(3), device="cpu")


def test_energy_score_reduces_to_crps_at_1d():
    x = _rng.normal(size=200)
    np.testing.assert_allclose(
        float(pan.energy_score(x[:, None], np.array([0.3]), device="cpu")),
        float(pan.crps_ensemble(x, np.asarray(0.3), device="cpu")),
        rtol=1e-12)


# -- ksd ----------------------------------------------------------------------


def _brute_ksd_sum(x, s, c=1.0, beta=-0.5):
    n, p = x.shape
    d = x[:, None, :] - x[None, :, :]
    r2 = (d ** 2).sum(-1)
    u = c * c + r2
    dds = np.einsum("ijk,jk->ij", d, s) - np.einsum("ijk,ik->ij", d, s)
    k0 = (u ** beta * (s @ s.T) + 2 * beta * u ** (beta - 1) * dds
          - 4 * beta * (beta - 1) * u ** (beta - 2) * r2
          - 2 * beta * p * u ** (beta - 1))
    np.fill_diagonal(k0, 0.0)
    return k0.sum()


@pytest.mark.parametrize("n,block", [(37, 2048), (300, 64)])
def test_ksd_sum_matches_jax_and_bruteforce(n, block):
    from mcmcpp_tpu.analysis.ksd import _ksd_sum as jax_sum
    from mcmcpp_tpu_torch.analysis.ksd import _ksd_sum

    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    s = (0.7 * rng.standard_normal((n, 3)) - x).astype(np.float32)
    got = float(_ksd_sum(torch.as_tensor(x), torch.as_tensor(s), 1.0, -0.5,
                         True, block))
    want = float(jax_sum(jnp.asarray(x), jnp.asarray(s),
                         jnp.asarray(np.float32(1.0)), -0.5, True))
    brute = _brute_ksd_sum(x.astype(np.float64), s.astype(np.float64))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(brute, rel=1e-4)


def test_ksd_detects_bias_and_matches_jax():
    exact = np.random.default_rng(0).standard_normal((1500, 3)).astype(
        np.float32)

    def logp(t):  # batched, as the engines take it
        return -0.5 * torch.sum(t * t, dim=-1)

    k_exact = pan.ksd(exact, score_fn=logp, device="cpu")
    k_shift = pan.ksd(exact + 0.3, score_fn=logp, device="cpu")
    k_wide = pan.ksd(1.3 * exact, score_fn=logp, device="cpu")
    assert k_shift > 5 * k_exact and k_wide > 5 * k_exact
    want = jan.ksd(exact + 0.3, score_fn=lambda t: -0.5 * jnp.sum(t * t))
    assert k_shift == pytest.approx(want, rel=1e-5)
    per_theta = pan.ksd(exact + 0.3, score_fn=lambda t: -0.5 * (t * t).sum(),
                        batched=False, device="cpu")
    assert per_theta == pytest.approx(k_shift, rel=1e-6)
    with pytest.raises(ValueError, match="shape"):
        pan.ksd(np.zeros((10, 2)), scores=np.zeros((10, 3)), device="cpu")
    with pytest.raises(ValueError, match="score_fn or scores"):
        pan.ksd(np.zeros((10, 2)), device="cpu")


def test_ksd_curve_subsamples_as_jax():
    rng = np.random.default_rng(4)
    runs = {"a": rng.standard_normal((900, 2)),
            "b": 1.2 * rng.standard_normal((3, 400, 2))}
    got = pan.ksd_curve(runs, lambda t: -0.5 * (t * t).sum(-1), n=500,
                        seed=3, device="cpu")
    with jax.enable_x64(True):
        want = jan.ksd_curve(runs, lambda t: -0.5 * jnp.sum(t * t), n=500,
                             seed=3)
    for k in runs:
        assert got[k] == pytest.approx(want[k], rel=1e-9)
    assert got["b"] > got["a"]


# -- bridge --------------------------------------------------------------------

BY = np.array([[1.2, 0.4], [0.8, 1.1], [1.5, 0.2], [0.3, 0.9]])


def _bridge_logz():
    out = 0.0
    for d in range(2):
        cov = 4.0 * np.ones((4, 4)) + np.eye(4)
        y = BY[:, d]
        out += (-0.5 * y @ np.linalg.solve(cov, y)
                - 0.5 * np.linalg.slogdet(cov)[1] - 2 * np.log(2 * np.pi))
    return out


def test_bridge_matches_analytic_on_exact_draws():
    yt = torch.as_tensor(BY, dtype=torch.float32)

    def logpost(t):  # (n, 2) -> (n,)
        return (-0.5 * (t * t).sum(-1) / 4.0 - math.log(2 * math.pi * 4.0)
                - 0.5 * ((yt[None] - t[:, None, :]) ** 2).sum((1, 2))
                - 4 * math.log(2 * math.pi))

    prec = 0.25 + 4
    draws = (BY.sum(0) / prec + prec ** -0.5
             * np.random.default_rng(0).standard_normal((4000, 2)))
    r = pan.bridge_log_evidence(logpost, draws, seed=1, device="cpu")
    assert isinstance(r, pan.BridgeResult)
    assert r.converged and r.rel_ess > 0.1
    assert r.logz == pytest.approx(_bridge_logz(), abs=0.05)
    # the same draws as a tensor, and the per-θ form
    r2 = pan.bridge_log_evidence(lambda t: logpost(t[None])[0],
                                 torch.as_tensor(draws), seed=1,
                                 batched=False)
    assert r2.logz == pytest.approx(r.logz, abs=1e-6)
    with pytest.raises(ValueError, match="N >= 8"):
        pan.bridge_log_evidence(logpost, draws[:4], device="cpu")


# -- global_stats ----------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    """A stationary AR(1) ensemble (600, 32, 3), float32 as stored."""
    rng = np.random.default_rng(5)
    phi = np.array([0.3, 0.6, 0.8])
    x = np.zeros((600, 32, 3))
    x[0] = rng.standard_normal((32, 3))
    for t in range(1, 600):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi ** 2) * rng.standard_normal(
            (32, 3))
    return (x * np.array([1.0, 2.0, 0.5]) + 1.0).astype(np.float32)


def test_global_equals_local_functions(chain):
    n_local = chain.shape[0] * chain.shape[1]
    np.testing.assert_array_equal(pan.global_autocorr_time(chain, device="cpu"),
                                  pan.autocorr_time(chain, device="cpu"))
    np.testing.assert_array_equal(pan.global_effective_sample_size(chain, device="cpu"),
                                  pan.effective_sample_size(chain, device="cpu"))
    np.testing.assert_allclose(pan.global_covariance_matrix(chain, device="cpu"),
                               pan.covariance_matrix(chain, device="cpu"),
                               rtol=1e-4)
    np.testing.assert_allclose(
        pan.global_split_rhat(chain, device="cpu"),
        pan.potential_scale_reduction(chain, rank_normalized=False),
        rtol=1e-12)
    np.testing.assert_allclose(pan.global_batch_means_ess(chain, device="cpu"),
                               pan.batch_means_ess(chain), rtol=1e-8)
    assert pan.global_multivariate_ess(chain, device="cpu") == pytest.approx(
        pan.multivariate_ess(chain), rel=1e-10)
    np.testing.assert_allclose(pan.global_ess_bulk(chain, max_knots=n_local, device="cpu"),
                               pan.ess_bulk(chain, device="cpu"), rtol=1e-9)
    np.testing.assert_allclose(pan.global_ess_tail(chain, max_knots=n_local, device="cpu"),
                               pan.ess_tail(chain, device="cpu"), rtol=1e-9)
    np.testing.assert_allclose(
        pan.global_rank_normalized_rhat(chain, max_knots=n_local,
                                        device="cpu"),
        pan.potential_scale_reduction(chain, rank_normalized=True),
        rtol=1e-12)
    np.testing.assert_allclose(pan.global_mcse_mean(chain, device="cpu"),
                               pan.mcse_mean(chain, device="cpu"), rtol=1e-9)
    loc = pan.summary(chain, prob=0.9, device="cpu")
    glob = pan.global_summary(chain, prob=0.9, max_knots=n_local,
                              device="cpu")
    assert set(glob) == set(loc)
    for key in ("mean", "sd", "median", "q5", "q95", "hdi_lo", "hdi_hi"):
        np.testing.assert_allclose(glob[key], loc[key], rtol=1e-9,
                                   err_msg=key)
    for key in ("ess", "ess_bulk", "ess_tail", "rhat", "mcse"):
        np.testing.assert_allclose(glob[key], loc[key], rtol=1e-6,
                                   err_msg=key)


def test_local_rank_diagnostics_on_a_tensor_equal_numpy(chain):
    """The local ess_bulk and ess_tail take a tensor or numpy (as a float64
    tensor on the named device) alike; R-hat on a tensor equals its numpy arithmetic (1e-12
    relative); the normal scores, ties included, are scipy's average ranks
    through the normal quantile (1e-12 relative)."""
    from scipy import stats as sps

    from mcmcpp_tpu_torch.analysis.ess import rank_normalize_tensor

    t = torch.as_tensor(chain)
    np.testing.assert_allclose(pan.ess_bulk(t), pan.ess_bulk(chain, device="cpu"),
                               rtol=1e-9)
    np.testing.assert_allclose(pan.ess_tail(t), pan.ess_tail(chain, device="cpu"),
                               rtol=1e-9)
    for rn in (False, True):
        np.testing.assert_allclose(
            pan.potential_scale_reduction(t, rank_normalized=rn),
            pan.potential_scale_reduction(chain, rank_normalized=rn),
            rtol=1e-12)
    tied = np.round(chain.astype(np.float64), 1)  # many ties
    s, w, p = tied.shape
    want = np.stack([
        sps.norm.ppf((sps.rankdata(tied[:, :, i], axis=None) - 0.375)
                     / (s * w + 0.25)).reshape(s, w)
        for i in range(p)], axis=-1)
    got = rank_normalize_tensor(torch.as_tensor(tied)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def _two_shard(fn, full, **kw):
    """Emulate two processes: capture shard B's partials, reduce them into
    shard A's call (what an all-gather and a sum would do)."""
    a, b = full[:, : full.shape[1] // 2], full[:, full.shape[1] // 2:]
    captured = {}

    class _Stop(Exception):
        pass

    def capture(*parts):
        captured["b"] = parts
        raise _Stop

    with pytest.raises(_Stop):
        fn(b, _reduce=capture, **kw)

    def combine(*parts_a):
        out = tuple(np.asarray(x) + np.asarray(y)
                    for x, y in zip(parts_a, captured["b"]))
        return out if len(out) > 1 else out[0]

    return fn(a, _reduce=combine, **kw)


@pytest.mark.parametrize("name,rtol", [
    ("global_autocorr_time", 1e-5), ("global_covariance_matrix", 1e-10),
    ("global_correlation_matrix", 1e-10), ("global_split_rhat", 1e-10),
    ("global_batch_means_ess", 1e-8), ("global_multivariate_ess", 1e-9)])
def test_two_shards_reproduce_the_whole_ensemble(chain, name, rtol):
    fn = getattr(pan, name)
    np.testing.assert_allclose(_two_shard(fn, chain, device="cpu"),
                               fn(chain, device="cpu"), rtol=rtol)


def test_global_equals_jax_global(chain):
    n_local = chain.shape[0] * chain.shape[1]
    with jax.enable_x64(True):
        want = {k: getattr(jan, k)(chain) for k in (
            "global_autocorr_time", "global_split_rhat",
            "global_batch_means_ess", "global_covariance_matrix")}
        want_sum = jan.global_summary(chain, max_knots=n_local)
    for k, v in want.items():
        np.testing.assert_allclose(getattr(pan, k)(chain, device="cpu"), v,
                                   rtol=1e-5)
    got_sum = pan.global_summary(chain, max_knots=n_local, device="cpu")
    for k in want_sum:
        np.testing.assert_allclose(got_sum[k], want_sum[k], rtol=1e-5,
                                   err_msg=k)


def test_multi_process_run_raises(chain, monkeypatch):
    """Ported: under a process group of more than one rank the global
    functions no longer raise but call the collectives (an all-reduce and a
    flattened all-gather on the group's device). Emulated here with two
    ranks that hold the same shard: the results are the local functions'
    on the whole ensemble of the two, the shard twice."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(dist, "all_reduce", lambda t: t.mul_(2.0))
    monkeypatch.setattr(dist, "all_gather_single",
                        lambda out, t: out.copy_(torch.cat([t, t])))
    shard = chain[:, :16]
    both = np.concatenate([shard, shard], axis=1)
    np.testing.assert_allclose(
        pan.global_autocorr_time(shard, device="cpu"),
        pan.autocorr_time(both, device="cpu"), rtol=1e-12)
    n = chain.shape[0] * 16
    np.testing.assert_allclose(
        pan.global_ess_bulk(shard, max_knots=n, device="cpu"),
        pan.ess_bulk(both, device="cpu"), rtol=1e-9)


def test_global_validation():
    with pytest.raises(ValueError, match="local_samples"):
        pan.global_autocorr_time(np.zeros((4,)), device="cpu")
    with pytest.raises(ValueError, match="local_samples"):
        pan.global_split_rhat(np.zeros((4, 2)), device="cpu")
    with pytest.raises(ValueError, match="local_samples"):
        pan.global_covariance_matrix(np.zeros((4,)), device="cpu")


# -- sbc -----------------------------------------------------------------------

TAU, N_OBS, L_DRAWS = 1.5, 8, 63


def _post(y):
    prec = 1.0 / TAU ** 2 + N_OBS
    return y.sum(-1) / prec, 1.0 / prec


def test_sbc_statistics_equal_jax_on_the_same_ranks():
    ranks = np.random.default_rng(1).integers(0, L_DRAWS + 1, size=(256, 2))
    ranks[:, 1] = np.clip(ranks[:, 1] // 2, 0, L_DRAWS)  # a biased column
    js, jp = jan.sbc_uniformity(ranks, L_DRAWS)
    ps, pp = pan.sbc_uniformity(ranks, L_DRAWS)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-30)
    _same(pan.sbc_ecdf_band(ranks, L_DRAWS, n_sim=500),
          jan.sbc_ecdf_band(ranks, L_DRAWS, n_sim=500))
    assert pan.sbc_summary(ranks, L_DRAWS) == jan.sbc_summary(ranks, L_DRAWS)


@pytest.mark.parametrize("vectorized", [False, True])
def test_sbc_ranks_exact_posterior_is_calibrated(vectorized):
    def prior(gen, n=None):
        shape = (1,) if n is None else (n, 1)
        return TAU * torch.randn(shape, generator=gen, dtype=torch.float64)

    def simulate(gen, theta):
        return theta[..., :1] + torch.randn(theta.shape[:-1] + (N_OBS,),
                                            generator=gen,
                                            dtype=torch.float64)

    def fit(gen, y):
        mu, var = _post(y)
        z = torch.randn(y.shape[:-1] + (L_DRAWS, 1), generator=gen,
                        dtype=torch.float64)
        return mu[..., None, None] + math.sqrt(var) * z

    ranks = pan.sbc_ranks(prior, simulate, fit, n_sims=200, seed=0,
                          vectorized=vectorized, device="cpu")
    assert ranks.shape == (200, 1) and ranks.dtype == np.int32
    assert ranks.min() >= 0 and ranks.max() <= L_DRAWS
    assert pan.sbc_uniformity(ranks, L_DRAWS)[1][0] > 0.01

    def fit_narrow(gen, y):
        return fit(gen, y) * 0.0 + _post(y)[0][..., None, None]

    bad = pan.sbc_ranks(prior, simulate, fit_narrow, n_sims=200, seed=1,
                        vectorized=vectorized, device="cpu")
    assert pan.sbc_uniformity(bad, L_DRAWS)[1][0] < 1e-6


def test_sbc_model_on_a_dsl_model_is_calibrated():
    """sbc_model on a port Model: θ* from build_split's prior sampler, data
    from the template's posterior predictive, each fit the exact posterior
    of the rebuilt model's logp on a grid (inverse-cdf draws)."""
    from mcmcpp_tpu_torch.dsl import Model, Normal

    def build_model(sim):
        y = np.zeros(N_OBS) if sim is None else sim["y"]
        return (Model().param("theta", Normal(0.0, TAU))
                .observe("y", lambda p: Normal(p["theta"], 1.0), y))

    grid = torch.linspace(-8.0, 8.0, 4001, dtype=torch.float64)[:, None]

    def fit(gen, logp, dim):
        lp = torch.func.vmap(logp)(grid)
        cdf = torch.cumsum(torch.exp(lp - lp.max()), 0)
        cdf = cdf / cdf[-1]
        u = torch.rand(L_DRAWS, generator=gen, dtype=torch.float64)
        return grid[torch.searchsorted(cdf, u).clamp(max=4000)]

    ranks, n_draws = pan.sbc_model(build_model, fit, n_sims=96, seed=5,
                                   device="cpu")
    assert n_draws == L_DRAWS and ranks.shape == (96, 1)
    assert pan.sbc_uniformity(ranks, n_draws)[1][0] > 0.005


def test_sbc_on_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        pan.sbc_ranks(None, None, None, n_sims=1)
