"""Where the port computes on a numpy input: the device it is asked for, by
default "cuda", as the JAX package puts a numpy input on its accelerator.

Each function below, given numpy and no ``device``, asks for the card: on a
box without one it raises ``resolve_device``'s error, never falls back to
the CPU. Given ``device="cpu"`` it equals the JAX function on the same seeded
input (float32; 1e-5 relative, or the JAX tests' own bound where the two
packages draw different random numbers, as bridge sampling's proposal).
A tensor input stays on its own device. ``run_until_converged`` takes the ACT
on the sampler's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import analysis as jan
from mcmcpp_tpu.models import gp as jgp
from mcmcpp_tpu.utils.metrics import ThroughputMonitor as JaxMonitor
from mcmcpp_tpu_torch import analysis as pan
from mcmcpp_tpu_torch.convergence import run_until_converged
from mcmcpp_tpu_torch.models import gp as tgp
from mcmcpp_tpu_torch.utils.metrics import ThroughputMonitor as PortMonitor

torch.set_num_threads(1)

RTOL = 1e-5


def _ar1(n=600, w=8, p=2, seed=0):
    rng = np.random.default_rng(seed)
    phi = np.linspace(0.3, 0.8, p)
    x = np.zeros((n, w, p))
    x[0] = rng.standard_normal((w, p))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi ** 2) * rng.standard_normal(
            (w, p))
    return x.astype(np.float32)


CHAIN = _ar1()
DRAWS = np.random.default_rng(1).standard_normal((400, 3)).astype(np.float32)
OBS = np.random.default_rng(2).standard_normal(3).astype(np.float32)
XS = np.sort(np.random.default_rng(3).uniform(-2, 2, 24)).astype(np.float32)


def _logp(t):
    return -0.5 * torch.sum(t * t, dim=-1)


def _jlogp(t):
    return -0.5 * jnp.sum(t * t)


def _columns(summary):
    """A summary dict's columns, stacked in key order."""
    return np.stack([np.asarray(v, np.float64) for v in summary.values()])


def _monitor(cls):
    """A throughput monitor that measured 2 s."""
    mon = cls(n_walkers=CHAIN.shape[1])
    mon.seconds = 2.0
    return mon


# name: (the port's call with keyword arguments kw, the JAX package's value)
CASES = {
    "autocorr_time": (lambda kw: pan.autocorr_time(CHAIN, **kw),
                      lambda: jan.autocorr_time(CHAIN)),
    "autocorr_time_chunked": (
        lambda kw: pan.autocorr_time(CHAIN, walker_chunk=3, **kw),
        lambda: jan.autocorr_time(CHAIN, walker_chunk=3)),
    "normalized_autocov": (
        lambda kw: pan.normalized_autocov(CHAIN[:, :, 0].T, **kw),
        lambda: jan.normalized_autocov(CHAIN[:, :, 0].T)),
    "ksd": (lambda kw: pan.ksd(DRAWS + 0.2, score_fn=_logp, **kw),
            lambda: jan.ksd(DRAWS + 0.2, score_fn=_jlogp)),
    "crps_ensemble": (lambda kw: pan.crps_ensemble(DRAWS.T, OBS, **kw),
                      lambda: jan.crps_ensemble(DRAWS.T, OBS)),
    "energy_score": (lambda kw: pan.energy_score(DRAWS, OBS, **kw),
                     lambda: jan.energy_score(DRAWS, OBS)),
    "rbf_cross": (lambda kw: tgp.RBF(0.7, 1.3, **kw)(XS, XS[::2]),
                  lambda: jgp.RBF(0.7, 1.3)(XS, XS[::2])),
    "matern52_plus_white_gram": (
        lambda kw: (tgp.Matern52(0.9, 0.8, **kw)
                    + tgp.WhiteNoise(1e-3)).gram(XS),
        lambda: (jgp.Matern52(0.9, 0.8) + jgp.WhiteNoise(1e-3)).gram(XS)),
    "periodic_times_linear_diag": (
        lambda kw: (tgp.Periodic(1.5, 0.8, 1.1)
                    * tgp.Linear(0.5, **kw)).diag(XS),
        lambda: (jgp.Periodic(1.5, 0.8, 1.1) * jgp.Linear(0.5)).diag(XS)),
    "gram_cholesky": (
        lambda kw: tgp.gram_cholesky(tgp.RBF(0.3, 1.0, **kw), XS[::3]),
        lambda: jgp.gram_cholesky(jgp.RBF(0.3, 1.0), XS[::3])),
    # the ESS family: the ACT's FFT runs where the numpy goes
    "effective_sample_size": (
        lambda kw: pan.effective_sample_size(CHAIN, **kw),
        lambda: jan.effective_sample_size(CHAIN)),
    "summary": (lambda kw: _columns(pan.summary(CHAIN, **kw)),
                lambda: _columns(jan.summary(CHAIN))),
    "mcse_mean": (lambda kw: pan.mcse_mean(CHAIN, **kw),
                  lambda: jan.mcse_mean(CHAIN)),
    "mcse_quantile": (lambda kw: pan.mcse_quantile(CHAIN, 0.3, **kw),
                      lambda: jan.mcse_quantile(CHAIN, 0.3)),
    "ess_bulk": (lambda kw: pan.ess_bulk(CHAIN, **kw),
                 lambda: jan.ess_bulk(CHAIN)),
    "ess_tail": (lambda kw: pan.ess_tail(CHAIN, **kw),
                 lambda: jan.ess_tail(CHAIN)),
    "ess_per_s": (lambda kw: _monitor(PortMonitor).ess_per_s(CHAIN, **kw),
                  lambda: _monitor(JaxMonitor).ess_per_s(CHAIN)),
    "global_autocorr_time": (
        lambda kw: pan.global_autocorr_time(CHAIN, **kw),
        lambda: jan.global_autocorr_time(CHAIN)),
    "global_effective_sample_size": (
        lambda kw: pan.global_effective_sample_size(CHAIN, **kw),
        lambda: jan.global_effective_sample_size(CHAIN)),
    "global_summary": (
        lambda kw: _columns(pan.global_summary(CHAIN, **kw)),
        lambda: _columns(jan.global_summary(CHAIN))),
}


def _numpy(x):
    return (x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_input_goes_to_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        CASES[name][0]({})


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_input_on_the_cpu_equals_jax(name):
    got = _numpy(CASES[name][0]({"device": "cpu"}))
    want = np.asarray(CASES[name][1]())
    assert got.shape == want.shape
    # ρ(t) near 0 at long lags: float32 FFTs of two libraries
    atol = 1e-7 if name == "normalized_autocov" else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def test_a_tensor_keeps_its_device_whatever_device_says():
    """A CPU tensor runs on the CPU even when ``device`` names the card (no
    copy is made behind the caller's back)."""
    t = torch.from_numpy(CHAIN)
    np.testing.assert_array_equal(pan.autocorr_time(t, device="cuda"),
                                  pan.autocorr_time(CHAIN, device="cpu"))
    d = torch.from_numpy(DRAWS)
    assert isinstance(pan.crps_ensemble(d.T, torch.from_numpy(OBS)),
                      torch.Tensor)
    k = tgp.RBF(0.7, 1.3, device="cuda")(torch.from_numpy(XS), XS)
    assert k.device.type == "cpu"


def test_a_composite_kernel_takes_its_terms_device():
    k = tgp.RBF(0.7) + tgp.WhiteNoise(1e-3, device="cpu")
    assert k.device == "cpu" and k.gram(XS).device.type == "cpu"
    assert (tgp.RBF(0.7) * tgp.Linear()).device is None


def test_bridge_runs_the_log_posterior_on_the_asked_device():
    """The log posterior sees the device; log Z equals JAX's within the two
    packages' Monte-Carlo error (each draws its own split and proposal)."""
    seen = set()

    def logpost(t):
        seen.add(t.device.type)
        return _logp(t) - 1.5 * np.log(2 * np.pi)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            pan.bridge_log_evidence(logpost, DRAWS)
    r = pan.bridge_log_evidence(logpost, DRAWS, device="cpu")
    assert seen == {"cpu"}
    want = jan.bridge_log_evidence(
        lambda t: _jlogp(t) - 1.5 * np.log(2 * np.pi), DRAWS)
    # exact draws of N(0, I) under its own normalized density: log Z = 0
    assert r.logz == pytest.approx(0.0, abs=0.05)
    assert r.logz == pytest.approx(want.logz, abs=0.05)


class _Replay:
    """Hands out the next rows of a fixed chain, on a named device."""

    def __init__(self, rows, device):
        self.rows, self.n_params, self.device = rows, rows.shape[-1], device
        self.stored = 0

    def run_mcmc(self, n_steps, thin=1):
        self.stored += n_steps // thin
        return True

    def get_samples(self):
        return self.rows[:self.stored]


def test_run_until_converged_takes_the_act_on_the_samplers_device(
        monkeypatch):
    from mcmcpp_tpu_torch.analysis import autocorr

    seen = []
    real = autocorr._norm_autocov_fft
    monkeypatch.setattr(autocorr, "_norm_autocov_fft",
                        lambda s: seen.append(s.device.type) or real(s))
    rep = run_until_converged(_Replay(CHAIN, "cpu"), max_steps=600,
                              check_every=300, act_multiplier=5.0)
    assert rep.checks == 2 and set(seen) == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            run_until_converged(_Replay(CHAIN, "cuda"), max_steps=600,
                                check_every=300)


def test_jax_puts_numpy_on_its_default_device():
    """The rule mirrored: the JAX package turns the numpy input into an
    array on its default device (the accelerator where there is one)."""
    out = jnp.asarray(CHAIN)
    assert out.devices() == {jax.devices()[0]}
