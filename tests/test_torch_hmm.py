"""The port's finite-state HMM layer held against the JAX package.

- In float64 to 1e-9: the forward pass (sequential and parallel), the
  smoother, Viterbi (the path exactly), the forecast, the log-likelihood's
  gradient in the transition logits, ``transition_counts``; and
  ``hmm_sample_posterior`` and ``HMMKernel`` replayed on JAX's own Gumbel
  noise (the paths exactly).
- The parallel and sequential forward passes agree in float32 at T = 257
  (``tests/test_hmm.py``'s tolerances).
- ``tests/test_hmm.py``'s oracles at its bounds: the loglik, filtered
  and smoothed marginals and Viterbi against enumerating all 3^6 paths,
  the FFBS path frequencies, and the Gibbs loop with Dirichlet rows.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu.models import hmm as jh
from mcmcpp_tpu_torch.models import hmm as th

torch.set_num_threads(1)

TOL = 1e-9
K, T = 3, 6


def _model(dtype=np.float32, t_n=T, k=K, seed=0):
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(np.ones(k))
    gamma = rng.dirichlet(np.ones(k), size=k)
    log_obs = np.log(rng.uniform(0.05, 1.0, (t_n, k)))
    return (np.log(pi).astype(dtype), np.log(gamma).astype(dtype),
            log_obs.astype(dtype))


def _enumerate(log_pi, log_gamma, log_obs):
    lp, lg, lo = (np.asarray(a, np.float64) for a in (log_pi, log_gamma,
                                                      log_obs))
    paths = np.array(list(itertools.product(range(K), repeat=T)))
    joint = lp[paths[:, 0]] + lo[0, paths[:, 0]]
    for t in range(1, T):
        joint += lg[paths[:, t - 1], paths[:, t]] + lo[t, paths[:, t]]
    return paths, joint


def _t(x):
    return torch.from_numpy(np.array(x))


def test_forward_smoother_viterbi_forecast_match_jax_float64():
    lp, lg, lo = _model(np.float64, t_n=23, seed=1)
    fwd = jax.jit(jh.hmm_forward, static_argnames="method")
    smooth = jax.jit(jh.hmm_smoother, static_argnames="method")
    with jax.enable_x64(True):
        for method in ("sequential", "parallel"):
            want = fwd(lp, lg, lo, method=method)
            got = th.hmm_forward(lp, lg, _t(lo), method=method)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=TOL)
            want = smooth(lp, lg, lo, method=method)
            got = th.hmm_smoother(lp, lg, _t(lo), method=method)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=TOL)
        jv = jh.viterbi(lp, lg, lo)
        jf = jh.hmm_forecast(lp, lg, lo, horizon=5)

        def f(g):
            return jh.hmm_loglik(lp, g - jax.scipy.special.logsumexp(
                g, 1, keepdims=True), lo)

        jg = jax.grad(f)(jnp.asarray(lg))
        path = np.asarray(jv[0])
        jc = jh.transition_counts(path, K)
    tv = th.viterbi(lp, lg, _t(lo))
    assert tv[0].dtype == torch.int32
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv[0]))
    assert abs(float(tv[1]) - float(jv[1])) < TOL
    np.testing.assert_allclose(th.hmm_forecast(lp, lg, _t(lo), 5).numpy(),
                               np.asarray(jf), rtol=0, atol=TOL)
    g = _t(lg).requires_grad_(True)
    ll = th.hmm_loglik(_t(lp), g - torch.logsumexp(g, 1, keepdim=True),
                       _t(lo))
    (grad,) = torch.autograd.grad(ll, g)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=0, atol=TOL)
    np.testing.assert_array_equal(
        th.transition_counts(_t(path), K).numpy(), np.asarray(jc))
    with pytest.raises(ValueError, match="log_gamma"):
        th.hmm_forward(lp, lg[:2], _t(lo))
    with pytest.raises(ValueError, match="log_obs"):
        th.hmm_forward(lp, lg, _t(lo[:, :2]))
    with pytest.raises(ValueError, match="method"):
        th.hmm_forward(lp, lg, _t(lo), method="fast")


def _jax_path_gumbels(key, n, t_n):
    """The Gumbel noise of ``hmm_sample_posterior(key, …, n_paths=n)``,
    as ``gumbel(i)``: i = T−1 from k_last, i < T−1 from split(k_scan)."""
    k_last, k_scan = jax.random.split(key)
    keys = jax.random.split(k_scan, t_n - 1)
    g = {t_n - 1: np.asarray(jax.random.gumbel(k_last, (n, K),
                                               jnp.float64))}
    for i in range(t_n - 1):
        g[i] = np.asarray(jax.random.gumbel(keys[i], (n, K), jnp.float64))
    return g


@pytest.mark.parametrize("method", ["sequential", "parallel"])
def test_posterior_paths_and_kernel_replay_jax_gumbels(method):
    lp, lg, lo = _model(np.float64, t_n=17, seed=2)
    keys = jax.random.split(jax.random.key(4), 3)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(
            jh.hmm_sample_posterior, static_argnames=("n_paths", "method"))(
            keys[0], lp, lg, lo, n_paths=64, method=method))
        g = _jax_path_gumbels(keys[0], 64, 17)
        kern = jh.HMMKernel(lo, lp, lg, method=method)
        step = jax.jit(lambda k: kern.step(k, jnp.zeros(17), {}))
        want_k = np.stack([np.asarray(step(k)) for k in keys])
        gk = [_jax_path_gumbels(k, 1, 17) for k in keys]
    got = th.hmm_sample_posterior(None, lp, lg, _t(lo), n_paths=64,
                                  method=method, gumbel=lambda i: _t(g[i]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    one = th.hmm_sample_posterior(None, lp, lg, _t(lo), method=method,
                                  gumbel=lambda i: _t(g[i][:1]))
    np.testing.assert_array_equal(one.numpy(), want[0])
    tk = th.HMMKernel(lo, lp, lg, method=method)
    got = tk.apply(lambda i: _t(np.stack([d[i] for d in gk])),
                   torch.zeros((3, 17), dtype=torch.float64), {})
    np.testing.assert_array_equal(got.numpy(), want_k)


def test_parallel_matches_sequential_float32_long():
    lp, lg, lo = _model(np.float32, t_n=257, k=5, seed=4)
    fs = th.hmm_forward(lp, lg, _t(lo), method="sequential")
    fp = th.hmm_forward(lp, lg, _t(lo), method="parallel")
    np.testing.assert_allclose(float(fp.loglik), float(fs.loglik), rtol=3e-4)
    np.testing.assert_allclose(fp.log_alpha.numpy(), fs.log_alpha.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_enumeration_oracles():
    lp, lg, lo = _model()
    paths, joint = _enumerate(lp, lg, lo)
    from scipy.special import logsumexp

    f = th.hmm_forward(lp, lg, _t(lo))
    assert float(f.loglik) == pytest.approx(logsumexp(joint), rel=2e-5)
    w = np.exp(joint - joint.max())
    w /= w.sum()
    post, _ = th.hmm_smoother(lp, lg, _t(lo), method="parallel")
    for t in range(T):
        exact = np.array([w[paths[:, t] == k].sum() for k in range(K)])
        np.testing.assert_allclose(np.exp(post.numpy()[t]), exact,
                                   atol=2e-5)
    path, score = th.viterbi(lp, lg, _t(lo))
    np.testing.assert_array_equal(path.numpy(), paths[np.argmax(joint)])
    np.testing.assert_allclose(float(score), joint.max(), rtol=2e-5)
    n = 20000
    draws = th.hmm_sample_posterior(torch.Generator().manual_seed(1), lp, lg,
                                    _t(lo), n_paths=n).numpy()
    assert draws.shape == (n, T)
    codes = draws @ (K ** np.arange(T - 1, -1, -1))
    freq = np.bincount(codes, minlength=K ** T) / n
    exact = np.zeros(K ** T)
    exact[paths @ (K ** np.arange(T - 1, -1, -1))] = w
    assert (np.abs(freq - exact) < 5 * np.sqrt(exact * (1 - exact) / n)
            + 3e-4).all()


def test_gibbs_recovers_states_and_transitions():
    rng = np.random.default_rng(7)
    t_n = 200
    gamma_true = np.array([[0.95, 0.05], [0.10, 0.90]])
    mus = np.array([-1.5, 1.5])
    z = np.zeros(t_n, int)
    for t in range(1, t_n):
        z[t] = rng.choice(2, p=gamma_true[z[t - 1]])
    ys = (mus[z] + 0.7 * rng.standard_normal(t_n)).astype(np.float32)
    log_obs = th.gaussian_emission_logpdf(_t(ys), mus, np.array([0.7, 0.7]))
    np.testing.assert_allclose(log_obs.numpy(), np.asarray(
        jh.gaussian_emission_logpdf(ys, mus, np.array([0.7, 0.7]))),
        rtol=1e-6)
    log_pi = np.log(np.array([0.5, 0.5], np.float32))

    def sample_rows(gen, others):
        counts = torch.stack([th.transition_counts(zz, 2)
                              for zz in others["z"].long()]).float()
        g = torch._standard_gamma(counts + 1.0, generator=gen)
        return torch.log(g / torch.sum(g, -1, keepdim=True)).reshape(
            counts.shape[0], -1)

    gb = mt.BlockedGibbsSampler(
        [("z", t_n, th.HMMKernel(log_obs, log_pi,
                                 lambda o: o["lgam"].reshape(2, 2),
                                 method="parallel")),
         ("lgam", 4, mt.ExactGibbsKernel(sample_rows, batched=True))],
        n_chains=8, seed=0, device="cpu")
    gb.init({"z": rng.integers(0, 2, t_n).astype(np.float32),
             "lgam": np.log(np.full((2, 2), 0.5)).reshape(-1).astype(
                 np.float32)})
    gb.run(250)
    zs = gb.get_block("z")[50:]
    lgs = gb.get_block("lgam")[50:].reshape(-1, 2, 2)
    assert ((zs.mean((0, 1)) > 0.5).astype(int) == z).mean() > 0.9
    diag = np.exp(lgs)[:, [0, 1], [0, 1]].mean(0)
    assert abs(diag[0] - 0.95) < 0.08, diag
    assert abs(diag[1] - 0.90) < 0.12, diag
