"""The port's EnKF/ETKF, UKF/URTS and EKI/EKS held against the JAX package.

- Replays in float64 from the JAX package's draws (re-derived from its keys
  as the JAX functions split them, handed over through test hooks,
  ``obs_noise`` and ``noise``): the stochastic EnKF and the ETKF (the final
  ensemble, means and log-likelihood to 1e-9; the ETKF's eigenvectors have
  arbitrary signs, so the comparison is of the transformed ensemble, never
  of the vectors), EKI and EKS (the final ensemble and misfit trace to
  1e-9). The UKF and URTS have no randomness: held to JAX on a linear and a
  nonlinear model to 1e-9.
- The oracles of ``tests/test_enkf.py``, ``tests/test_ukf.py`` and
  ``tests/test_eks.py`` at their bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu import enkf as je
from mcmcpp_tpu import eks as jk
from mcmcpp_tpu import ukf as ju
from mcmcpp_tpu.models import lgss as jl

torch.set_num_threads(1)

REPLAY_TOL = 1e-9
SIG_Q, SIG_R, M0, P0 = 0.35, 0.6, 1.0, 2.0
F64 = torch.float64


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(t_n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.empty(t_n)
    x[0] = M0 + np.sqrt(P0) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = x[t - 1] + SIG_Q * rng.standard_normal()
    return x, (x + SIG_R * rng.standard_normal(t_n)).astype(np.float32)


def _kalman(ys):
    p = jl.lgss_params(A=1.0, b=0.0, Q=SIG_Q ** 2, H=1.0, c=0.0,
                       R=SIG_R ** 2, m0=M0, P0=P0)
    return jl.kalman_filter(p, ys, method="sequential")


def _linear_model():
    return mt.EnKFModel(
        init_sample=lambda g, n: M0 + np.sqrt(P0) * torch.randn(
            (n, 1), generator=g),
        trans_sample=lambda g, x, t: x + SIG_Q * torch.randn(
            x.shape, generator=g),
        obs_fn=lambda x, t: x,
        obs_cov=torch.tensor([[SIG_R ** 2]]))


@pytest.mark.parametrize("variant", ["stochastic", "etkf"])
def test_enkf_replays_jax_float64(variant):
    t_n, n, d, e = 12, 16, 3, 2
    rng = np.random.default_rng(1)
    h = rng.standard_normal((e, d))
    ys = rng.standard_normal((t_n, e))
    r_cov = np.array([[0.5, 0.1], [0.1, 0.4]])
    key = jax.random.key(8)
    with jax.enable_x64(True):
        jmodel = je.EnKFModel(
            init_sample=lambda k, n_: jax.random.normal(k, (n_, d)),
            trans_sample=lambda k, x, t: 0.9 * jnp.tanh(x)
            + 0.3 * jax.random.normal(k, x.shape),
            obs_fn=lambda x, t: x @ jnp.asarray(h).T,
            obs_cov=jnp.asarray(r_cov))
        want = je.ensemble_kalman_filter(key, jmodel, ys, n, inflation=1.05,
                                         variant=variant)
        k_init, k = jax.random.split(key)
        x0 = np.asarray(jax.random.normal(k_init, (n, d)))
        k, k0 = jax.random.split(k)
        eps, zs = [np.asarray(jax.random.normal(k0, (n, e)))], []
        for _ in range(1, t_n):
            k, k_f, k_a = jax.random.split(k, 3)
            zs.append(np.asarray(jax.random.normal(k_f, (n, d))))
            eps.append(np.asarray(jax.random.normal(k_a, (n, e))))
    model = mt.EnKFModel(
        init_sample=lambda g, n_: _t(x0),
        trans_sample=lambda g, x, t: 0.9 * torch.tanh(x) + 0.3 * _t(
            zs[t - 1]),
        obs_fn=lambda x, t: x @ _t(h).mT, obs_cov=_t(r_cov))
    got = mt.ensemble_kalman_filter(torch.Generator(), model, _t(ys), n,
                                    inflation=1.05, variant=variant,
                                    obs_noise=_t(np.stack(eps)))
    assert abs(float(got.loglik) - float(want.loglik)) < REPLAY_TOL
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=REPLAY_TOL)


def test_enkf_and_etkf_converge_to_kalman():
    t_n = 40
    _, ys = _data(t_n, seed=3)
    f = _kalman(ys)
    m_true = np.asarray(f.means)[:, 0]
    sd_true = np.sqrt(np.asarray(f.covs)[:, 0, 0])
    exact_ll = float(f.loglik)
    res = mt.ensemble_kalman_filter(0, _linear_model(), ys, 8192,
                                    device="cpu")
    err = np.abs(res.means.numpy()[:, 0] - m_true)
    assert (err < 6.0 * sd_true / np.sqrt(8192.0) + 0.02).all()
    np.testing.assert_allclose(res.spread.numpy()[:, 0], sd_true, rtol=0.15,
                               atol=0.02)
    assert abs(float(res.loglik) - exact_ll) < 0.5
    assert tuple(res.ensemble.shape) == (8192, 1)
    # the ETKF's log-likelihood error at N = 128 spreads 0.35 nats over
    # seeds (20 seeds: 19 inside tests/test_enkf.py's 0.6, seed 0 at 0.71);
    # its arithmetic is JAX's to 1e-9 (the replay above)
    res = mt.ensemble_kalman_filter(1, _linear_model(), ys, 128,
                                    variant="etkf", device="cpu")
    res2 = mt.ensemble_kalman_filter(1, _linear_model(), ys, 128,
                                     variant="etkf", device="cpu")
    assert torch.equal(res.ensemble, res2.ensemble)
    err = np.abs(res.means.numpy()[:, 0] - m_true)
    assert (err < 6.0 * sd_true / np.sqrt(128.0) + 0.02).all()
    np.testing.assert_allclose(res.spread.numpy()[:, 0], sd_true, rtol=0.12,
                               atol=0.02)
    assert abs(float(res.loglik) - exact_ll) < 0.6


def test_enkf_inflation_etkf_small_n_and_validation():
    t_n = 60
    x_true, ys = _data(t_n, seed=9)

    def zscore(infl):
        res = mt.ensemble_kalman_filter(4, _linear_model(), ys, 10,
                                        inflation=infl, device="cpu")
        z = (res.means.numpy()[:, 0] - x_true) / np.maximum(
            res.spread.numpy()[:, 0], 1e-6)
        return float(np.sqrt(np.mean(z[10:] ** 2)))

    z_plain, z_infl = zscore(1.0), zscore(1.08)
    assert abs(np.log(z_infl)) < abs(np.log(z_plain)) + 0.15

    _, ys = _data(t_n, seed=7)
    sd_true = np.sqrt(np.asarray(_kalman(ys).covs)[:, 0, 0])

    def spread_err(variant):
        return float(np.mean([np.abs(mt.ensemble_kalman_filter(
            seed, _linear_model(), ys, 10, variant=variant,
            device="cpu").spread.numpy()[:, 0] - sd_true).mean()
            for seed in range(4)]))

    assert spread_err("etkf") < spread_err("stochastic")
    with pytest.raises(ValueError, match="variant"):
        mt.ensemble_kalman_filter(0, _linear_model(), ys, 8, variant="enks",
                                  device="cpu")
    with pytest.raises(ValueError, match="n_ensemble"):
        mt.ensemble_kalman_filter(0, _linear_model(), ys, 1, device="cpu")
    bad = _linear_model()._replace(obs_cov=torch.eye(2))
    with pytest.raises(ValueError, match="obs_cov"):
        mt.ensemble_kalman_filter(0, bad, ys, 8, device="cpu")


def test_enkf_nonlinear_and_high_dimensional():
    t_n, sig = 80, 0.15
    rng = np.random.default_rng(5)
    x = np.empty(t_n)
    x[0] = 0.5
    for t in range(1, t_n):
        x[t] = x[t - 1] + 0.5 * np.sin(x[t - 1]) + sig * rng.standard_normal()
    ys = (x + 0.3 * rng.standard_normal(t_n)).astype(np.float32)
    model = mt.EnKFModel(
        init_sample=lambda g, n: torch.randn((n, 1), generator=g),
        trans_sample=lambda g, z, t: z + 0.5 * torch.sin(z) + sig
        * torch.randn(z.shape, generator=g),
        obs_fn=lambda z, t: z, obs_cov=torch.tensor([[0.09]]))
    res = mt.ensemble_kalman_filter(1, model, ys, 256, device="cpu")
    assert np.isfinite(float(res.loglik))
    assert np.sqrt(np.mean((res.means.numpy()[10:, 0] - x[10:]) ** 2)) < 0.3

    d, e, t_n, n = 512, 32, 20, 64
    rng = np.random.default_rng(2)
    h_rows = torch.as_tensor(rng.choice(d, size=e, replace=False))
    ys = rng.standard_normal((t_n, e)).astype(np.float32)
    model = mt.EnKFModel(
        init_sample=lambda g, n_: torch.randn((n_, d), generator=g),
        trans_sample=lambda g, x_, t: 0.98 * x_ + 0.1 * torch.randn(
            x_.shape, generator=g),
        obs_fn=lambda x_, t: x_[:, h_rows], obs_cov=torch.eye(e))
    res = mt.ensemble_kalman_filter(0, model, ys, n, device="cpu")
    assert np.isfinite(float(res.loglik))
    assert tuple(res.means.shape) == (t_n, d)
    assert torch.isfinite(res.ensemble).all()


# -- UKF (tests/test_ukf.py) ----------------------------------------------------------

A2 = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
H2 = np.array([[1.0, 0.0]], np.float32)
Q2 = 0.3 * np.eye(2, dtype=np.float32)
R2 = np.array([[0.25]], np.float32)


def _linear_data(t_n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2)
    ys = np.empty((t_n, 1), np.float32)
    for t in range(t_n):
        if t > 0:
            x = A2 @ x + rng.multivariate_normal(np.zeros(2), Q2)
        ys[t] = H2 @ x + np.sqrt(R2[0, 0]) * rng.standard_normal()
    return ys


def _nl_data(t_n=50, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal()
    ys = np.empty((t_n, 1), np.float32)
    for t in range(t_n):
        if t > 0:
            x = 0.8 * x + 0.5 * np.sin(x) + 0.3 * rng.standard_normal()
        ys[t] = x + 0.2 * x ** 2 + 0.5 * rng.standard_normal()
    return ys


def _ukf_models(lib, dtype, log_q=None):
    """The linear and the nonlinear model of tests/test_ukf.py."""
    arr = (lambda a: jnp.asarray(a, dtype)) if lib is jnp else (
        lambda a: torch.as_tensor(np.asarray(a), dtype=dtype))
    q1 = 0.09 if log_q is None else lib.exp(log_q)
    lin_model = (ju.UKFModel if lib is jnp else mt.UKFModel)(
        f=lambda x, t: x @ arr(A2).T, h=lambda x, t: x @ arr(H2).T,
        Q=arr(Q2), R=arr(R2), m0=arr(np.zeros(2)), P0=arr(np.eye(2)))
    nl_model = (ju.UKFModel if lib is jnp else mt.UKFModel)(
        f=lambda x, t: 0.8 * x + 0.5 * lib.sin(x),
        h=lambda x, t: x + 0.2 * x ** 2,
        Q=q1 * arr(np.eye(1)), R=0.25 * arr(np.eye(1)),
        m0=arr(np.zeros(1)), P0=arr(np.eye(1)))
    return lin_model, nl_model


def test_ukf_and_urts_match_jax_float64():
    lin_ys, nl_ys = _linear_data(30).astype(np.float64), _nl_data(
        25).astype(np.float64)
    with jax.enable_x64(True):
        j_lin, j_nl = _ukf_models(jnp, jnp.float64)
        want = [ju.unscented_kalman_filter(j_lin, lin_ys),
                ju.unscented_kalman_filter(j_nl, nl_ys, alpha=0.7, kappa=1.0)]
        want_s = [ju.unscented_rts_smoother(j_lin, lin_ys),
                  ju.unscented_rts_smoother(j_nl, nl_ys)]
    t_lin, t_nl = _ukf_models(torch, F64)
    got = [mt.unscented_kalman_filter(t_lin, lin_ys),
           mt.unscented_kalman_filter(t_nl, nl_ys, alpha=0.7, kappa=1.0)]
    got_s = [mt.unscented_rts_smoother(t_lin, lin_ys),
             mt.unscented_rts_smoother(t_nl, nl_ys)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=REPLAY_TOL)
    for g, w in zip(got_s, want_s):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=REPLAY_TOL)


def test_ukf_linear_degeneracy_gradient_and_shapes():
    ys = _linear_data()
    lp = jl.lgss_params(A=A2, b=np.zeros(2), Q=Q2, H=H2, c=np.zeros(1),
                        R=R2, m0=np.zeros(2), P0=np.eye(2))
    exact = jl.kalman_filter(lp, ys, method="sequential", initial="state")
    lin, nl = _ukf_models(torch, torch.float32)
    r = mt.unscented_kalman_filter(lin, ys)
    np.testing.assert_allclose(float(r.loglik), float(exact.loglik),
                               rtol=1e-4)
    np.testing.assert_allclose(r.means.numpy(), np.asarray(exact.means),
                               atol=2e-4)
    np.testing.assert_allclose(r.covs.numpy(), np.asarray(exact.covs),
                               atol=2e-4)
    ms, ps = mt.unscented_rts_smoother(lin, ys)
    ems, eps = jl.rts_smoother(lp, ys, method="sequential", initial="state")
    np.testing.assert_allclose(ms.numpy(), np.asarray(ems), atol=5e-4)
    np.testing.assert_allclose(ps.numpy(), np.asarray(eps), atol=5e-4)
    assert np.all(np.diagonal(ps.numpy(), axis1=1, axis2=2)
                  <= np.diagonal(r.covs.numpy(), axis1=1, axis2=2) + 1e-5)

    ys = _nl_data(t_n=25)

    def nll(log_q):
        return -mt.unscented_kalman_filter(
            _ukf_models(torch, torch.float32, log_q)[1], ys).loglik

    log_q = torch.tensor(-2.0, requires_grad=True)
    (g,) = torch.autograd.grad(nll(log_q), log_q)
    assert torch.isfinite(g)
    assert nll(torch.log(torch.tensor(0.09))) < nll(torch.tensor(-6.0))
    ys = _nl_data(t_n=12)[:, 0]
    r = mt.unscented_kalman_filter(nl, ys)
    assert tuple(r.means.shape) == (12, 1) and tuple(r.covs.shape) == (12, 1,
                                                                       1)
    assert tuple(r.pred_means.shape) == (12, 1)
    assert np.isfinite(float(r.loglik))
    ms, ps = mt.unscented_rts_smoother(nl, filtered=r)
    assert tuple(ms.shape) == (12, 1) and tuple(ps.shape) == (12, 1, 1)
    with pytest.raises(ValueError, match="ys"):
        mt.unscented_rts_smoother(nl)


# -- EKI / EKS (tests/test_eks.py) -------------------------------------------------

P_DIM, E_DIM = 3, 5


def _linear_problem():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((E_DIM, P_DIM)).astype(np.float32)
    gamma = 0.25 * np.eye(E_DIM, dtype=np.float32)
    y = (a @ np.array([0.5, -1.0, 2.0], np.float32)
         + 0.5 * rng.standard_normal(E_DIM)).astype(np.float32)
    c0 = 4.0 * np.eye(P_DIM, dtype=np.float32)
    gi = np.linalg.inv(gamma)
    post_cov = np.linalg.inv(a.T @ gi @ a + np.linalg.inv(c0))
    return a, y, gamma, c0, post_cov @ (a.T @ gi @ y), post_cov


def test_eki_and_eks_replay_jax_float64():
    a, y, gamma, c0, _, _ = _linear_problem()
    a, y, gamma, c0 = (x.astype(np.float64) for x in (a, y, gamma, c0))
    j_n, iters = 16, 6
    key = jax.random.key(3)
    with jax.enable_x64(True):
        fwd = lambda th: th @ jnp.asarray(a).T  # noqa: E731
        eki = jk.ensemble_kalman_inversion(key, fwd, y, gamma,
                                           np.zeros(P_DIM), c0, j_n, iters)
        eks = jk.ensemble_kalman_sampler(key, fwd, y, gamma, np.zeros(P_DIM),
                                         c0, j_n, iters)
        z_eki = np.asarray(jax.random.normal(key, (j_n, P_DIM), jnp.float64))
        k_init, k = jax.random.split(key)
        z0 = np.asarray(jax.random.normal(k_init, (j_n, P_DIM), jnp.float64))
        xis = []
        for _ in range(iters):
            k, k_noise = jax.random.split(k)
            xis.append(np.asarray(jax.random.normal(k_noise, (j_n, j_n),
                                                    jnp.float64)))
    tfwd = lambda th: th @ _t(a).mT  # noqa: E731
    got = mt.ensemble_kalman_inversion(0, tfwd, y, gamma, np.zeros(P_DIM),
                                       c0, j_n, iters, noise=_t(z_eki),
                                       device="cpu")
    for p, q in zip(got, eki):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=0,
                                   atol=REPLAY_TOL)
    got = mt.ensemble_kalman_sampler(0, tfwd, y, gamma, np.zeros(P_DIM),
                                     c0, j_n, iters, noise=(
                                         _t(z0), lambda i: _t(xis[i])),
                                     device="cpu")
    for p, q in zip(got, eks):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=0,
                                   atol=REPLAY_TOL)


def test_eki_collapses_and_eks_recovers_the_conjugate_posterior():
    a, y, gamma, c0, post_mean, post_cov = _linear_problem()
    fwd = lambda th: th @ torch.as_tensor(a).mT  # noqa: E731
    r = mt.ensemble_kalman_inversion(2, fwd, y, gamma, np.zeros(P_DIM), c0,
                                     n_ensemble=256, n_iters=40, device="cpu")
    np.testing.assert_allclose(r.theta.numpy(), post_mean, atol=0.15)
    m = r.misfit_trace.numpy()
    assert m[-1] < 0.05 * m[0]
    assert r.ensemble.numpy().std(axis=0).max() < 0.2
    with pytest.raises(ValueError, match="flat"):
        mt.ensemble_kalman_inversion(0, fwd, np.zeros((2, 2)), gamma,
                                     np.zeros(P_DIM), c0, device="cpu")
    with pytest.raises(ValueError, match="n_ensemble"):
        mt.ensemble_kalman_inversion(0, fwd, y, gamma, np.zeros(P_DIM), c0,
                                     n_ensemble=2, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        mt.ensemble_kalman_inversion(0, fwd, y, np.eye(2), np.zeros(P_DIM),
                                     c0, device="cpu")
    r = mt.ensemble_kalman_sampler(3, fwd, y, gamma, np.zeros(P_DIM), c0,
                                   n_ensemble=512, device="cpu")
    np.testing.assert_allclose(r.mean.numpy(), post_mean, atol=0.15)
    ratio = np.diag(r.cov.numpy()) / np.diag(post_cov)
    assert np.all((ratio > 0.6) & (ratio < 1.6)), ratio


def test_eks_nonlinear_forward_concentrates():
    rng = np.random.default_rng(4)
    theta_true = np.array([0.8, -0.3], np.float32)

    def fwd(th):
        return torch.stack([th[:, 0] + 0.3 * torch.sin(th[:, 1]),
                            th[:, 1] + 0.1 * th[:, 0] ** 2,
                            th[:, 0] * th[:, 1]], 1)

    y = fwd(torch.as_tensor(theta_true[None, :]))[0].numpy()
    y = (y + 0.1 * rng.standard_normal(3)).astype(np.float32)
    r = mt.ensemble_kalman_sampler(5, fwd, y, 0.01 * np.eye(3, dtype=np.float32),
                                   np.zeros(2), 4.0 * np.eye(2, dtype=np.float32),
                                   n_ensemble=512, n_iters=600, device="cpu")
    assert torch.isfinite(r.ensemble).all()
    np.testing.assert_allclose(r.mean.numpy(), theta_true, atol=0.3)
    assert r.cov.numpy().diagonal().max() < 1.0
