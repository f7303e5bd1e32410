"""The port's DSL ``Model`` (``mcmcpp_tpu_torch/dsl.py``) against the JAX
package's on the same models and seeded numpy inputs.

- ``build()``'s logp and its gradient in float64 on five models (a
  hierarchical one with a callable prior and a plate, a stick-breaking
  mixture with a learned DP concentration, an LKJ covariance, truncated and
  censored Gamma/InverseGamma likelihoods whose concentration is sampled,
  and a masked observe with NaN data, plus ordered and circular sites):
  logp to 1e-10 relative, the gradient against ``jax.grad`` to 1e-8
  relative (measured ≤ 1e-13);
- ``build_split`` (its halves sum to ``build``'s logp and equal JAX's) and
  ``constrain`` (equal to JAX's to 1e-12);
- ``pointwise_log_likelihood`` equal to JAX's (NaN where masked), and the
  ``loo``/``waic`` it feeds equal to JAX's to 1e-10;
- the draws, whose streams differ from JAX's, by moments: exact prior draws
  and the predictives within 5 standard errors of the analytic moments;
- the engines on a DSL logp: the ensemble sampler on the conjugate normal
  model, SMC on ``build_split`` (log Z within the JAX test's 0.15), and
  ``export.to_inference_dict(model=)`` on a port ``Model``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import analysis as jan
from mcmcpp_tpu import dsl as J
from mcmcpp_tpu_torch import analysis as pan
from mcmcpp_tpu_torch import dsl as T

torch.set_num_threads(1)

_rng = np.random.default_rng(0)
Y8 = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
S8 = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
CAT = _rng.integers(0, 4, 20).astype(np.float64)
Y3 = _rng.normal(size=(2, 3)) * np.array([1.0, 2.0, 0.5])
YPOS = _rng.gamma(2.0, 1.0, 12) + 0.35
CMASK = np.arange(12) % 3 == 0
YMISS = _rng.normal(1.0, 2.0, 10)
MMASK = np.arange(10) % 4 != 1
YMISS[~MMASK] = np.nan
ANG = np.array([0.3, 0.9, -0.2, 2.9, -3.0])


def hierarchical(m):
    return (m.Model()
            .plate("schools", 8)
            .param("mu", m.Normal(0.0, 10.0))
            .param("tau", m.HalfCauchy(5.0))
            .param("theta", lambda p: m.Normal(p["mu"], p["tau"]),
                   plate="schools", transform=m.Identity())
            .deterministic("shift", lambda p: p["theta"] - p["mu"])
            .observe("y", lambda p: m.Normal(p["theta"], S8), Y8))


def stick_breaking(m):
    return (m.Model()
            .param("alpha", m.Gamma(2.0, 1.0))
            .param("w", lambda p: m.GEM(p["alpha"], 4), shape=(4,),
                   transform=m.StickBreaking(4))
            .param("v", m.Dirichlet(np.array([1.0, 2.0, 3.0])), shape=(3,))
            .observe("z", lambda p: m.Categorical(probs=p["w"]), CAT))


def lkj(m):
    zeros = np.zeros(3)
    return (m.Model()
            .param("L", m.LKJCholesky(3, 2.0), shape=(3, 3))
            .param("scales", m.HalfNormal(1.5), shape=(3,))
            .deterministic("chol", lambda p: p["scales"][:, None] * p["L"])
            .observe("y0", lambda p: m.MvNormal(zeros, chol=p["chol"]), Y3[0])
            .observe("y1", lambda p: m.MvNormal(zeros, chol=p["chol"]),
                     Y3[1]))


def truncated_censored(m):
    """The concentration a is sampled: the gradient goes through gammainc
    and gammaincc in a (the derivative torch's backward refuses)."""
    return (m.Model()
            .param("a", m.Gamma(3.0, 1.0))
            .param("b", m.LogNormal(0.0, 0.5))
            .param("s", m.Truncated(m.Normal(0.0, 1.0), low=0.0))
            .observe("t", lambda p: m.Truncated(m.Gamma(p["a"], p["b"]),
                                                low=0.3), YPOS)
            .observe("c", lambda p: m.Censored(m.InverseGamma(p["a"], p["b"]),
                                               right=CMASK), YPOS)
            .observe("l", lambda p: m.Censored(m.Gamma(p["a"], p["b"]),
                                               left=CMASK), YPOS)
            .observe("h", lambda p: m.Truncated(
                m.InverseGamma(p["a"] + 1.0, p["s"] + 0.5), high=3.5),
                YPOS[YPOS < 3.5]))


def masked(m):
    return (m.Model()
            .param("mu", m.Normal(0.0, 5.0))
            .param("sd", m.HalfNormal(2.0))
            .param("locs", m.ordered(m.Normal(0.0, 3.0)), shape=(3,))
            .param("angle", m.VonMises(0.5, 2.0))
            .observe("y", lambda p: m.Normal(p["mu"], p["sd"]), YMISS,
                     mask=MMASK)
            .observe("a", lambda p: m.VonMises(p["angle"], 4.0), ANG)
            .likelihood(lambda p: -0.5 * ((p["locs"][0] + 1.0) ** 2).sum()))


MODELS = {"hierarchical": hierarchical, "stick_breaking": stick_breaking,
          "lkj": lkj, "truncated_censored": truncated_censored,
          "masked": masked}


def _theta(dim, n=5, seed=1):
    return np.random.default_rng(seed).normal(size=(n, dim)) * 0.7


def _port_value_and_grad(logp, th):
    q = torch.tensor(th, requires_grad=True)
    out = torch.func.vmap(logp)(q)
    out.sum().backward()
    return out.detach().numpy(), q.grad.numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_logp_and_gradient_match_jax(name):
    tl, tdim, _ = MODELS[name](T).build()
    th = _theta(tdim)
    with jax.enable_x64(True):
        # (declared under x64: JAX's observe keeps its data in the dtype of
        # the moment it is declared)
        jl, jdim, _ = MODELS[name](J).build()
        assert tdim == jdim
        want, dwant = (np.asarray(v) for v in jax.jit(jax.vmap(
            jax.value_and_grad(jl)))(th))
    got, dgot = _port_value_and_grad(tl, th)
    assert np.isfinite(want).all() and np.isfinite(dwant).all()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(dgot, dwant, rtol=1e-8,
                               atol=1e-8 * np.abs(dwant).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_split_and_constrain_match_jax(name):
    tp, tll, dim, tc, _ = MODELS[name](T).build_split()
    tlogp = MODELS[name](T).build()[0]
    th = _theta(dim, seed=2)
    with jax.enable_x64(True):
        jp, jll, _, jc, _ = MODELS[name](J).build_split()
        want_p = np.asarray(jax.jit(jax.vmap(jp))(th))
        want_l = np.asarray(jax.jit(jax.vmap(jll))(th))
        want_c = jc(th)
    tt = torch.tensor(th)
    got_p = torch.func.vmap(tp)(tt).numpy()
    got_l = torch.func.vmap(tll)(tt).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-10)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-10)
    np.testing.assert_allclose(got_p + got_l,
                               torch.func.vmap(tlogp)(tt).numpy(), rtol=1e-12)
    got_c = tc(th)
    assert set(got_c) == set(want_c)
    for k in want_c:
        assert isinstance(got_c[k], np.ndarray)
        np.testing.assert_allclose(got_c[k], want_c[k], rtol=1e-12,
                                   atol=1e-14)
    # a tensor in gives the same dict
    for k, v in tc(tt).items():
        np.testing.assert_array_equal(v, got_c[k])


def test_masked_observe_keeps_gradients_finite_and_drops_entries():
    logp, dim, _ = masked(T).build()
    full = (T.Model()
            .param("mu", T.Normal(0.0, 5.0)).param("sd", T.HalfNormal(2.0))
            .param("locs", T.ordered(T.Normal(0.0, 3.0)), shape=(3,))
            .param("angle", T.VonMises(0.5, 2.0))
            .observe("y", lambda p: T.Normal(p["mu"], p["sd"]), YMISS[MMASK])
            .observe("a", lambda p: T.VonMises(p["angle"], 4.0), ANG)
            .likelihood(lambda p: -0.5 * ((p["locs"][0] + 1.0) ** 2).sum()))
    th = torch.tensor(_theta(dim, 3), requires_grad=True)
    out = torch.func.vmap(logp)(th)
    out.sum().backward()
    assert torch.isfinite(th.grad).all()
    torch.testing.assert_close(out.detach(),
                               torch.func.vmap(full.build()[0])(th.detach()),
                               rtol=1e-13, atol=0)


def test_pointwise_log_likelihood_feeds_loo_and_waic_as_in_jax():
    th = _theta(masked(T).dim, n=400, seed=3) * 0.3
    with jax.enable_x64(True):
        want = masked(J).pointwise_log_likelihood(th)
    got = masked(T).pointwise_log_likelihood(th)
    assert set(got) == set(want) == {"y", "a"}
    for k in want:
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10)
    assert np.isnan(got["y"][:, ~MMASK]).all()
    for fn in ("loo", "waic"):
        a = getattr(pan, fn)(got["y"])
        b = getattr(jan, fn)(want["y"])
        assert a._fields == b._fields and a.method == b.method == fn
        for x, y in zip(a[:-1], b[:-1]):
            np.testing.assert_allclose(np.asarray(x, np.float64),
                                       np.asarray(y, np.float64),
                                       rtol=1e-10, atol=1e-12)


def test_prior_sample_is_exact_by_moments():
    """build_split's prior draws, constrained: each site's prior moments
    within 5 standard errors (the ordered site: the order statistics of
    three N(0, 3²); the circular site: VonMises(0.5, 2)'s circular mean)."""
    from scipy import stats as sps

    m = masked(T)
    _, _, dim, constrain, prior_sample = m.build_split()
    n = 20000
    u = prior_sample(torch.Generator().manual_seed(4), n)
    assert u.shape == (n, dim) and u.dtype == torch.float32
    v = constrain(u)
    checks = [(v["mu"], 0.0), (v["sd"], 2.0 * math.sqrt(2 / math.pi))]
    # E of the smallest of three N(0, 9): -3·0.846284
    checks.append((v["locs"][:, 0], -3.0 * 0.8462843753216345))
    assert (np.diff(v["locs"], axis=1) > 0).all()
    for x, mean in checks:
        assert abs(x.mean() - mean) <= 5 * x.std() / math.sqrt(n)
    c = np.cos(v["angle"] - 0.5).mean()
    want = sps.vonmises(2.0).expect(np.cos)
    assert abs(c - want) <= 5 * np.cos(v["angle"]).std() / math.sqrt(n)


def test_hierarchical_prior_sample_draws_ancestrally():
    m = hierarchical(T)
    u = m.prior_sample(torch.Generator().manual_seed(5), 400)
    v = m.build()[2](u)
    assert v["theta"].shape == (400, 8)
    # theta | mu, tau ~ N(mu, tau): the standardized draws are N(0, 1)
    z = (v["theta"] - v["mu"][:, None]) / v["tau"][:, None]
    assert abs(z.mean()) < 5 / math.sqrt(z.size)
    assert abs(z.std() - 1.0) < 0.05


def test_predictives_by_moments():
    m = (T.Model()
         .param("mu", T.Normal(0.0, 2.0))
         .param("sigma", T.HalfNormal(1.5))
         .observe("y", lambda p: T.Normal(p["mu"], p["sigma"]),
                  np.zeros(3)))
    # a posterior that is one point: replicated data ~ N(1.2, 0.7²)
    u = np.tile([1.2, math.log(0.7)], (1500, 1))
    rep = m.posterior_predictive(torch.Generator().manual_seed(6), u)["y"]
    assert rep.shape == (1500, 3)
    assert abs(rep.mean() - 1.2) < 5 * 0.7 / math.sqrt(rep.size)
    assert abs(rep.std() - 0.7) < 0.03
    sims, u0 = m.prior_predictive(torch.Generator().manual_seed(7), 1500)
    assert sims["y"].shape == (1500, 3) and u0.shape == (1500, 2)
    # y ~ N(mu, sigma²): var = 4 + E sigma² = 4 + 2.25
    assert abs(sims["y"].mean()) < 5 * math.sqrt(6.25 / 1500)
    assert abs(sims["y"].var() / 6.25 - 1.0) < 0.15
    with pytest.raises(ValueError, match="unknown observe site"):
        m.posterior_predictive(torch.Generator(), u, names=["nope"])


def test_model_validation_matches_jax():
    for m in (J, T):
        with pytest.raises(ValueError, match="duplicate"):
            m.Model().param("a", m.Normal()).param("a", m.Normal())
        with pytest.raises(ValueError, match="explicit transform"):
            m.Model().param("a", lambda p: m.Normal())
        with pytest.raises(ValueError, match="unknown plate"):
            m.Model().param("a", m.Normal(), plate="g")
        with pytest.raises(ValueError, match="no parameters"):
            m.Model().build()
        with pytest.raises(ValueError, match="no observe"):
            m.Model().param("a", m.Normal()).posterior_predictive(
                None, np.zeros((1, 1)))


def test_conjugate_normal_posterior_with_the_ensemble_sampler():
    """The JAX test's conjugate oracle (N(mu, 1) likelihood, N(0, 10²)
    prior) through the port's EnsembleSampler and FusedStretchMove on the
    DSL's per-θ logp (vmapped by the sampler; the plain split half-step on
    the CPU)."""
    import mcmcpp_tpu_torch as mt

    data = np.random.default_rng(0).normal(3.0, 1.0, 50)
    model = (T.Model().param("mu", T.Normal(0.0, 10.0))
             .observe("y", lambda p: T.Normal(p["mu"], 1.0), data))
    logp, dim, constrain = model.build()
    prec = 1 / 100 + 50
    post_mean = data.sum() / prec
    s = mt.EnsembleSampler(logp, n_walkers=64, n_params=dim, seed=2,
                           mover=mt.FusedStretchMove(), device="cpu")
    s.init_ball(np.zeros(dim), scale=1.0)
    s.run_mcmc(200, store=False)
    s.run_mcmc(1000)
    mu = constrain(s.get_samples(flat=True))["mu"]
    assert mu.mean() == pytest.approx(post_mean, abs=0.05)
    assert mu.var() == pytest.approx(1 / prec, rel=0.2)
    post = mt.to_inference_dict(s, model=model)["posterior"]
    assert post["mu"].shape == (64, 1000)


def test_smc_on_build_split_recovers_the_evidence():
    """The JAX test's DSL evidence oracle through the port's SMC."""
    import mcmcpp_tpu_torch as mt

    data = np.array([1.1, 0.3, 0.9, 1.7, 0.6, 1.2])
    m = (T.Model().param("mu", T.Normal(0.0, 2.0))
         .observe("y", lambda p: T.Normal(p["mu"], 1.0), data))
    logprior, loglike, dim, _, prior_sample = m.build_split()
    n = data.size
    cov = 4.0 * np.ones((n, n)) + np.eye(n)
    logz = float(-0.5 * data @ np.linalg.solve(cov, data)
                 - 0.5 * np.linalg.slogdet(cov)[1] - n / 2 * np.log(2 * np.pi))
    smc = mt.SMCSampler(logprior, loglike, prior_sample, n_particles=2048,
                        n_params=dim, n_mcmc=5, seed=0, device="cpu")
    smc.run()
    assert smc.log_evidence == pytest.approx(logz, abs=0.15)


def test_chees_leapfrog_count_saturates_as_jax():
    """ChEES's leapfrog count converts as XLA's float-to-int32 does: a NaN
    trajectory (early warmup, after a proposal overflowed) takes one step
    and an infinite one the cap, where the port raised before."""
    from mcmcpp_tpu_torch.gradient.chees import n_leapfrog

    assert n_leapfrog(0.1, float("nan"), 0.5, 1024) == 1
    assert n_leapfrog(0.1, float("inf"), 0.5, 1024) == 1024
    assert n_leapfrog(0.0, 1.0, 0.5, 1024) == 1024
    assert n_leapfrog(0.3, 1.0, 0.25, 1024) == 2
    with jax.enable_x64(False):
        for t in (float("nan"), float("inf"), -float("inf"), 1e12):
            want = int(jnp.clip(jnp.ceil(jnp.float32(2 * 0.5) * jnp.float32(t)
                                         / jnp.float32(0.1))
                                .astype(jnp.int32), 1, 1024))
            assert n_leapfrog(0.1, t, 0.5, 1024) == want


def test_chees_on_a_dsl_model_whose_warmup_overflows():
    """The README's DSL model: ChEES's early step sizes overflow a proposal
    (exp of the log-scale), its trajectory length goes NaN in warmup, in the
    JAX package as here, and the run goes on at one leapfrog a transition to
    the posterior's moments."""
    import mcmcpp_tpu_torch as mt

    y = np.random.default_rng(0).normal(1.0, 2.0, 50)
    model = (T.Model().param("mu", T.Normal(0.0, 10.0))
             .param("sd", T.HalfNormal(5.0))
             .observe("y", lambda p: T.Normal(p["mu"], p["sd"]), y))
    logp, dim, constrain = model.build()
    s = mt.CheesHMCSampler(torch.func.vmap(logp), 256, dim, seed=0,
                           device="cpu")
    s.init_ball(np.zeros(dim), 0.5)
    s.warmup(150)
    s.run(100)
    d = constrain(s.get_samples(flat=True))
    assert d["mu"].mean() == pytest.approx(y.mean(), abs=0.1)
    assert d["sd"].mean() == pytest.approx(y.std(), abs=0.15)
