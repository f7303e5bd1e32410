"""The models and closed-form oracles of the port's eight later example
programs (``mcmcpp_tpu_torch/examples/{dp_mixture,tempering_and_dsl,
bayesian_workflow,evidence,function_space,gp_hyperparams,gp_latent,
gradient_inference}.py``) against the JAX package's programs under
``examples/``, on the same numpy data and 64 seeded θ:

- each log density (and its gradient where an engine takes one) in float64
  to 1e-9 relative, or in float32 to 1e-5 where the JAX program computes in
  float32 (its data or factor are float32);
- the data equal to the JAX program's draws (bit for bit where they are
  numpy; gp_hyperparams' latent is a float32 product with a Cholesky factor
  of a near-singular Gram, which the two packages' LAPACKs round apart:
  within 0.02, against a noise sd of 0.2);
- the oracles: the exact GP-regression posterior mean (function_space), the
  exact marginal hyperposterior (gp_hyperparams, on the JAX program's own
  data: 1e-12), the evidence quadrature (both models, through either
  package's functions: 1e-9) and the closed-form log evidence of
  gradient_inference's SMC run.

Where the JAX program defines its model inside ``main`` the test writes the
same lines in ``jax.numpy``.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import dsl as J
from mcmcpp_tpu.models import gaussian_mixture as j_gaussian_mixture
from mcmcpp_tpu_torch import gaussian_mixture
from mcmcpp_tpu_torch.examples import (
    bayesian_workflow,
    dp_mixture,
    evidence,
    function_space,
    gp_hyperparams,
    gp_latent,
    gradient_inference,
    tempering_and_dsl,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


def jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def thetas(dim, scale=0.7, seed=0, n=64):
    return scale * np.random.default_rng(seed).standard_normal((n, dim))


def both(port_fn, jax_fn, th, dtype=torch.float64, grad=True):
    """(port values, JAX values[, port grads, JAX grads]) over the rows of
    ``th``: the port's per-θ function vmapped, JAX's under x64."""
    t = torch.as_tensor(th, dtype=dtype)
    got = torch.func.vmap(port_fn)(t).numpy()
    with jax.enable_x64(dtype == torch.float64):
        x = jnp.asarray(th, jnp.float64 if dtype == torch.float64
                        else jnp.float32)
        want = np.asarray(jax.vmap(jax_fn)(x))
        if not grad:
            return got, want
        jg = np.asarray(jax.vmap(jax.grad(jax_fn))(x))
    tg = torch.func.vmap(torch.func.grad(port_fn))(t).numpy()
    return got, want, tg, jg


def test_dp_mixture_model_equals_jax():
    jd = jax_example("dp_mixture")
    y = dp_mixture.make_data(400)
    np.testing.assert_array_equal(y, jd.make_data(400))
    logp, dim, _ = dp_mixture.build_model(y).build()
    with jax.enable_x64(True):
        jlogp, jdim, _ = jd.build_model(y).build()
    assert dim == jdim == 24
    got, want, tg, jg = both(logp, jlogp, thetas(dim, 0.5))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(tg, jg, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dp_mixture.true_density(dp_mixture.GRID),
                               jd.true_density(dp_mixture.GRID), rtol=1e-12)


def test_dp_mixture_density_oracle():
    """The L1 error of the true mixture against itself is 0, and a mixture
    of the true components at the true weights gives the truth back."""
    k = dp_mixture.K
    w = np.zeros((5, k))
    w[:, :3] = dp_mixture.TRUE_W
    mu = np.tile(np.r_[dp_mixture.TRUE_MEANS, np.zeros(k - 3)], (5, 1))
    sd = np.tile(np.r_[dp_mixture.TRUE_SDS, np.ones(k - 3)], (5, 1))
    dens = dp_mixture.predictive_density({"w": w, "mu": mu, "sigma": sd},
                                         dp_mixture.GRID)
    np.testing.assert_allclose(dens, dp_mixture.true_density(
        dp_mixture.GRID), rtol=1e-12)
    assert dp_mixture.l1_error(dens, dp_mixture.GRID) < 1e-12


def test_tempering_and_dsl_models_equal_jax():
    y = tempering_and_dsl.make_data()
    np.testing.assert_array_equal(
        y, np.random.default_rng(0).normal(1.5, 0.7, 200).astype(np.float32))
    logp, dim, _ = tempering_and_dsl.build_model(
        torch.as_tensor(y, dtype=torch.float64)).build()
    with jax.enable_x64(True):
        data = jnp.asarray(y)
        jlogp, _, _ = (
            J.Model()
            .param("mu", J.Normal(0.0, 10.0))
            .param("sigma", J.HalfNormal(2.0))
            .likelihood(
                lambda p: jnp.sum(J.Normal(p["mu"], p["sigma"]).logpdf(data)))
        ).build()
    got, want, tg, jg = both(logp, jlogp, thetas(dim, 0.8))
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(tg, jg, **F64)
    t = gaussian_mixture([[-8.0], [8.0]], scales=[0.5, 0.5], device="cpu")
    jt = j_gaussian_mixture([[-8.0], [8.0]], scales=[0.5, 0.5])
    x = thetas(1, 9.0)
    np.testing.assert_allclose(
        t(torch.as_tensor(x, dtype=torch.float32)).detach().numpy(),
        np.asarray(jax.vmap(jt.logp)(jnp.asarray(x, jnp.float32))), **F32)


def test_bayesian_workflow_funnels_equal_jax():
    d = 10

    def j_centered(t):  # the JAX program's lines
        v, x = t[0], t[1:]
        return (-0.5 * (v / 3.0) ** 2
                - 0.5 * jnp.sum(x * x) * jnp.exp(-v) - 0.5 * v * (d - 1))

    def j_noncentered(t):
        v, z = t[0], t[1:]
        return -0.5 * (v / 3.0) ** 2 - 0.5 * jnp.sum(z * z)

    th = thetas(d, 1.2)
    for port_fn, jax_fn in [(bayesian_workflow.centered(d), j_centered),
                            (bayesian_workflow.noncentered, j_noncentered)]:
        got, want, tg, jg = both(port_fn, jax_fn, th)
        np.testing.assert_allclose(got, want, **F64)
        np.testing.assert_allclose(tg, jg, **F64)


@pytest.mark.parametrize("name", ["m1", "m2"])
def test_evidence_models_and_quadrature_equal_jax(name):
    je = jax_example("evidence")
    y = evidence.make_data()
    np.testing.assert_array_equal(y, np.asarray(je.DATA))
    lp, ll, sample = getattr(evidence, name)(
        torch.as_tensor(y, dtype=torch.float64))
    jlp, jll = getattr(je, f"{name}_logprior"), getattr(je, f"{name}_loglike")
    th = np.abs(thetas(1, 2.5)) if name == "m2" else thetas(1, 2.5)
    for port_fn, jax_fn in [(lp, jlp), (ll, jll)]:
        got, want, tg, jg = both(port_fn, jax_fn, th)
        np.testing.assert_allclose(got, want, **F64)
        np.testing.assert_allclose(tg, jg, **F64)
    if name == "m2":  # the prior's support: s > 0
        got, want = both(lp, jlp, -np.abs(th[:4]), grad=False)
        assert np.isneginf(got).all() and np.isneginf(want).all()
    # the quadrature through the port's functions and through JAX's
    quad = evidence.quadrature_logz(lp, ll)
    grid = np.linspace(-20.0, 20.0, 400_001)
    with jax.enable_x64(True):
        f = np.asarray(jax.vmap(lambda t: jlp(t) + jll(t))(
            jnp.asarray(grid[:, None])))
    w = np.full_like(f, 40.0 / 400_000)
    w[0] = w[-1] = 0.5 * w[0]
    m = f.max()
    assert quad == pytest.approx(
        m + math.log(np.sum(w * np.exp(f - m))), rel=1e-9)
    g = torch.Generator().manual_seed(0)
    draws = sample(g, 4096)
    assert draws.shape == (4096, 1)
    assert (draws > 0).all() if name == "m2" else draws.mean().abs() < 0.3


def test_function_space_problem_equals_jax():
    jf = jax_example("function_space")
    np.testing.assert_array_equal(function_space.Y_OBS, jf.Y_OBS)
    for p in function_space.SIZES:
        chol, loglike, exact = function_space.problem(p, "cpu")
        jchol, jloglike, jexact = jf._problem(p)
        np.testing.assert_array_equal(chol, jchol)
        np.testing.assert_array_equal(exact, jexact)
        th = thetas(p, 1.0, seed=p)
        got, want = both(loglike, jloglike, th, dtype=torch.float32,
                         grad=False)
        np.testing.assert_allclose(got, want, **F32)


def test_gp_latent_problem_equals_jax():
    n = 60
    chol, f_true, y = gp_latent.make_problem(n)
    # the JAX program's lines
    rng = np.random.default_rng(0)
    x = np.linspace(0.0, 4.0, n)
    k = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.5 ** 2)
    jchol = np.linalg.cholesky(k + 1e-6 * np.eye(n)).astype(np.float32)
    jf = jchol @ rng.standard_normal(n).astype(np.float32)
    jy = rng.poisson(np.exp(jf)).astype(np.float32)
    for a, b in [(chol, jchol), (f_true, jf), (y, jy)]:
        np.testing.assert_array_equal(a, b)
    yj = jnp.asarray(jy)
    got, want = both(gp_latent.make_loglike(torch.as_tensor(y)),
                     lambda f: jnp.sum(yj * f - jnp.exp(f)), thetas(n),
                     dtype=torch.float32, grad=False)
    np.testing.assert_allclose(got, want, **F32)


def test_gp_hyperparams_model_data_and_oracle_equal_jax():
    jg = jax_example("gp_hyperparams")
    xs, f_true, y = gp_hyperparams.make_data()
    np.testing.assert_allclose(xs, np.asarray(jg.xs), rtol=1e-6)
    np.testing.assert_allclose(f_true, np.asarray(jg.F_TRUE), atol=0.02)
    np.testing.assert_allclose(y, np.asarray(jg.Y), atol=0.02)
    jy = np.asarray(jg.Y)
    # the oracle on the JAX program's own data
    (m_l, s_l), (m_a, s_a) = gp_hyperparams.exact_hyper_posterior(
        np.asarray(jg.xs), jy)
    (jm_l, js_l), (jm_a, js_a) = jg.exact_hyper_posterior()
    np.testing.assert_allclose([m_l, s_l, m_a, s_a],
                               [jm_l, js_l, jm_a, js_a], rtol=1e-12)
    # the latent's log-likelihood and the hyperprior in float64
    got, want, tg, jgr = both(
        gp_hyperparams.loglike_fn(torch.as_tensor(jy, dtype=torch.float64)),
        jg.loglike_f, thetas(gp_hyperparams.N, 1.0))
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(tg, jgr, **F64)
    got, want, tg, jgr = both(gp_hyperparams.hyper_logprior,
                              jg.hyper_logprior, thetas(2))
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(tg, jgr, **F64)
    # the factor L(θ) at well-conditioned hyperparameters: JAX's inputs are
    # float32 and its squared distances too, the port's float64 (the
    # hyperparameters' dtype), so float32's tolerance, on L Lᵀ (the
    # trailing columns of L amplify a Gram's rounding by its condition)
    k_chol = gp_hyperparams.chol_fn(torch.as_tensor(np.asarray(
        jg.xs), dtype=torch.float64))
    h = np.array([[-1.2, 0.3], [-0.9, -0.5], [-1.0, 1.0]])
    for hl, ha in h:
        got = k_chol(torch.tensor(hl, dtype=torch.float64),
                     torch.tensor(ha, dtype=torch.float64)).numpy()
        with jax.enable_x64(True):
            want = np.asarray(jg.k_chol(jnp.float64(hl), jnp.float64(ha)))
        np.testing.assert_allclose(got @ got.T, want @ want.T, **F32)


def test_gradient_inference_target_and_evidence():
    dim = 10
    cov, logp = gradient_inference.target(dim, "cpu", torch.float64)
    idx = np.arange(dim)
    np.testing.assert_array_equal(cov, 0.5 ** np.abs(idx[:, None]
                                                     - idx[None, :]))
    def jlogp(t):  # the JAX program's lines
        prec = jnp.asarray(np.linalg.inv(cov))
        return -0.5 * t @ (prec @ t)

    got, want, tg, jg = both(logp, jlogp, thetas(dim, 1.5))
    np.testing.assert_allclose(got, want, **F64)
    np.testing.assert_allclose(tg, jg, **F64)
    # log ∫ N(θ; 0, 9I) exp(−½ θᵀΛθ) dθ, the Gaussian integral written out
    lam = np.linalg.inv(cov)
    post = np.linalg.inv(lam + np.eye(dim) / 9.0)
    want = 0.5 * np.linalg.slogdet(post)[1] - 0.5 * dim * math.log(9.0)
    assert gradient_inference.exact_log_evidence(cov) == pytest.approx(
        want, rel=1e-12)
