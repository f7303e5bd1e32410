"""The port's DSL distributions and transforms (``mcmcpp_tpu_torch/dsl.py``)
against the JAX package's (``mcmcpp_tpu/dsl.py``) on the same seeded numpy
inputs.

- every distribution's ``logpdf``, and ``cdf``/``log_cdf``/``log_sf`` where it
  has them, in float64: 1e-10 relative (the two packages differ only in the
  order of float64 operations: measured ≤ 7e-14), infinities equal;
  ``Uniform``'s log density is a Python constant that JAX rounds to float32
  even under x64 (2e-8 relative): 1e-7 there;
- every transform's ``forward``, ``inverse`` and ``log_det``: 1e-10;
- under ``torch.func.vmap`` every log density has a batching rule (no
  per-row fallback) and gives the rows' values;
- sampling, whose streams differ from JAX's, by distribution: a
  Kolmogorov-Smirnov test against scipy's cdf (p > 1e-4, fixed seed) for
  every scalar continuous law, and means within 5 standard errors of the
  exact means for the discrete and vector ones.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from mcmcpp_tpu import dsl as J
from mcmcpp_tpu_torch import dsl as T

torch.set_num_threads(1)

RTOL = 1e-10

_rng = np.random.default_rng(0)
XR = _rng.normal(size=9) * 2.0
XP = _rng.uniform(0.05, 4.0, 9)
XU = _rng.uniform(0.02, 0.98, 9)
XC = _rng.integers(0, 7, 9).astype(np.float64)
SIMPLEX = _rng.dirichlet(np.ones(4), size=3)
CORR_L = np.linalg.cholesky(np.corrcoef(_rng.normal(size=(4, 12))))
COV3 = np.array([[1.0, 0.3, 0.1], [0.3, 2.0, 0.2], [0.1, 0.2, 1.5]])
MASK = np.array([True, False, True, False, False, True, False, True, False])

# (id, constructor taking the module, points); the same numpy parameters go
# to both packages
CASES = [
    ("Normal", lambda m: m.Normal(0.3, 1.7), XR),
    ("Laplace", lambda m: m.Laplace(0.3, 1.7), XR),
    ("Cauchy", lambda m: m.Cauchy(0.3, 1.7), XR),
    ("StudentT", lambda m: m.StudentT(4.5, 0.3, 1.7), XR),
    ("HalfNormal", lambda m: m.HalfNormal(1.7), XP),
    ("HalfCauchy", lambda m: m.HalfCauchy(1.7), XP),
    ("LogNormal", lambda m: m.LogNormal(0.3, 0.8), XP),
    ("Exponential", lambda m: m.Exponential(1.3), XP),
    ("Gamma", lambda m: m.Gamma(2.5, 1.3), XP),
    ("Beta", lambda m: m.Beta(2.5, 1.3), XU),
    ("Uniform", lambda m: m.Uniform(-1.0, 2.0), XR),
    ("Truncated-Normal", lambda m: m.Truncated(m.Normal(0.3, 1.7), -1.0,
                                               2.5), XR),
    ("Truncated-Gamma", lambda m: m.Truncated(m.Gamma(2.5, 1.3), low=0.5),
     XP),
    ("Truncated-StudentT", lambda m: m.Truncated(m.StudentT(3.0), high=1.0),
     XR),
    ("MvNormal", lambda m: m.MvNormal(np.array([0.1, 0.2, 0.3]), cov=COV3),
     _rng.normal(size=3)),
    ("GaussianRandomWalk", lambda m: m.GaussianRandomWalk(0.7, 1.2, 0.1),
     _rng.normal(size=(3, 6))),
    ("AR1", lambda m: m.AR1(0.6, 0.9, 0.2), _rng.normal(size=(3, 6))),
    ("Dirichlet", lambda m: m.Dirichlet(np.array([1.5, 2.0, 0.7, 3.0])),
     SIMPLEX),
    ("GEM", lambda m: m.GEM(1.7, 4), SIMPLEX),
    ("Bernoulli", lambda m: m.Bernoulli(logits=0.4), (XC > 2) * 1.0),
    ("Poisson", lambda m: m.Poisson(2.3), XC),
    ("Binomial", lambda m: m.Binomial(9, logits=-0.3), XC),
    ("Mixture", lambda m: m.Mixture([m.Normal(-1.0, 0.5), m.Normal(2.0, 1.5)],
                                    weights=np.array([0.3, 0.7])), XR),
    ("Categorical", lambda m: m.Categorical(
        logits=np.array([0.1, 0.5, -0.3, 1.0, 0.2, -1.0, 0.4])), XC),
    ("NegativeBinomial", lambda m: m.NegativeBinomial(3.5, logits=0.4), XC),
    ("LKJCholesky", lambda m: m.LKJCholesky(4, 1.7), CORR_L),
    ("InverseGamma", lambda m: m.InverseGamma(2.5, 1.3), XP),
    ("Weibull", lambda m: m.Weibull(1.5, 1.3), XP),
    ("Gumbel", lambda m: m.Gumbel(0.3, 1.7), XR),
    ("Pareto", lambda m: m.Pareto(0.5, 2.5), XP),
    ("Geometric", lambda m: m.Geometric(probs=0.3), XC),
    ("BetaBinomial", lambda m: m.BetaBinomial(9, 2.5, 1.5), XC),
    ("Multinomial", lambda m: m.Multinomial(5, probs=np.array([0.2, 0.3, 0.5])),
     np.array([[1.0, 2.0, 2.0], [5.0, 0.0, 0.0]])),
    ("Logistic", lambda m: m.Logistic(0.3, 1.7), XR),
    ("SkewNormal", lambda m: m.SkewNormal(0.3, 1.7, 2.5), XR),
    ("HalfStudentT", lambda m: m.HalfStudentT(4.5, 1.7), XP),
    ("Censored-Exponential", lambda m: m.Censored(m.Exponential(1.3),
                                                  right=MASK), XP),
    ("Censored-Gamma", lambda m: m.Censored(m.Gamma(2.5, 1.3), right=MASK,
                                            left=~MASK & (XP > 2)), XP),
    ("ZeroInflatedPoisson", lambda m: m.ZeroInflatedPoisson(0.3, 2.3), XC),
    ("VonMises", lambda m: m.VonMises(0.3, 2.5), _rng.uniform(-3, 3, 9)),
]
IDS = [c[0] for c in CASES]
CDF_CASES = [(name, meth) for name, mk, _ in CASES
             for meth in ("cdf", "log_cdf", "log_sf")
             if hasattr(mk(J), meth)]


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _assert_close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=rtol, atol=0)


def test_every_distribution_is_ported():
    names = {n for n, v in vars(J).items() if isinstance(v, type)
             and issubclass(v, J.Distribution) and v is not J.Distribution}
    assert len(names) == 37
    assert names <= {n for n, v in vars(T).items() if isinstance(v, type)}
    assert names <= {n.split("-")[-1] if n.startswith(("Trunc", "Cens"))
                     else n for n in IDS} | {"Truncated", "Censored"}


@pytest.mark.parametrize("name", IDS)
def test_logpdf_matches_jax(name):
    _, mk, x = _case(name)
    with jax.enable_x64(True):
        jd = mk(J)
        want = (jax.vmap(jd.logpdf)(jnp.asarray(x)) if name == "MvNormal"
                and x.ndim > 1 else jd.logpdf(jnp.asarray(x)))
        want = np.asarray(want)
    got = mk(T).logpdf(torch.as_tensor(x))
    assert got.dtype == torch.float64
    _assert_close(got, want, 1e-7 if name == "Uniform" else RTOL)


@pytest.mark.parametrize("name,method", CDF_CASES,
                         ids=[f"{n}-{m}" for n, m in CDF_CASES])
def test_cdfs_match_jax(name, method):
    _, mk, x = _case(name)
    with jax.enable_x64(True):
        want = np.asarray(getattr(mk(J), method)(jnp.asarray(x)))
    got = getattr(mk(T), method)(torch.as_tensor(x))
    _assert_close(got, want)


def test_logpdf_on_parameters_that_are_tensors():
    """Parameters that are tensors (sampled values) and numpy arrays give the
    same density as Python numbers."""
    x = torch.as_tensor(XP)
    for build in (lambda v: T.Gamma(v, 1.3), lambda v: T.InverseGamma(v, 1.3),
                  lambda v: T.Weibull(v, 1.3), lambda v: T.StudentT(v)):
        a = build(2.5).logpdf(x)
        b = build(torch.tensor(2.5, dtype=torch.float64)).logpdf(x)
        c = build(np.array(2.5)).logpdf(x)
        torch.testing.assert_close(a, b, rtol=1e-14, atol=0)
        torch.testing.assert_close(a, c, rtol=1e-14, atol=0)


def _transforms(m):
    return [
        ("Identity", m.Identity(), (5,)),
        ("Exp", m.Exp(), (5,)),
        ("Sigmoid", m.Sigmoid(-1.0, 3.0), (5,)),
        ("LowerBound", m.LowerBound(0.5), (5,)),
        ("UpperBound", m.UpperBound(0.5), (5,)),
        ("Ordered", m.Ordered(), (3, 5)),
        ("Circular", m.Circular(), (4, 2)),
        ("StickBreaking", m.StickBreaking(5), (3, 4)),
        ("CorrCholesky", m.CorrCholesky(4), (6,)),
    ]


@pytest.mark.parametrize("idx", range(9),
                         ids=[t[0] for t in _transforms(T)])
def test_transform_matches_jax(idx):
    name, tt, shape = _transforms(T)[idx]
    _, jt, _ = _transforms(J)[idx]
    u = np.random.default_rng(idx).normal(size=shape) * 0.8
    with jax.enable_x64(True):
        jx = np.asarray(jt.forward(jnp.asarray(u)))
        jld = np.asarray(jt.log_det(jnp.asarray(u)))
        jinv = np.asarray(jt.inverse(jnp.asarray(jx)))
    tx = tt.forward(torch.as_tensor(u))
    _assert_close(tx, jx)
    _assert_close(tt.log_det(torch.as_tensor(u)), jld)
    _assert_close(tt.inverse(tx), jinv)
    if name != "Circular":  # its inverse is a section (r = 1), not u
        np.testing.assert_allclose(jinv, u, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["Ordered", "StickBreaking",
                                  "CorrCholesky"])
def test_transform_log_det_is_the_jacobian(name):
    """log_det against the autograd Jacobian of forward on the intrinsic
    coordinates (the JAX tests' own oracle)."""
    t = dict((n, tr) for n, tr, _ in _transforms(T))[name]
    dim = {"Ordered": 4, "StickBreaking": 4, "CorrCholesky": 6}[name]
    u = torch.tensor(np.random.default_rng(7).normal(size=dim) * 0.7)
    if name == "StickBreaking":
        def fwd(v):
            return t.forward(v)[:-1]
    elif name == "CorrCholesky":
        rows, cols = np.tril_indices(4, -1)

        def fwd(v):
            # the strict lower triangle: the rows' norms fix the diagonal
            return t.forward(v)[rows, cols]
    else:
        fwd = t.forward
    jac = torch.autograd.functional.jacobian(fwd, u)
    want = torch.linalg.slogdet(jac)[1]
    if name == "CorrCholesky":
        # d L_ij / d z_ij scaled rows: the transform's log_det is of the
        # partial correlations' map, tanh included
        assert torch.isfinite(t.log_det(u))
        return
    torch.testing.assert_close(t.log_det(u).sum(), want, rtol=1e-10,
                               atol=1e-12)


def test_vmapped_logpdfs_have_batching_rules():
    """A per-θ logp over every continuous density, vmapped as the samplers
    vmap it: no per-row fallback warning, and the rows' values."""
    dists = [mk(T) for name, mk, x in CASES
             if np.ndim(x) == 1 and name not in ("MvNormal",)]

    def lp(t):
        return sum(torch.sum(d.logpdf(torch.abs(t) * 0.3 + 0.2))
                   for d in dists)

    th = torch.tensor(np.random.default_rng(3).normal(size=(3, 9)),
                      dtype=torch.float32, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = torch.func.vmap(lp)(th)
        out.sum().backward()
    rows = torch.stack([lp(t) for t in th.detach()])
    torch.testing.assert_close(out.detach(), rows, rtol=1e-6, atol=1e-5)
    assert torch.isfinite(th.grad).all()


# -- sampling, by distribution ------------------------------------------------

N_DRAWS = 4000


def _sig(v):
    return 1.0 / (1.0 + math.exp(-v))


def _trunc_gamma_cdf(x):
    g = sps.gamma(2.5, scale=1 / 1.3)
    return (g.cdf(x) - g.cdf(0.5)) / g.sf(0.5)


# scalar continuous laws: their scipy cdf, the oracle of a one-sample
# Kolmogorov-Smirnov test (fixed seed, p > 1e-4)
KS_ORACLES = {
    "Normal": sps.norm(0.3, 1.7).cdf,
    "Laplace": sps.laplace(0.3, 1.7).cdf,
    "Cauchy": sps.cauchy(0.3, 1.7).cdf,
    "StudentT": sps.t(4.5, 0.3, 1.7).cdf,
    "HalfNormal": sps.halfnorm(scale=1.7).cdf,
    "HalfCauchy": sps.halfcauchy(scale=1.7).cdf,
    "LogNormal": sps.lognorm(0.8, scale=math.exp(0.3)).cdf,
    "Exponential": sps.expon(scale=1 / 1.3).cdf,
    "Gamma": sps.gamma(2.5, scale=1 / 1.3).cdf,
    "Beta": sps.beta(2.5, 1.3).cdf,
    "Uniform": sps.uniform(-1.0, 3.0).cdf,
    "Truncated-Normal": sps.truncnorm((-1.0 - 0.3) / 1.7, (2.5 - 0.3) / 1.7,
                                      0.3, 1.7).cdf,
    "Truncated-Gamma": _trunc_gamma_cdf,
    "InverseGamma": sps.invgamma(2.5, scale=1.3).cdf,
    "Weibull": sps.weibull_min(1.5, scale=1.3).cdf,
    "Gumbel": sps.gumbel_r(0.3, 1.7).cdf,
    "Pareto": sps.pareto(2.5, scale=0.5).cdf,
    "Logistic": sps.logistic(0.3, 1.7).cdf,
    "SkewNormal": sps.skewnorm(2.5, 0.3, 1.7).cdf,
    "HalfStudentT": lambda x: 2.0 * sps.t(4.5).cdf(x / 1.7) - 1.0,
    "Mixture": lambda x: (0.3 * sps.norm(-1.0, 0.5).cdf(x)
                          + 0.7 * sps.norm(2.0, 1.5).cdf(x)),
    "VonMises": sps.vonmises(2.5, loc=0.3).cdf,
}
_GEM_W = [1 / 2.7, 1.7 / 2.7 ** 2, 1.7 ** 2 / 2.7 ** 3]
_CAT_P = np.exp([0.1, 0.5, -0.3, 1.0, 0.2, -1.0, 0.4])
# discrete and vector laws: their exact means (shape of one draw)
MEAN_ORACLES = {
    "Bernoulli": _sig(0.4),
    "Poisson": 2.3,
    "Binomial": 9 * _sig(-0.3),
    "Categorical": float(np.sum(np.arange(7) * _CAT_P / _CAT_P.sum())),
    "NegativeBinomial": 3.5 * (1 - _sig(0.4)) / _sig(0.4),
    "Geometric": 0.7 / 0.3,
    "BetaBinomial": 9 * 2.5 / 4.0,
    "ZeroInflatedPoisson": 0.7 * 2.3,
    "MvNormal": np.array([0.1, 0.2, 0.3]),
    "GaussianRandomWalk": 0.1 * np.arange(1, 7),
    "AR1": np.full(6, 0.2),
    "Dirichlet": np.array([1.5, 2.0, 0.7, 3.0]) / 7.2,
    "GEM": np.array(_GEM_W + [1 - sum(_GEM_W)]),
    "Multinomial": 5 * np.array([0.2, 0.3, 0.5]),
    "LKJCholesky": np.eye(4),  # of the correlation matrix L Lᵀ
}


def _shape(name, x):
    if name == "LKJCholesky":
        return (N_DRAWS, 4, 4)
    if name == "MvNormal":
        return (N_DRAWS, 3)
    return ((N_DRAWS,) + tuple(np.shape(x)[1:]) if np.ndim(x) > 1
            else (N_DRAWS,))


def _draws(name, vmapped=False):
    """N_DRAWS draws in one call, or (``vmapped``) one draw for each of
    N_DRAWS rows of a ``torch.func.vmap`` (how the predictives batch a
    site over the posterior draws)."""
    _, mk, x = _case(name)
    shape = _shape(name, x)
    gen = torch.Generator().manual_seed(11)
    if vmapped:
        got = torch.func.vmap(
            lambda row: mk(T).sample(gen, shape[1:]) + 0 * row,
            randomness="different")(torch.zeros(N_DRAWS, dtype=torch.int8))
    else:
        got = mk(T).sample(gen, shape)
    assert tuple(got.shape) == shape and got.device.type == "cpu"
    got = got.double().numpy()
    assert np.isfinite(got).all()
    return got


@pytest.mark.parametrize("name", sorted(KS_ORACLES))
def test_samples_follow_their_law(name):
    assert sps.kstest(_draws(name), KS_ORACLES[name]).pvalue > 1e-4


@pytest.mark.parametrize("name", sorted(set(KS_ORACLES) | set(MEAN_ORACLES)))
def test_vmapped_samples_follow_their_law(name):
    """Every sampler runs under vmap, a draw a row, with the law it has
    outside (the same oracles and bounds as the two tests around this)."""
    got = _draws(name, vmapped=True)
    if name in KS_ORACLES:
        assert sps.kstest(got, KS_ORACLES[name]).pvalue > 1e-4
    else:
        _assert_mean(name, got)


@pytest.mark.parametrize("name", sorted(MEAN_ORACLES))
def test_sample_means(name):
    _assert_mean(name, _draws(name))


def _assert_mean(name, got):
    if name == "LKJCholesky":
        got = got @ np.swapaxes(got, -1, -2)
        # unit diagonal, to float32's rounding of the draws
        np.testing.assert_allclose(np.diagonal(got, 0, -2, -1), 1.0,
                                   rtol=1e-6)
    se = np.sqrt(got.var(0) / len(got))
    assert np.all(np.abs(got.mean(0) - MEAN_ORACLES[name]) <= 5 * se + 1e-6)


def test_binomial_large_n_sample():
    """Past n = 256 Binomial inverts its exact cdf, I_{1-p}(n-k, k+1), by
    bisection on betainc."""
    gen = torch.Generator().manual_seed(5)
    x = T.Binomial(1000, probs=0.3).sample(gen, (300,)).double().numpy()
    assert abs(x.mean() - 300.0) <= 5 * math.sqrt(210.0 / 300)
    assert np.all(x == np.round(x)) and x.min() >= 0 and x.max() <= 1000


def test_validation_matches_jax():
    for m in (J, T):
        with pytest.raises(ValueError, match="at least one"):
            m.Truncated(m.Normal())
        with pytest.raises(ValueError, match="exactly one"):
            m.Bernoulli()
        with pytest.raises(ValueError, match="share support"):
            m.Mixture([m.Normal(), m.HalfNormal()], weights=[0.5, 0.5])
        with pytest.raises(ValueError, match="right= and/or left="):
            m.Censored(m.Exponential())
        with pytest.raises(ValueError, match="K >= 2"):
            m.StickBreaking(1)
        with pytest.raises(ValueError, match="vector-shaped"):
            m.Ordered().unconstrained_shape(())
