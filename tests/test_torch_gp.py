"""The port's Gaussian-process layer (``mcmcpp_tpu_torch/models/gp.py``,
``models/hsgp.py``) against the JAX package's on the same seeded inputs.

- every kernel's cross covariance, Gram and diagonal, sums and products:
  float64, 1e-12 relative;
- ``gp_log_marginal`` and its gradient in lengthscale, variance and noise,
  ``gp_predict``: float64 against ``jax.grad``, 1e-10 relative;
- ``gram_cholesky``: the jitter level picked equals JAX's on grams that need
  escalation on the CPU (float32; JAX escalates while the factor has NaNs,
  the port reads ``cholesky_ex``'s info for every level at once), each
  factor reproduces the jittered Gram (2e-5 absolute), and on a
  well-conditioned Gram the factor's gradient equals JAX's (float64, 1e-9);
- HSGP: the basis, the spectral densities, ``__call__``, the approximate
  Gram, ``hsgp_log_marginal`` and its gradients, ``hsgp_predict``. JAX keeps
  the basis in float32 even under x64 and so does the port, so they are held
  to float32 tolerances: 1e-5 relative for the basis (sums in another
  order), 1e-4 for the marginal (whose float32 terms of ~1e3 cancel to ~20)
  and 1e-3 for its gradients;
- an HSGP regression written in the DSL: its logp and gradient equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu.models import gp as jgp
from mcmcpp_tpu.models import hsgp as jhs
from mcmcpp_tpu_torch.models import gp as tgp
from mcmcpp_tpu_torch.models import hsgp as ths

torch.set_num_threads(1)

_rng = np.random.default_rng(0)
XS = np.sort(_rng.uniform(-2, 2, 20))[:, None]
XN = np.linspace(-2.5, 2.5, 7)[:, None]
X2 = _rng.uniform(-1, 1, (15, 2))
YS = np.sin(2 * XS[:, 0]) + 0.1 * _rng.normal(size=20)


def _kernels(m):
    return {
        "rbf": m.RBF(0.7, 1.3),
        "matern12": m.Matern12(0.7, 1.3),
        "matern32": m.Matern32(0.7, 1.3),
        "matern52": m.Matern52(0.7, 1.3),
        "periodic": m.Periodic(1.5, 0.8, 1.1),
        "linear": m.Linear(0.5),
        "white": m.WhiteNoise(0.01),
        "sum": m.RBF(0.7, 1.3) + m.WhiteNoise(1e-3),
        "product": m.Periodic(1.5, 0.8, 1.1) * m.RBF(2.0, 1.0),
    }


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("name", sorted(_kernels(jgp)))
def test_kernels_match_jax(name):
    tk = _kernels(tgp)[name]
    with jax.enable_x64(True):
        jk = _kernels(jgp)[name]
        want = [np.asarray(jk(XS, XN)), np.asarray(jk.gram(XS)),
                np.asarray(jk.diag(XN)), np.asarray(jk(X2, X2[:4]))]
    got = [tk(_t(XS), _t(XN)), tk.gram(_t(XS)), tk.diag(_t(XN)),
           tk(_t(X2), _t(X2[:4]))]
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-14)


def _gp_marginal(m, lib):
    def f(ll, lv, ln):
        k = m.RBF(lib.exp(ll), lib.exp(lv)) + m.WhiteNoise(1e-4)
        return m.gp_log_marginal(k, XS, YS, lib.exp(ln))
    return f


def test_gp_log_marginal_and_gradients_match_jax():
    args = (np.log(0.6), np.log(1.2), np.log(0.15))
    with jax.enable_x64(True):
        want, dwant = jax.jit(jax.value_and_grad(_gp_marginal(jgp, jnp),
                                                 (0, 1, 2)))(*args)
        want, dwant = float(want), np.asarray(dwant)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = _gp_marginal(tgp, torch)(*ts)
    got.backward()
    assert abs(got.item() - want) <= 1e-10 * abs(want)
    np.testing.assert_allclose([float(t.grad) for t in ts], dwant,
                               rtol=1e-10)


def test_gp_predict_matches_jax():
    with jax.enable_x64(True):
        jm, jv = jgp.gp_predict(jgp.Matern52(0.6, 1.2), XS, YS, XN, 0.1)
    tm, tv = tgp.gp_predict(tgp.Matern52(0.6, 1.2), _t(XS), _t(YS), _t(XN),
                            0.1)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-14)


_GRID48 = np.linspace(0.0, 1.0, 48)[:, None].astype(np.float32)
# grams whose float32 Cholesky fails at the base jitter on the CPU (both
# packages pick the same escalation here; levels measured with each)
ESCALATING = {
    "grid48_l0.8_j1e-8": (_GRID48, 0.8, 1e-8, 2),
    "dup48_l0.8_j1e-8": (np.repeat(_GRID48[:24], 2, axis=0), 0.8, 1e-8, 2),
    "grid256_l0.3_j1e-6": (np.linspace(0, 1, 256)[:, None].astype(
        np.float32), 0.3, 1e-6, 1),
}


def _jax_level(xs, ell, jitter, max_tries=5):
    """The level JAX's while_loop stops at (the first factor without NaN)."""
    k = jgp.RBF(ell, 1.0).gram(xs)
    eye = jnp.eye(k.shape[0], dtype=k.dtype)
    has_nan = jax.jit(lambda j: jnp.isnan(jnp.linalg.cholesky(k + j * eye))
                      .any())
    for i in range(max_tries + 1):
        if not bool(has_nan(jitter * 10.0 ** i)):
            return i
    return max_tries


@pytest.mark.parametrize("case", sorted(ESCALATING))
def test_gram_cholesky_escalation_level_matches_jax(case):
    xs, ell, jitter, level = ESCALATING[case]
    assert _jax_level(xs, ell, jitter) == level
    k = tgp.RBF(ell, 1.0).gram(torch.as_tensor(xs))
    assert k.dtype == torch.float32
    assert int(tgp.jitter_level(k, jitter)) == level
    chol = tgp.gram_cholesky(tgp.RBF(ell, 1.0), torch.as_tensor(xs),
                             jitter=jitter)
    jchol = np.asarray(jgp.gram_cholesky(jgp.RBF(ell, 1.0), xs,
                                         jitter=jitter))
    # the trailing columns of a near-singular float32 factor are rounding
    # noise in either package: each factor is held to reproducing the
    # jittered Gram instead
    want = k.double().numpy() + jitter * 10.0 ** level * np.eye(len(xs))
    for f in (chol.double().numpy(), jchol.astype(np.float64)):
        assert np.isfinite(f).all()
        np.testing.assert_allclose(f @ f.T, want, rtol=0, atol=2e-5)


def test_gram_cholesky_factor_and_gradient_match_jax():
    """One differentiable factorization at the picked level: the factor and
    the gradient of a scalar probe equal JAX's (float64)."""
    w = np.random.default_rng(9).normal(size=(20, 20))

    def probe(m, lib):
        wl = lib.asarray(w) if lib is jnp else torch.as_tensor(w)

        def f(ll):
            return lib.sum(m.gram_cholesky(m.RBF(lib.exp(ll), 1.0), XS,
                                           jitter=1e-6) * wl)
        return f

    with jax.enable_x64(True):
        want = float(probe(jgp, jnp)(-0.2))
        dwant = float(jax.grad(probe(jgp, jnp))(-0.2))
    ll = torch.tensor(-0.2, dtype=torch.float64, requires_grad=True)
    got = probe(tgp, torch)(ll)
    got.backward()
    assert abs(got.item() - want) <= 1e-10 * abs(want)
    assert abs(float(ll.grad) - dwant) <= 1e-9 * abs(dwant)


def test_gram_cholesky_takes_no_host_sync_to_pick_the_level():
    """The level is a tensor (no .item()): the factorization under
    torch.func.vmap over hyperparameters works."""
    def f(ll):
        return tgp.gram_cholesky(tgp.RBF(torch.exp(ll), 1.0),
                                 torch.as_tensor(XS), jitter=1e-6).sum()

    out = torch.func.vmap(f)(torch.tensor([-0.5, 0.0, 0.3],
                                          dtype=torch.float64))
    assert torch.isfinite(out).all()


X1 = np.sort(_rng.uniform(-3, 3, 60))
Y1 = np.sin(X1) + 0.1 * _rng.normal(size=60)


@pytest.mark.parametrize("kernel", ["rbf", "matern12", "matern32",
                                    "matern52"])
def test_hsgp_basis_and_spectral_match_jax(kernel):
    jb = jhs.HSGP(X1, m=16, c=1.6, kernel=kernel)
    tb = ths.HSGP(X1, m=16, c=1.6, kernel=kernel, device="cpu")
    assert tb.phi.dtype == torch.float32 and tb.num_basis == 16
    np.testing.assert_allclose(tb.phi.numpy(), np.asarray(jb.phi),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.spectral(0.7, 1.3).numpy(),
                               np.asarray(jb.spectral(0.7, 1.3)), rtol=1e-5)
    beta = _rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(tb(0.7, 1.3, torch.as_tensor(beta)).numpy(),
                               np.asarray(jb(0.7, 1.3, beta)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tb.gram(0.7, 1.3).numpy(),
                               np.asarray(jb.gram(0.7, 1.3)), rtol=1e-4,
                               atol=1e-5)


def test_hsgp_ard_and_new_inputs_match_jax():
    jb = jhs.HSGP(X2, m=(5, 4), c=1.5, kernel="rbf")
    tb = ths.HSGP(X2, m=(5, 4), c=1.5, kernel="rbf", device="cpu")
    xq = _rng.uniform(-1, 1, (6, 2))
    np.testing.assert_allclose(tb.basis_at(xq).numpy(),
                               np.asarray(jb.basis_at(xq)), rtol=1e-5,
                               atol=1e-6)
    ell = np.array([0.5, 0.9], np.float32)
    np.testing.assert_allclose(tb.spectral(torch.as_tensor(ell)).numpy(),
                               np.asarray(jb.spectral(ell)), rtol=1e-5)


def test_hsgp_log_marginal_gradients_and_predict_match_jax():
    y = Y1.astype(np.float32)
    jb = jhs.HSGP(X1, m=24, c=1.6, kernel="matern52")
    tb = ths.HSGP(X1, m=24, c=1.6, kernel="matern52", device="cpu")

    def jf(ll, lv, ln):
        return jhs.hsgp_log_marginal(jb, jnp.exp(ll), jnp.exp(lv), y,
                                     jnp.exp(ln))

    args = (np.float32(np.log(0.8)), np.float32(0.1), np.float32(-2.0))
    want, dwant = jax.jit(jax.value_and_grad(jf, (0, 1, 2)))(*args)
    want, dwant = float(want), np.asarray(dwant)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = ths.hsgp_log_marginal(tb, torch.exp(ts[0]), torch.exp(ts[1]),
                                torch.as_tensor(y), torch.exp(ts[2]))
    got.backward()
    # float32 terms of ~1e3 (the quadratic form over σ_n²) cancel to ~20
    assert abs(got.item() - want) <= 1e-4 * abs(want)
    np.testing.assert_allclose([float(t.grad) for t in ts], dwant,
                               rtol=1e-3, atol=1e-3)
    jm, jv = jhs.hsgp_predict(jb, 0.8, 1.1, y, 0.1, XN[:, 0])
    tm, tv = ths.hsgp_predict(tb, 0.8, 1.1, torch.as_tensor(y), 0.1,
                              XN[:, 0])
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-3,
                               atol=1e-6)


def test_hsgp_approaches_the_exact_gp():
    """The oracle of the JAX tests: with m large the reduced-rank marginal
    likelihood approaches the exact one (float64 basis here)."""
    tb = ths.HSGP(X1, m=64, c=2.0, kernel="rbf", dtype=torch.float64,
                  device="cpu")
    exact = tgp.gp_log_marginal(tgp.RBF(1.0, 1.0), torch.as_tensor(X1),
                                torch.as_tensor(Y1), 0.1)
    approx = ths.hsgp_log_marginal(tb, 1.0, 1.0, torch.as_tensor(Y1), 0.1)
    assert abs(float(approx) - float(exact)) < 1e-3 * abs(float(exact))


def test_hsgp_regression_in_the_dsl_matches_jax():
    """The HSGP docstring's DSL model (a float32 basis under float64 θ, as
    JAX promotes): logp and gradient equal JAX's."""
    from mcmcpp_tpu import dsl as J
    from mcmcpp_tpu_torch import dsl as T

    def model(m, basis):
        return (m.Model()
                .param("ell", m.LogNormal(0.0, 0.5))
                .param("sigma", m.HalfNormal(1.0))
                .param("beta", m.Normal(0.0, 1.0), shape=(basis.num_basis,))
                .deterministic("f", lambda p: basis(p["ell"], p["sigma"],
                                                    p["beta"]))
                .observe("y", lambda p: m.Normal(p["f"], 0.2), Y1))

    tl, dim, _ = model(T, ths.HSGP(X1, m=12, device="cpu")).build()
    th = _rng.normal(size=(3, dim)) * 0.5
    with jax.enable_x64(True):
        jl, _, _ = model(J, jhs.HSGP(X1, m=12)).build()
        want, dwant = (np.asarray(v) for v in jax.jit(jax.vmap(
            jax.value_and_grad(jl)))(th))
    q = torch.tensor(th, requires_grad=True)
    got = torch.func.vmap(tl)(q)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(q.grad.numpy(), dwant, rtol=1e-5,
                               atol=1e-5 * np.abs(dwant).max())


def test_hsgp_on_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        ths.HSGP(X1, m=8)
