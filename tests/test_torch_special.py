"""The port's special functions (``mcmcpp_tpu_torch/ops/special.py``) against
``jax.scipy.special`` on the same seeded inputs.

Tolerances: float64 values and gradients to 1e-10 relative (the port runs
JAX's own series and continued fractions; what differs is the order of a
few float64 operations, measured at ≤ 4e-13); float32 values to 2e-5
relative (float32 arithmetic in another order), the float32 incomplete gamma
to 3e-4 of the float64 value (see its test). The betainc gradient in a or b
raises, as in JAX.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from mcmcpp_tpu_torch.ops import special

torch.set_num_threads(1)

RTOL64 = 1e-10
RTOL32 = 2e-5


def _rel(got, want, floor=1e-300):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), floor)))


@pytest.fixture(scope="module")
def beta_inputs():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(0.05, 3.0, 60), rng.uniform(3, 200, 60)])
    b = np.concatenate([rng.uniform(0.05, 3.0, 60), rng.uniform(3, 200, 60)])
    rng.shuffle(b)
    x = rng.uniform(0.0, 1.0, 120)
    x[:4] = [0.0, 1.0, 1e-12, 1 - 1e-12]
    return a, b, x


@pytest.fixture(scope="module")
def gamma_inputs():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(0.05, 2.0, 50), rng.uniform(2, 300, 50)])
    x = np.concatenate([rng.uniform(1e-3, 3.0, 50), rng.uniform(1, 400, 50)])
    rng.shuffle(x)
    return a, x


def test_betainc_values_float64(beta_inputs):
    a, b, x = beta_inputs
    with jax.enable_x64(True):
        want = np.asarray(jax.scipy.special.betainc(a, b, x))
    got = special.betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x))
    assert got.dtype == torch.float64
    assert _rel(got, want) <= RTOL64


def test_betainc_values_float32(beta_inputs):
    a, b, x = (v.astype(np.float32) for v in beta_inputs)
    want = np.asarray(jax.scipy.special.betainc(a, b, x))
    got = special.betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL32, atol=1e-6)


def test_betainc_domain_edges():
    a = torch.tensor([0.0, 2.0, 2.0, -1.0, 2.0, float("nan")],
                     dtype=torch.float64)
    b = torch.tensor([2.0, 0.0, 3.0, 2.0, 3.0, 1.0], dtype=torch.float64)
    x = torch.tensor([0.5, 0.5, 1.5, 0.5, 0.0, 0.5], dtype=torch.float64)
    with jax.enable_x64(True):
        want = np.asarray(jax.scipy.special.betainc(a.numpy(), b.numpy(),
                                                    x.numpy()))
    np.testing.assert_array_equal(special.betainc(a, b, x).numpy(), want)


def test_betainc_gradient_in_x(beta_inputs):
    a, b, x = (v[4:] for v in beta_inputs)
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(jax.grad(jax.scipy.special.betainc, 2))(
            a, b, x))
    xt = torch.tensor(x, requires_grad=True)
    special.betainc(torch.tensor(a), torch.tensor(b), xt).sum().backward()
    assert _rel(xt.grad, want) <= RTOL64


@pytest.mark.parametrize("arg", [0, 1])
def test_betainc_gradient_in_a_or_b_raises(arg):
    """JAX raises "Betainc gradient with respect to a and b not
    supported"; the port raises too and never returns zeros."""
    args = [torch.tensor(2.0, dtype=torch.float64),
            torch.tensor(3.0, dtype=torch.float64),
            torch.tensor(0.4, dtype=torch.float64)]
    args[arg].requires_grad_(True)
    with jax.enable_x64(True), pytest.raises(Exception, match="not supported"):
        jax.grad(jax.scipy.special.betainc, arg)(2.0, 3.0, 0.4)
    with pytest.raises(TypeError, match="not supported"):
        special.betainc(*args).backward()


@pytest.mark.parametrize("name", ["gammainc", "gammaincc"])
def test_incomplete_gamma_values_float64(gamma_inputs, name):
    """torch.special.gammainc is off by up to 2e-9 relative in float64 at a
    ≳ 20; the port's float64 path runs JAX's series and fraction."""
    a, x = gamma_inputs
    with jax.enable_x64(True):
        want = np.asarray(getattr(jax.scipy.special, name)(a, x))
    got = getattr(special, name)(torch.tensor(a), torch.tensor(x))
    assert _rel(got, want) <= RTOL64


@pytest.mark.parametrize("name", ["gammainc", "gammaincc"])
def test_incomplete_gamma_values_float32(gamma_inputs, name):
    """float32 at a up to 300 loses digits in a·log x − x − lgamma a: JAX is
    1.4e-4 and the port 8.4e-5 from scipy's float64 value at the same
    float32 inputs, so each is held to 3e-4 of that value (and so of each
    other)."""
    import scipy.special as ss

    a, x = (v.astype(np.float32) for v in gamma_inputs)
    truth = getattr(ss, name)(a.astype(np.float64), x.astype(np.float64))
    want = np.asarray(getattr(jax.scipy.special, name)(a, x))
    got = getattr(special, name)(torch.tensor(a), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, truth, rtol=3e-4, atol=1e-7)
    np.testing.assert_allclose(want, truth, rtol=3e-4, atol=1e-7)


@pytest.mark.parametrize("name", ["gammainc", "gammaincc"])
@pytest.mark.parametrize("arg", [0, 1])
def test_incomplete_gamma_gradients(gamma_inputs, name, arg):
    """The gradient in a (which torch's backward refuses) and in x, against
    jax.grad."""
    a, x = gamma_inputs
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(jax.grad(
            getattr(jax.scipy.special, name), arg))(a, x))
    at, xt = (torch.tensor(a, requires_grad=arg == 0),
              torch.tensor(x, requires_grad=arg == 1))
    getattr(special, name)(at, xt).sum().backward()
    assert _rel((at, xt)[arg].grad, want) <= 1e-9


def test_gammainc_a_gradient_known_value():
    """jax.grad of gammainc(a, 0.7) at a = 2 is -0.21234 (the value quoted
    where the port was specified)."""
    with jax.enable_x64(True):
        want = float(jax.grad(jax.scipy.special.gammainc)(2.0, 0.7))
    a = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    special.gammainc(a, 0.7).backward()
    assert abs(want - (-0.21234)) < 1e-5
    assert abs(float(a.grad) - want) <= 1e-12 * abs(want)
    with pytest.raises(RuntimeError, match="not implemented"):
        b = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
        torch.special.gammainc(b, torch.tensor(0.7, dtype=torch.float64)
                               ).backward()


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 2e-5)])
def test_log_ndtr_values_and_gradient(dtype, rtol):
    """JAX's switch points (asymptotic series, log Φ, −Φ(−x)) and its custom
    derivative φ/Φ. Between 5 and 8 (float64) log Φ is log(1 − ε) of a tiny
    ε in both packages, exact only to an ulp of 1: the values there are
    held absolutely, to one such ulp."""
    x = np.linspace(-60.0, 40.0, 2001).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want, dwant = (np.asarray(v) for v in jax.jit(jax.vmap(
            jax.value_and_grad(jax.scipy.special.log_ndtr)))(x))
    xt = torch.tensor(x, requires_grad=True)
    got = special.log_ndtr(xt)
    got.sum().backward()
    # (φ/Φ beyond x ≈ 37.6 is subnormal: JAX flushes it to zero)
    floor = 1e-290 if dtype == np.float64 else 1e-30
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=np.finfo(dtype).eps)
    assert _rel(xt.grad, dwant, floor) <= (1e-12 if dtype == np.float64
                                           else 2e-4)


def test_functions_vmap_and_differentiate_without_fallback():
    """Under torch.func.vmap (how the samplers batch a per-θ logp) every
    function has a batching rule (no per-row fallback warning), and the
    gradient through vmap equals the per-row one."""

    def f(th):
        return (special.betainc(2.0, 3.0, torch.sigmoid(th[1]))
                + special.gammainc(torch.exp(th[0]), torch.exp(th[1]))
                + special.gammaincc(torch.exp(th[1]), 0.5)
                + special.log_ndtr(th[0] - th[1]))

    th = torch.tensor(np.random.default_rng(2).normal(size=(4, 2)),
                      dtype=torch.float32, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = torch.func.vmap(f)(th)
        out.sum().backward()
        per_grad = torch.func.vmap(torch.func.grad(f))(th.detach())
    torch.testing.assert_close(th.grad, per_grad, rtol=1e-6, atol=0)
    for i in range(2):  # the first rows, one at a time outside vmap
        q = th.detach()[i].clone().requires_grad_(True)
        v = f(q)
        v.backward()
        torch.testing.assert_close(v.detach(), out.detach()[i], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(q.grad, th.grad[i], rtol=1e-5, atol=1e-7)


def test_loops_under_vmap_run_on_the_whole_batch_and_stop_early(
        monkeypatch, gamma_inputs):
    """The incomplete beta's and gammas' vmap rule applies them once to the
    physical batch, so their term loops see plain tensors and stop when the
    whole batch has converged (well short of the fixed counts), with the
    same bits as the per-row calls (float64, exact)."""
    terms = []
    all_done = special._all_done

    def spy(live, term):
        done = all_done(live, term)
        if done:
            terms.append(term)
        return done

    monkeypatch.setattr(special, "_all_done", spy)
    a, x = (torch.as_tensor(v[:50]) for v in gamma_inputs)  # a ≤ 2

    def f(ai, xi):
        return (special.gammainc(ai, xi) + special.gammaincc(ai, xi)
                + special.betainc(ai, 2.0, torch.sigmoid(xi - 2.0)))

    out = torch.func.vmap(f)(a, x)
    assert len(terms) == 5  # both branches of each gamma, and betainc
    assert max(terms) < min(special.BETAINC_TERMS[torch.float64],
                            special.IGAMMA_CF_TERMS[torch.float64])
    rows = torch.stack([f(a[i], x[i]) for i in range(len(a))])
    assert torch.isfinite(out).all() and torch.equal(out, rows)
    aa = a.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(
        torch.func.vmap(lambda ai, xi: special.gammaincc(ai, xi))(aa, x).sum(),
        aa)
    g_rows = torch.stack([torch.func.grad(special.gammaincc)(a[i], x[i])
                          for i in range(len(a))])
    assert torch.equal(g, g_rows)
