"""The port's targets against the JAX package's ``mcmcpp_tpu.models``.

Each target's logp is held against the JAX ``Target.logp`` on the same
numpy inputs, batched ((n, P) -> (n,), against ``jax.vmap``) and unbatched
((P,) -> scalar), with equal truth attributes; the regression targets make
the same data from the same seed, and ``convert.target_from_numpy`` rebuilds
each target from a JAX ``Target``'s fields.

Tolerance: rtol 1e-5 with an atol of 1e-5·max|logp| — float32 sums of up to
300 terms (the regression likelihoods) in another order, and the funnel's
−½Σx²·e^{−v} − ½(P−1)v, whose terms cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import models as jm
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.convert import target_from_numpy

torch.set_num_threads(1)

MAKERS = {
    "rosenbrock": (lambda: jm.rosenbrock(1.0, 5.0, 4.0),
                   lambda: mt.rosenbrock(1.0, 5.0, 4.0)),
    "rosenbrock_default": (jm.rosenbrock, mt.rosenbrock),
    "gaussian_mixture": (
        lambda: jm.gaussian_mixture([[-3.0, 0.0, 1.0], [3.0, 0.5, -1.0]],
                                    weights=[0.3, 0.7], scales=[1.0, 2.0]),
        lambda: mt.gaussian_mixture([[-3.0, 0.0, 1.0], [3.0, 0.5, -1.0]],
                                    weights=[0.3, 0.7], scales=[1.0, 2.0],
                                    device="cpu")),
    "neal_funnel": (lambda: jm.neal_funnel(10), lambda: mt.neal_funnel(10)),
    "bayesian_linear_regression": (
        lambda: jm.bayesian_linear_regression(n_data=150, dim=4, seed=1),
        lambda: mt.bayesian_linear_regression(n_data=150, dim=4, seed=1,
                                              device="cpu")),
    "logistic_regression": (
        lambda: jm.logistic_regression(seed=4),
        lambda: mt.logistic_regression(seed=4, device="cpu")),
}


def _points(dim, n=64, seed=0):
    return (1.5 * np.random.default_rng(seed).normal(size=(n, dim))).astype(
        np.float32)


def _close(got, want):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def _same_truth(t, j):
    assert t.name == j.name and t.dim == j.dim
    for attr in ("mean", "cov"):
        a, b = getattr(t, attr), getattr(j, attr)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert set(t.extras) == set(j.extras)
    for k, v in j.extras.items():
        np.testing.assert_array_equal(np.asarray(t.extras[k]), np.asarray(v))


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_logp_matches_jax(name):
    jt, tt = (make() for make in MAKERS[name])
    _same_truth(tt, jt)
    x = _points(jt.dim)
    want = np.asarray(jax.vmap(jt.logp)(jnp.asarray(x)))
    got = tt(torch.from_numpy(x))
    assert got.shape == (x.shape[0],) and got.dtype == torch.float32
    _close(got.numpy(), want)
    # unbatched: (P,) -> a scalar
    one = tt(torch.from_numpy(x[3]))
    assert one.shape == ()
    _close(np.array([float(one)]), np.array([float(jt.logp(x[3]))]))
    assert np.all(np.isfinite(want))


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_target_from_numpy_rebuilds_jax_target(name):
    """The weights-carried-across path: the JAX Target's fields give the
    same logp and truth."""
    jt = MAKERS[name][0]()
    tt = target_from_numpy(jt.name, jt.dim, jt.mean, jt.cov, jt.extras,
                           device="cpu")
    _same_truth(tt, jt)
    x = _points(jt.dim, seed=1)
    _close(tt(torch.from_numpy(x)).numpy(),
           np.asarray(jax.vmap(jt.logp)(jnp.asarray(x))))
    if name == "bayesian_linear_regression":
        assert tt.prior_scale == pytest.approx(10.0, rel=1e-9)


def test_target_from_numpy_unknown_name():
    with pytest.raises(ValueError, match="no port"):
        target_from_numpy("nope", 2)


def test_mixture_moments_analytic():
    t = mt.gaussian_mixture([[-3.0, 0.0], [3.0, 0.0]], scales=[1.0, 2.0],
                            device="cpu")
    np.testing.assert_allclose(t.mean, [0.0, 0.0], atol=1e-12)
    assert t.cov[0, 0] == pytest.approx(0.5 * (1 + 9) + 0.5 * (4 + 9))
    assert t.cov[1, 1] == pytest.approx(0.5 * 1 + 0.5 * 4)


def test_targets_run_in_the_sampler():
    """A target module drives the sampler batched, with StretchMove and
    with FusedStretchMove (the CPU plain path of the split kernels)."""
    t = mt.rosenbrock(1.0, 5.0, 4.0)
    for mover in (mt.StretchMove(a=3.0), mt.FusedStretchMove(a=3.0)):
        s = mt.EnsembleSampler(t, 64, 2, mover=mover, seed=1, batched=True,
                               device="cpu")
        s.init_ball(np.array([1.0, 1.0]), scale=0.5)
        assert s.run_mcmc(20)
        lp = s.get_log_probs()
        np.testing.assert_allclose(
            lp, t(torch.from_numpy(s.get_samples())).numpy(), rtol=1e-6)
        assert 0 < s.accepted_steps < s.total_steps
