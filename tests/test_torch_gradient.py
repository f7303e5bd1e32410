"""The port's gradient kernels replay the JAX package's, on the CPU.

(ChEES's batch step, MEADS's fold step and a whole warmup are replayed in
``tests/test_torch_gradient_adapt.py``, MCLMC and MAMS in
``tests/test_torch_mclmc.py``, SGLD and SGHMC in ``tests/test_torch_sgmcmc.py``.)

Each transition kernel gets the same seeded numpy inputs as the JAX kernel
(vmapped over chains as its sampler vmaps it) and the very numbers the JAX
kernel drew, re-derived from its keys as the kernel splits them; the port's
``apply`` must then give the same positions, logps and gradients
(rtol = atol = 1e-5, float32: the same formulas, sums in another order) and
the same accept masks, except within 1e-4·max(1, |log_ratio|) of the
threshold. NUTS's chosen leaf (its proposal) must be equal for every chain;
ties within that tolerance would be excused, at most one chain in 64.

Targets: the logistic regression (50 rows, P = 4, a non-Gaussian logp with
a data-dependent gradient) and the AR(1) Gaussian. Metrics: diagonal for
every kernel, dense for HMC, NUTS and MALA. The step sizes spread over
0.1–1.3 so that the batch holds accepts and rejects. HMC's eight leapfrog
steps loosen its tolerance to 1e-4.

"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import models as jm
from mcmcpp_tpu.gradient import barker as jbarker
from mcmcpp_tpu.gradient import hmc as jhmc
from mcmcpp_tpu.gradient import mala as jmala
from mcmcpp_tpu.gradient import metric as jmetric
from mcmcpp_tpu.gradient import nuts as jnuts
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.convert import (
    dense_mass_from_numpy,
    gradient_state_from_numpy,
    target_from_numpy,
)
from mcmcpp_tpu_torch.gradient import metric as tmetric
from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad

torch.set_num_threads(1)

C, P, D = 64, 4, 4
TOL = 1e-5
MARGIN = 1e-4
F32 = jnp.float32


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def problem():
    """The logistic target in both packages, a start near the mode, its
    logp and gradient from JAX, per-chain step sizes, a diagonal and a
    dense metric."""
    jt = jm.logistic_regression(n_data=50, dim=P, seed=3)
    tt = target_from_numpy(jt.name, jt.dim, extras=jt.extras, device="cpu")
    rng = np.random.default_rng(0)
    q = (0.3 * rng.normal(size=(C, P))).astype(np.float32)
    lp, g = jax.vmap(jax.value_and_grad(jt.logp))(jnp.asarray(q))
    step = np.linspace(0.1, 1.3, C).astype(np.float32)
    var = (0.5 + rng.uniform(size=P)).astype(np.float32)
    cov = np.cov(rng.normal(size=(200, P)).T).astype(np.float32)
    return dict(jt=jt, tt=tt, q=q, lp=np.asarray(lp), g=np.asarray(g),
                step=step, var=var, cov=cov)


def _metric(pb, metric):
    if metric == "diag":
        return jnp.asarray(pb["var"]), _t(pb["var"])
    return (jmetric.dense_mass_from_cov(jnp.asarray(pb["cov"])),
            dense_mass_from_numpy(pb["cov"], device="cpu"))


def _state(pb):
    return gradient_state_from_numpy(pb["q"], pb["lp"], pb["g"],
                                     device="cpu")


def assert_states(t_state, j_state, accept_t, accept_j, log_ratio, tol=TOL):
    """Positions, logps and gradients within ``tol``; accept masks equal
    except near the threshold (``log_ratio`` is log_ratio − log_u there)."""
    near = np.abs(log_ratio) < MARGIN * np.maximum(1.0, np.abs(log_ratio))
    same = np.asarray(accept_t) == np.asarray(accept_j)
    assert np.all(same | near), np.flatnonzero(~same & ~near)
    assert 0 < np.sum(accept_j) < len(same) or len(same) < 8
    for a, b in zip(t_state, j_state):
        np.testing.assert_allclose(np.asarray(a)[same], np.asarray(b)[same],
                                   rtol=tol, atol=tol)


# -- JAX's draws, re-derived from the per-chain keys -------------------------


def hmc_noise(k):
    """``hmc_kernel``'s (and ``mala_kernel``'s) split: z, −Exp(1)."""
    k_mom, k_acc = jax.random.split(k)
    return (jax.random.normal(k_mom, (P,), F32),
            -jax.random.exponential(k_acc, (), F32))


def barker_noise(k):
    k_z, k_b, k_acc = jax.random.split(k, 3)
    return (jax.random.normal(k_z, (P,), F32),
            jax.random.uniform(k_b, (P,), F32),
            -jax.random.exponential(k_acc, (), F32))


def nuts_noise(k):
    """``nuts_kernel``'s key chain (``nuts.py:78``, ``:103``, ``:162``) laid
    out as the port's planes: z, direction bits (D,), merge uniforms (D,),
    leaf uniforms (D, 2^(D-1))."""
    k_mom, k_tree = jax.random.split(k)

    def leaf(key, _):
        key, k_sel = jax.random.split(key)
        return key, jax.random.uniform(k_sel, (), F32)

    def doubling(key, _):
        key, k_dir, k_sub, k_merge = jax.random.split(key, 4)
        return key, (jax.random.bernoulli(k_dir),
                     jax.random.uniform(k_merge, (), F32),
                     jax.lax.scan(leaf, k_sub, length=1 << (D - 1))[1])

    _, (dirs, merges, leaves) = jax.lax.scan(doubling, k_tree, length=D)
    return jax.random.normal(k_mom, (P,), F32), dirs, merges, leaves


# (JAX kernel, port kernel, JAX's draws, tolerance): eight leapfrog steps
# each round the gradient once more, hence HMC's 1e-4
KERNELS = {
    "hmc": (lambda lp: jhmc.hmc_kernel(lp, 8),
            lambda lp: mt.gradient.hmc_kernel(lp, 8), hmc_noise, 1e-4),
    "mala": (jmala.mala_kernel, mt.gradient.mala_kernel, hmc_noise, TOL),
    "barker": (jbarker.barker_kernel, mt.gradient.barker_kernel,
               barker_noise, TOL),
    "nuts": (lambda lp: jnuts.nuts_kernel(lp, D),
             lambda lp: mt.gradient.nuts_kernel(lp, D), nuts_noise, TOL),
}


@pytest.mark.parametrize("name,metric", [
    ("hmc", "diag"), ("hmc", "dense"), ("mala", "diag"), ("mala", "dense"),
    ("barker", "diag"), ("nuts", "diag"), ("nuts", "dense")])
def test_kernel_replays_jax(problem, name, metric):
    pb = problem
    make_j, make_t, noise_fn, tol = KERNELS[name]
    im_j, im_t = _metric(pb, metric)
    keys = jax.random.split(jax.random.key(7), C)
    jk = make_j(pb["jt"].logp)
    (qj, lpj, gj), (apj, accj, divj, enj) = jax.jit(jax.vmap(
        lambda k, q, lp, g, s: jk(k, q, lp, g, s, im_j)))(
            keys, pb["q"], pb["lp"], pb["g"], pb["step"])
    noise = tuple(_t(x) for x in jax.vmap(noise_fn)(keys))
    st, (apt, acct, divt, ent) = make_t(pb["tt"]).apply(
        noise, _state(pb), _t(pb["step"]), im_t)
    if name == "nuts":
        # the chosen leaf: equal for every chain (a near tie in a U-turn or
        # merge decision would be excused, at most one chain in 64)
        moved = np.asarray(accj)
        assert 0 < moved.sum() and np.array_equal(acct.numpy(), moved)
        off = ~np.all(np.isclose(st.position.numpy(), np.asarray(qj),
                                 rtol=tol, atol=tol), axis=1)
        assert off.sum() <= C // 64, np.flatnonzero(off)
        for a, b in zip(st, (qj, lpj, gj)):
            np.testing.assert_allclose(np.asarray(a)[~off],
                                       np.asarray(b)[~off], rtol=tol, atol=tol)
    else:
        # log_ratio − log_u from the accept statistic: log(ap) − log_u
        log_u = noise[-1].numpy()
        gap = np.log(np.maximum(np.asarray(apj), 1e-30)) - log_u
        assert_states(st, (qj, lpj, gj), acct, accj, gap, tol)
    np.testing.assert_allclose(apt.numpy(), np.asarray(apj), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(ent.numpy(), np.asarray(enj), rtol=tol,
                               atol=tol)
    assert np.array_equal(divt.numpy(), np.asarray(divj))


def test_logp_and_grad_is_jax_value_and_grad(problem):
    lp, g = logp_and_grad(problem["tt"], _t(problem["q"]))
    np.testing.assert_allclose(lp.numpy(), problem["lp"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g.numpy(), problem["g"], rtol=TOL, atol=TOL)
    assert not lp.requires_grad and not g.requires_grad


def test_nuts_edge_arithmetic_matches_jax():
    """The multinomial draws lean on −inf: logaddexp(−inf, −inf) = −inf, and
    log(0) = −inf, whose difference is NaN, which no `<` takes."""
    ninf = torch.tensor([-torch.inf, 0.0])
    assert torch.logaddexp(ninf, ninf)[0] == -torch.inf
    assert float(jnp.logaddexp(-jnp.inf, -jnp.inf)) == -np.inf
    assert torch.log(torch.tensor(0.0)) == -torch.inf
    gap = ninf - torch.logaddexp(ninf, ninf)
    assert torch.isnan(gap[0]) and not bool(torch.log(torch.tensor(0.5))
                                            < gap[0])


def test_metric_primitives_equal_jax(problem):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(C, P)).astype(np.float32)
    for metric in ("diag", "dense"):
        im_j, im_t = _metric(problem, metric)
        for name in ("mass_velocity", "mass_kinetic", "mass_momentum",
                     "mass_noise", "mass_noise_t", "mass_quad_inv"):
            np.testing.assert_allclose(
                getattr(tmetric, name)(im_t, _t(x)).numpy(),
                np.asarray(getattr(jmetric, name)(im_j, jnp.asarray(x))),
                rtol=1e-5, atol=1e-5, err_msg=f"{metric} {name}")
            # (P,) as well as (C, P)
            np.testing.assert_allclose(
                getattr(tmetric, name)(im_t, _t(x[0])).numpy(),
                np.asarray(getattr(jmetric, name)(im_j, jnp.asarray(x[0]))),
                rtol=1e-5, atol=1e-5)
    jd, td = _metric(problem, "dense")
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
