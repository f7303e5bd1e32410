"""MCLMC and MAMS: the port replays the JAX package's step and trajectory,
and mirrors the non-slow tests of ``tests/test_mclmc.py``.

Replays: one MCLMC step (``mclmc.py:202-219``) and one MAMS trajectory
(``:426-471``) from the same seeded state with JAX's own draws, on the AR(1)
Gaussian (MCLMC with a diagonal metric, MAMS without): positions, momenta, logps and
gradients at rtol = atol = 1e-5 (float32), the energy error too; MAMS's
accept mask equal except within 1e-4·max(1, |ΔE|) of the threshold. JAX
loops ``n_max`` steps and masks those past ``n_live``; the port loops
``n_live`` times.

Mirrors (the same oracles, at 64 chains and fewer steps): Gaussian
moments, the tuner's energy target, the unit momentum, the stored logp, an
ill-conditioned Gaussian, the energy error's scaling with the step, MAMS's
moments and acceptance, its exactness at a coarse step, the correlated
Gaussian, preconditioning, the overflow-free ESH map, validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.gradient.mclmc import MCLMCState

torch.set_num_threads(1)

D = 8
C = 32
F32 = jnp.float32


def std_gauss(t):
    return -0.5 * torch.sum(t * t, dim=-1)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- replays -------------------------------------------------------------------


def _pair(cls_j, cls_t, inv_mass, **kw):
    """The AR(1) target in both packages, the same start and state."""
    idx = np.arange(D)
    cov = 0.5 ** np.abs(idx[:, None] - idx[None, :])
    prec = np.linalg.inv(cov).astype(np.float32)
    pj = jnp.asarray(prec)
    j = cls_j(lambda t: -0.5 * t @ (pj @ t), n_chains=C, n_params=D, seed=1,
              step_size=0.6, decoherence_length=4.0, inv_mass=inv_mass, **kw)
    j.init_ball(np.zeros(D), scale=1.0, seed=2)
    pt = torch.from_numpy(prec)
    t = cls_t(lambda x: -0.5 * torch.sum((x @ pt.T) * x, dim=-1), C, D,
              step_size=0.6, decoherence_length=4.0, inv_mass=inv_mass,
              device="cpu", **kw)
    t.state = MCLMCState(*(_t(x) for x in j.state))
    return j, t


def test_mclmc_step_replays_jax():
    j, t = _pair(jref.MCLMCSampler, mt.MCLMCSampler, np.linspace(0.5, 2.0, D))
    key = jax.random.key(5)
    sj, dej = jax.jit(lambda k, s: j._step(k, s, jnp.float32(0.6), 4.0))(
        key, j.state)
    z = _t(jax.random.normal(key, (C, D), F32))
    st, det = t.apply(z, t.state, 0.6, 4.0)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(det.numpy(), np.asarray(dej), rtol=1e-4,
                               atol=1e-5)


def test_mams_trajectory_replays_jax():
    j, t = _pair(jref.MAMSSampler, mt.MAMSSampler, None)
    eps, n_max = 3.0, 6  # a coarse step: accepts and rejects
    key = jax.random.key(8)
    sj, accj = jax.jit(lambda k, s: j._trajectory(k, s, jnp.float32(eps),
                                                  n_max))(key, j.state)
    k_len, k_u, k_acc = jax.random.split(key, 3)
    n_live = int(jax.random.randint(k_len, (), 1, n_max + 1))
    noise = (n_live, _t(jax.random.normal(k_u, (C, D), F32)),
             _t(jax.random.uniform(k_acc, (C,))))
    st, acct = t.apply(noise, t.state, eps)
    same = acct.numpy() == np.asarray(accj)
    # a flipped decision must sit at the threshold: log u against −ΔE
    assert same.mean() >= 1 - 1 / C and 0 < np.asarray(accj).sum() < C
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=1e-5, atol=1e-5)


def test_esh_no_overflow_on_sharp_targets():
    """δ = dt|g|/(d−1) far beyond 89 (float32 cosh's overflow): the tuner
    and the run stay finite on a σ = 0.01 Gaussian."""
    s = mt.MCLMCSampler(lambda t: -0.5 * torch.sum(t * t, dim=-1) / 1e-4,
                        32, D, seed=0, device="cpu")
    s.init_ball(np.zeros(D), scale=1.0, seed=1)
    s.tune(300)
    assert np.isfinite(s.step_size) and np.isfinite(s.energy_var)
    s.run(300)
    x = s.get_samples(burn_in=50, flat=True)
    assert np.isfinite(x).all()
    assert float(np.median(np.abs(x[-1000:]))) < 0.1


# -- statistical mirrors of tests/test_mclmc.py --------------------------------


@pytest.fixture(scope="module")
def tuned():
    s = mt.MCLMCSampler(std_gauss, 64, D, seed=0, device="cpu")
    s.init_ball(np.zeros(D), scale=1.0, seed=1)
    s.tune(600)
    s.run(1200, thin=2)
    return s


def test_gaussian_moments(tuned):
    x = tuned.get_samples(burn_in=100, flat=True)
    assert x.shape[0] >= 30_000
    np.testing.assert_allclose(x.mean(axis=0), np.zeros(D), atol=0.06)
    np.testing.assert_allclose(x.var(axis=0), np.ones(D), rtol=0.08)
    assert np.abs(np.corrcoef(x.T) - np.eye(D)).max() < 0.05


def test_tune_hits_energy_target(tuned):
    assert 5e-5 < tuned.energy_var < 5e-3
    assert 0.2 < tuned.step_size < 10.0
    assert 1.0 < tuned.decoherence_length < 30.0


def test_unit_momentum_invariant(tuned):
    norms = torch.linalg.vector_norm(tuned.state.momentum, dim=-1).numpy()
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_logp_plane_matches_positions(tuned):
    x = tuned.get_samples()
    np.testing.assert_allclose(tuned.get_log_probs(),
                               -0.5 * np.sum(x ** 2, axis=-1), atol=1e-3)


def test_ill_conditioned_gaussian():
    scales = torch.tensor(np.array([1.0, 5.0, 0.5, 2.0]) ** 2,
                          dtype=torch.float32)
    s = mt.MCLMCSampler(lambda t: -0.5 * torch.sum(t * t / scales, dim=-1),
                        64, 4, seed=3, device="cpu")
    s.init_ball(np.zeros(4), scale=1.0, seed=4)
    s.tune(500)
    s.run(1200, thin=2)
    x = s.get_samples(burn_in=100, flat=True)
    np.testing.assert_allclose(x.var(axis=0), scales.numpy(), rtol=0.15)


def test_energy_error_scales_down_with_step():
    """ΔE ∝ eps²: Var[ΔE] drops ~16x when eps halves."""

    def var_e(eps):
        s = mt.MCLMCSampler(std_gauss, 32, D, seed=5, step_size=eps,
                            decoherence_length=5.0, device="cpu")
        s.init_ball(np.zeros(D), scale=1.0, seed=6)
        s.tune(n_steps=200, rounds=1, target_energy_var=np.inf)  # no-op
        return s.energy_var

    v1, v2 = var_e(2.0), var_e(1.0)
    assert v2 < v1 / 4.0, (v1, v2)


def test_validation():
    with pytest.raises(ValueError, match="n_params >= 2"):
        mt.MCLMCSampler(std_gauss, 4, 1, device="cpu")
    s = mt.MCLMCSampler(std_gauss, 4, 3, device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        s.run(5)
    with pytest.raises(ValueError, match="positions"):
        s.init(np.zeros((3, 3)))
    with pytest.raises(ValueError, match="inv_mass"):
        mt.MCLMCSampler(std_gauss, 4, 3, inv_mass=np.ones(2), device="cpu")


def test_mams_tuned_moments_and_acceptance():
    s = mt.MAMSSampler(std_gauss, 64, D, seed=0, device="cpu")
    s.init_ball(np.zeros(D), scale=1.0, seed=1)
    s.tune(300)
    assert abs(s.last_mean_accept - s.target_accept) < 0.12
    s.run(400)
    x = s.get_samples(burn_in=100, flat=True)
    np.testing.assert_allclose(x.mean(axis=0), np.zeros(D), atol=0.05)
    np.testing.assert_allclose(x.var(axis=0), np.ones(D), rtol=0.05)


def test_mams_exact_at_coarse_step():
    """A crude step costs acceptance, never correctness."""
    s = mt.MAMSSampler(std_gauss, 64, D, seed=2, step_size=2.5,
                       decoherence_length=5.0, device="cpu")
    s.init_ball(np.zeros(D), scale=1.0, seed=3)
    s.run(600)
    x = s.get_samples(burn_in=150, flat=True)
    assert abs(float(x.var(axis=0).mean()) - 1.0) < 0.02


def test_mams_correlated_gaussian():
    cov = 0.5 * np.ones((4, 4)) + 0.5 * np.eye(4)
    s = mt.MAMSSampler(mt.GaussianTarget.from_cov(cov, device="cpu"), 64, 4,
                       seed=4, device="cpu")
    s.init_ball(np.zeros(4), scale=1.0, seed=5)
    s.tune(150)
    s.run(400)
    x = s.get_samples(burn_in=300, flat=True)
    np.testing.assert_allclose(np.cov(x.T), cov, atol=0.06)


def _aniso(scales2):
    s2 = torch.tensor(scales2, dtype=torch.float32)
    return lambda t: -0.5 * torch.sum(t * t / s2, dim=-1)


def test_precondition_recovers_metric_and_moments():
    scales2 = np.array([1.0, 100.0, 0.04, 9.0])
    s = mt.MCLMCSampler(_aniso(scales2), 64, 4, seed=0, device="cpu")
    s.init_ball(np.zeros(4), scale=1.0, seed=1)
    s.tune(1200, precondition=True)
    np.testing.assert_allclose(s.inv_mass.numpy(), scales2, rtol=0.5)
    s.run(1000, thin=2)
    x = s.get_samples(burn_in=200, flat=True)
    np.testing.assert_allclose(x.var(axis=0), scales2, rtol=0.2)


def test_mams_precondition_exact_on_anisotropic():
    scales2 = np.array([1.0, 64.0, 0.25])
    s = mt.MAMSSampler(_aniso(scales2), 64, 3, seed=2, device="cpu")
    s.init_ball(np.zeros(3), scale=1.0, seed=3)
    s.tune(240, precondition=True)
    assert s.inv_mass is not None
    s.run(400)
    x = s.get_samples(burn_in=300, flat=True)
    np.testing.assert_allclose(x.var(axis=0), scales2, rtol=0.12)


def test_inv_mass_reassignment_changes_the_dynamics():
    """The metric is read at every step (no program bakes it in)."""
    def build():
        s = mt.MCLMCSampler(std_gauss, 8, D, seed=0, step_size=0.5,
                            decoherence_length=3.0, device="cpu")
        s.init_ball(np.zeros(D), scale=1.0, seed=1)
        s.run(5)
        return s

    a, b = build(), build()
    assert torch.equal(a.state.position, b.state.position)
    b.inv_mass = np.full(D, 25.0)
    a.run(5)
    b.run(5)
    assert not torch.equal(a.state.position, b.state.position)
