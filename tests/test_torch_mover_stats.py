"""Per-mover statistical tests of the port on the CPU.

Mirrors of the non-slow tests of ``tests/test_movers.py`` (the reference's
test/sequential/SkewedGaussian/{StretchMove,WalkMove,DiffEvo,MH}: every
mover must reproduce the analytic covariance [[1+ε, (1−ε)/2],
[(1−ε)/2, (1+ε)/4]], ε = 0.13, with the same walkers, steps and
tolerances). The slice and DRAM mirrors are in ``tests/test_torch_slice.py``
and ``tests/test_torch_dram.py``. The port draws its own random numbers, so
these hold it to the statistics, not to JAX's draws
(``tests/test_torch_movers.py`` does that).
"""

import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from tests.targets import skewed_gaussian_cov

torch.set_num_threads(1)


def run_mover(mover, n_steps=4000, burn=800, n_walkers=100, seed=11):
    # the skewed Gaussian as a batched module: the same density as
    # tests/targets.py's logp, without torch.func.vmap's cost per call
    s = mt.EnsembleSampler(mt.skewed_gaussian(device="cpu"), n_walkers, 2,
                           mover=mover, seed=seed, batched=True, device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    s.run_mcmc(burn, store=False)
    assert s.run_mcmc(n_steps)
    return s


def check_moments(s, atol=0.12):
    flat = s.get_samples(flat=True)
    cov = np.cov(flat.T)
    true = skewed_gaussian_cov()
    assert np.allclose(cov, true, atol=atol), f"cov=\n{cov}\ntrue=\n{true}"
    assert np.allclose(flat.mean(axis=0), 0.0, atol=0.15)


class TestWalkMove:
    def test_bad_n_samples(self):
        with pytest.raises(ValueError):
            mt.WalkMove(n_samples=1)

    def test_n_samples_exceeds_half(self):
        with pytest.raises(ValueError):
            run_mover(mt.WalkMove(n_samples=60), n_steps=2, burn=0)

    def test_gather_mode_moments(self):
        s = run_mover(mt.WalkMove(n_samples=6, partner_mode="gather"),
                      n_steps=4000)
        check_moments(s, atol=0.15)


class TestDifferentialEvolution:
    def test_moments(self):
        s = run_mover(mt.DifferentialEvolutionMove(), n_steps=6000)
        check_moments(s, atol=0.15)

    def test_custom_gamma(self):
        s = run_mover(mt.DifferentialEvolutionMove(gamma=1.0), n_steps=3000)
        check_moments(s, atol=0.2)


class TestMetropolisHastings:
    def test_ideal_covariance(self):
        s = run_mover(mt.MetropolisHastingsMove(
            covariance=skewed_gaussian_cov(), scale=1.2), n_steps=6000)
        check_moments(s, atol=0.15)

    def test_identity_default(self):
        s = run_mover(mt.MetropolisHastingsMove(scale=0.8), n_steps=6000)
        check_moments(s, atol=0.15)

    def test_diagonal_covariance(self):
        s = run_mover(mt.MetropolisHastingsMove(
            covariance=np.array([1.1, 0.3])), n_steps=6000)
        check_moments(s, atol=0.15)

    def test_bad_covariance_falls_back_to_identity(self):
        bad = np.array([[1.0, 2.0], [2.0, 1.0]])  # symmetric but not PD
        with pytest.warns(UserWarning, match="identity"):
            mover = mt.MetropolisHastingsMove(covariance=bad)
        assert mover.fell_back_to_identity
        s = run_mover(mover, n_steps=6000)
        check_moments(s, atol=0.15)

    def test_asymmetric_covariance_rejected(self):
        with pytest.warns(UserWarning, match="symmetric"):
            m = mt.MetropolisHastingsMove(
                covariance=np.array([[1.0, 0.5], [0.2, 1.0]]))
        assert m.fell_back_to_identity


class TestMixtureMover:
    def test_validation(self):
        with pytest.raises(ValueError):
            mt.MixtureMover([])
        with pytest.raises(ValueError):
            mt.MixtureMover([(mt.StretchMove(), -1.0)])
        with pytest.raises(ValueError):
            mt.MixtureMover([mt.AutoRegressiveMove(np.zeros(1), np.zeros(1),
                                                   np.ones(1))])

    def test_needs_a_host_generator(self):
        mover = mt.MixtureMover([mt.StretchMove()])
        with pytest.raises(ValueError, match="host_gen"):
            mover.draw_noise(torch.Generator(), 4, 4, 2, "cpu")

    def test_with_fused_stretch_moments(self):
        """emcee's DE + snooker mix with the fused stretch move added (the
        JAX mixture cannot hold its fused mover: it hands it beta as an
        array, which the fused mover refuses)."""
        mover = mt.MixtureMover([(mt.FusedStretchMove(), 2.0),
                                 (mt.DifferentialEvolutionMove(), 1.0),
                                 (mt.DESnookerMove(), 1.0)])
        s = mt.EnsembleSampler(mt.skewed_gaussian(device="cpu"), 100, 2,
                               mover=mover, seed=11, batched=True,
                               device="cpu")
        s.init_ball(np.zeros(2), scale=0.5)
        s.run_mcmc(800, store=False)
        assert s.run_mcmc(4000)
        check_moments(s, atol=0.15)
        assert 0.2 < s.acceptance_fraction < 0.95


class TestDESnooker:
    def test_moments(self):
        s = run_mover(mt.DESnookerMove(), n_steps=6000)
        check_moments(s, atol=0.15)
        assert 0.1 < s.acceptance_fraction < 0.95

    def test_gather_mode_moments(self):
        s = run_mover(mt.DESnookerMove(partner_mode="gather"), n_steps=4000)
        check_moments(s, atol=0.2)

    def test_degenerate_anchor_proposes_no_move(self):
        """X == Z gives no displacement and a zero factor, never NaN."""
        x = torch.ones((4, 3))
        noise = torch.tensor([0, 1, 2], dtype=torch.int32)
        other = torch.ones((4, 3))
        prop, factor = mt.DESnookerMove().propose(x, other, (), noise)
        assert torch.equal(prop, x) and torch.equal(factor, torch.zeros(4))
