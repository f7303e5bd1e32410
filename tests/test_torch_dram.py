"""Statistical tests of the port's DRAM move and of the ACT oracles on the
CPU: mirrors of ``TestDRAM`` in ``tests/test_movers.py`` and of the two ACT
tests of ``tests/test_reference_defects.py`` (with the port's
AutoRegressiveMove), with the run helpers of
``tests/test_torch_mover_stats.py``."""

import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from tests.targets import skewed_gaussian_cov
from tests.test_torch_mover_stats import check_moments, run_mover

torch.set_num_threads(1)


class TestDRAM:
    def test_moments_ensemble_adaptive(self):
        s = run_mover(mt.DRAMMove(), n_steps=6000)
        check_moments(s, atol=0.15)
        assert 0.15 < s.acceptance_fraction < 0.95

    def test_moments_static_covariance(self):
        s = run_mover(mt.DRAMMove(covariance=skewed_gaussian_cov(),
                                  scale=1.2, adapt=None), n_steps=6000)
        check_moments(s, atol=0.15)

    def test_reject_then_accept_path(self):
        big = 50.0
        mh = run_mover(mt.MetropolisHastingsMove(scale=big), n_steps=400,
                       burn=100)
        dram = run_mover(mt.DRAMMove(scale=big, gamma=0.01, adapt=None),
                         n_steps=400, burn=100)
        assert mh.acceptance_fraction < 0.02
        assert dram.acceptance_fraction > 10 * max(mh.acceptance_fraction,
                                                   0.005)

    def test_gaussian_moments_exact(self):
        """Tight 1-D check that the DR ratio is the right one."""
        s = mt.EnsembleSampler(
            lambda t: -0.5 * torch.sum(t * t, dim=-1), 256, 1, batched=True,
            mover=mt.DRAMMove(scale=3.0, gamma=0.15, adapt=None), seed=3,
            device="cpu")
        s.init_ball(np.zeros(1), scale=0.5)
        s.run_mcmc(500, store=False)
        s.run_mcmc(8000)
        x = s.get_samples(flat=True)
        assert abs(float(np.var(x)) - 1.0) < 0.05
        assert abs(float(np.mean(x))) < 0.05

    def test_tempered_targets_power_posterior(self):
        mover = mt.DRAMMove(scale=4.0, gamma=0.2, adapt=None)

        def logp(t):
            return -0.5 * torch.sum(t * t, dim=-1)

        state = mover.init_state(1, torch.float32, "cpu")
        gen = torch.Generator().manual_seed(0)
        n = 256
        active = 2.0 * torch.randn((n, 1), generator=gen)
        other = 2.0 * torch.randn((n, 1), generator=gen)
        alp = logp(active)
        draws = []
        for i in range(900):
            noise = mover.draw_noise(gen, n, n, 1, "cpu")
            active, alp, _ = mover.apply(active, alp, other, logp, state,
                                         noise, beta=0.25)
            if i >= 150:
                draws.append(active.numpy())
        x = np.concatenate(draws, axis=0)
        np.testing.assert_allclose(x.std(), 2.0, rtol=0.08)
        np.testing.assert_allclose(x.mean(), 0.0, atol=0.2)

    def test_validation(self):
        with pytest.raises(ValueError):
            mt.DRAMMove(gamma=0.0)
        with pytest.raises(ValueError):
            mt.DRAMMove(adapt="history")
        with pytest.raises(ValueError):
            mt.DRAMMove(covariance=np.array([1.0, -1.0]),
                        adapt=None).init_state(2, torch.float32, "cpu")
        with pytest.raises(np.linalg.LinAlgError):
            mt.DRAMMove(covariance=np.array([[1.0, 2.0], [2.0, 1.0]]),
                        adapt=None).init_state(2, torch.float32, "cpu")

    def test_failed_factorisation_rejects(self):
        """A complementary half with no spread and eps = 0 cannot be
        factorised: cholesky_ex keeps the failure on the device and every
        proposal is NaN, so every walker stays (JAX's NaN factor)."""
        mover = mt.DRAMMove(eps=0.0)
        x = torch.randn((8, 2))
        other = torch.ones((8, 2))

        def logp(t):
            return -0.5 * torch.sum(t * t, dim=-1)

        noise = mover.draw_noise(torch.Generator().manual_seed(1), 8, 8, 2,
                                 "cpu")
        new, new_lp, acc = mover.apply(x, logp(x), other, logp, (), noise)
        assert not bool(acc.any())
        assert torch.equal(new, x)


# -- the ACT oracles of tests/test_reference_defects.py --------------------


def _ar_run(phi, n_walkers, n_steps, seed, init_seed):
    mover = mt.AutoRegressiveMove(np.zeros(1), np.array([phi]), np.ones(1))
    s = mt.EnsembleSampler(lambda t: torch.zeros(t.shape[0]), n_walkers, 1,
                           mover=mover, seed=seed, batched=True,
                           device="cpu")
    gen = torch.Generator().manual_seed(init_seed)
    s.set_initial_walker_pos(mover.initial_positions(gen, n_walkers,
                                                     device="cpu"))
    s.run_mcmc(n_steps)
    return s, mover


def test_act_no_cross_walker_contamination():
    """The pooled ACT of AR(1) walkers with φ = 0.9 is the analytic 19
    (AutoCorrCalc.h:234-240 leaked walker k's autocovariance into k−1)."""
    s, mover = _ar_run(0.9, 64, 32768, seed=0, init_seed=1)
    tau = mt.analysis.autocorr_time(s.get_samples(), device="cpu")
    assert tau[0] == pytest.approx(float(mover.true_act[0]), rel=0.1)
    assert s.accepted_steps == s.total_steps


def test_act_walker_subset_uses_uniform_selection():
    """A uniform walker subset gives an ACT consistent with the full
    ensemble's (AutoCorrCalc.h:290-303 drew the subset from a normal)."""
    s, _ = _ar_run(0.8, 100, 16384, seed=2, init_seed=3)
    full = mt.analysis.autocorr_time(s.get_samples(), device="cpu")
    sub = mt.analysis.autocorr_time(s.get_samples(), walkers_to_use=30,
                                     device="cpu",
                                    generator=torch.Generator().manual_seed(4))
    assert sub[0] == pytest.approx(full[0], rel=0.15)
