"""Statistical tests of the port's ensemble slice move on the CPU: mirrors
of ``TestEnsembleSlice`` in ``tests/test_movers.py`` (its non-slow tests),
with the run helpers of ``tests/test_torch_mover_stats.py``."""

import numpy as np
import torch

import mcmcpp_tpu_torch as mt
from tests.test_torch_mover_stats import check_moments, run_mover

torch.set_num_threads(1)


class TestEnsembleSlice:
    def test_deterministic_given_seed(self):
        a = run_mover(mt.EnsembleSliceMove(), n_steps=50, burn=10, seed=7)
        b = run_mover(mt.EnsembleSliceMove(), n_steps=50, burn=10, seed=7)
        np.testing.assert_array_equal(a.get_samples(), b.get_samples())

    def test_mu_scales_direction(self):
        mover = mt.EnsembleSliceMove(mu=0.3)
        s = run_mover(mover, n_steps=3000, burn=600)
        check_moments(s, atol=0.15)
        assert s.acceptance_fraction > 0.999
        # the loops ran at least one stepping-out and one shrink iteration
        # per half-step, and were counted
        assert mover.half_steps == 2 * 3600
        assert mover.loop_iterations >= 2 * mover.half_steps

    def test_tempered_slice_targets_power_posterior(self):
        """beta = 0.25 on N(0, 1) must sample N(0, 4): the slice height and
        inclusion test are tempered while the stored logp stays raw."""
        mover = mt.EnsembleSliceMove()

        def logp(t):
            return -0.5 * torch.sum(t * t, dim=-1)

        gen = torch.Generator().manual_seed(0)
        n = 128
        active = 2.0 * torch.randn((n, 2), generator=gen)
        other = 2.0 * torch.randn((n, 2), generator=gen)
        alp = logp(active)
        draws = []
        for i in range(600):
            noise = mover.draw_noise(gen, n, n, 2, "cpu")
            active, alp, _ = mover.apply(active, alp, other, logp, (), noise,
                                         beta=0.25)
            if i >= 100:
                draws.append(active.numpy())
        x = np.concatenate(draws, axis=0)
        np.testing.assert_allclose(x.std(axis=0), 2.0, rtol=0.1)
        np.testing.assert_allclose(x.mean(axis=0), 0.0, atol=0.2)
