"""Statistical mirrors of the gradient engines' JAX tests, on the port alone.

Mirrors the non-slow tests of ``tests/test_gradient.py`` (the moments of the
five samplers, step-size adaptation, mass learning, NUTS moving every chain,
determinism given a seed), of ``tests/test_barker.py`` (the increment
density identity, the kernel exact on a Gaussian) and the gradient cases of
``tests/test_sample_stats.py`` and ``tests/test_export.py`` (``diverging``
and ``energy`` aligned with the chain and carried by
``export.to_inference_dict``; a funnel run flags divergences). The same
oracles and tolerances as the JAX tests, at smaller sizes (64 chains, fewer
steps) where those are slow on a CPU.
"""

import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.export import to_inference_dict
from mcmcpp_tpu_torch.gradient.barker import barker_kernel
from mcmcpp_tpu_torch.gradient.hmc import HMCState, logp_and_grad

torch.set_num_threads(1)

DIM = 4
RHO = 0.5


def _target(dim=DIM, rho=RHO):
    idx = np.arange(dim)
    cov = rho ** np.abs(idx[:, None] - idx[None, :])
    return mt.GaussianTarget.from_cov(cov, device="cpu"), cov


def _run(cls, seed=0, warmup=100, steps=250, n_chains=64, **kw):
    target, cov = _target()
    s = cls(target, n_chains, DIM, seed=seed, device="cpu", **kw)
    s.init_ball(np.zeros(DIM), scale=1.0, seed=seed + 1)
    s.warmup(warmup)
    s.run(steps)
    return s, cov


MOMENT_CASES = {
    "hmc": (mt.HMCSampler, {"n_leapfrog": 8}),
    "mala": (mt.MALASampler, {}),
    "barker": (mt.BarkerSampler, {}),
    "nuts": (mt.NUTSSampler, {"max_depth": 4, "warmup": 80, "steps": 150}),
    "chees": (mt.CheesHMCSampler, {}),
}


@pytest.fixture(scope="module")
def runs():
    """One run of each sampler, shared by the tests that read it."""
    return {name: _run(cls, **kw) for name, (cls, kw) in MOMENT_CASES.items()}


@pytest.mark.parametrize("name", list(MOMENT_CASES))
def test_moments(runs, name):
    s, cov = runs[name]
    flat = s.get_samples(burn_in=50, flat=True)
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(DIM), atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.3)


def test_hmc_step_size_adapts_toward_target(runs):
    s, _ = runs["hmc"]
    assert 0.5 < s.last_mean_accept < 0.99
    assert s.step_size.shape == (64,) and bool((s.step_size > 1e-3).all())


def test_mass_matrix_adaptation_learns_scales():
    """Anisotropic Gaussian: adapted inv_mass ≈ the marginal variances."""
    scales = torch.tensor([0.1, 1.0, 10.0])
    s = mt.HMCSampler(lambda t: -0.5 * torch.sum((t / scales) ** 2, dim=-1),
                      64, 3, seed=2, n_leapfrog=8, device="cpu")
    s.init_ball(np.zeros(3), scale=1.0, seed=3)
    s.warmup(300)
    ratio = s.inv_mass.numpy() / scales.numpy() ** 2
    assert np.all(ratio > 0.2) and np.all(ratio < 5.0), ratio


def test_nuts_moves_every_chain():
    target, _ = _target()
    s = mt.NUTSSampler(target, 8, DIM, seed=5, max_depth=6, device="cpu")
    s.init_ball(np.zeros(DIM), scale=1.0, seed=6)
    before = s.state.position.clone()
    s.warmup(50)
    s.run(50)
    assert bool(torch.all(torch.any(before != s.state.position, dim=1)))
    # a host sync per leaf after a subtree's first and per doubling after
    # the first, each of which may find every chain stopped
    assert 0 < s._kernel.host_syncs < 2 * s._kernel.leapfrogs


def test_deterministic_given_seed():
    s1, _ = _run(mt.HMCSampler, seed=9, warmup=30, steps=50, n_leapfrog=8)
    s2, _ = _run(mt.HMCSampler, seed=9, warmup=30, steps=50, n_leapfrog=8)
    np.testing.assert_array_equal(s1.get_samples(), s2.get_samples())
    s3, _ = _run(mt.HMCSampler, seed=10, warmup=30, steps=50, n_leapfrog=8)
    assert not np.array_equal(s1.get_samples(), s3.get_samples())


# -- Barker specifics (tests/test_barker.py) ---------------------------------


def test_barker_increment_density_identity():
    """The increment w = b·z has density 2 N(w; 0, eps²) sigmoid(w·g): the
    empirical CDF at a few points against the quadrature of it."""
    from scipy.stats import norm

    eps, g, n = 0.7, 1.3, 200_000
    gen = torch.Generator().manual_seed(0)
    z = eps * torch.randn(n, generator=gen, dtype=torch.float64)
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    w = (torch.where(u < torch.sigmoid(z * g), 1.0, -1.0) * z).numpy()
    ts = np.linspace(-1.5, 1.5, 7)
    grid = np.linspace(-6 * eps, max(ts.max(), 6 * eps), 20001)
    pdf = 2.0 * norm.pdf(grid, scale=eps) / (1.0 + np.exp(-grid * g))
    cdf = np.cumsum(pdf) * (grid[1] - grid[0])
    for t in ts:
        assert abs((w <= t).mean() - np.interp(t, grid, cdf)) < 4e-3, t


def test_barker_kernel_is_exact_on_gaussian():
    """A fixed step (no adaptation) on N(0, 1), 64 chains × 1000 steps: mean,
    variance and skewness (a sign error in the correction shows there)."""
    logp = lambda x: -0.5 * torch.sum(x * x, dim=-1)  # noqa: E731
    kernel = barker_kernel(logp)
    gen = torch.Generator().manual_seed(1)
    q = torch.zeros((64, 1))
    state = HMCState(q, *logp_and_grad(logp, q))
    step, inv_mass, xs = torch.full((64,), 0.9), torch.ones(1), []
    for i in range(1100):
        state, _ = kernel.apply(kernel.draw_noise(gen, state), state, step,
                                inv_mass)
        if i >= 100:
            xs.append(state.position[:, 0])
    xs = torch.cat(xs).double().numpy()
    assert abs(xs.mean()) < 0.04
    assert abs(xs.var() - 1.0) < 0.05
    assert abs(((xs - xs.mean()) ** 3).mean()) < 0.08


def test_barker_softplus_is_jax_softplus():
    """logaddexp(x, 0), not torch's softplus, which turns linear above 20."""
    from mcmcpp_tpu_torch.gradient.barker import _softplus

    x = torch.tensor([-30.0, 0.0, 19.5, 20.5, 40.0])
    np.testing.assert_allclose(_softplus(x).numpy(),
                               np.logaddexp(x.numpy(), 0.0), rtol=1e-6)


# -- sample stats and the export (tests/test_sample_stats.py, test_export.py)


STAT_CASES = {
    "hmc": (mt.HMCSampler, {"n_leapfrog": 8}),
    "mala": (mt.MALASampler, {}),
    "barker": (mt.BarkerSampler, {}),
    "nuts": (mt.NUTSSampler, {"max_depth": 6}),
    "chees": (mt.CheesHMCSampler, {}),
    "meads": (mt.MEADSSampler, {}),
}


def _mk(cls, **kw):
    target, _ = _target(3, 0.3)
    s = cls(target, 16, 3, seed=0, device="cpu", **kw)
    s.init_ball(np.zeros(3), scale=0.5, seed=1)
    return s


@pytest.mark.parametrize("name", list(STAT_CASES))
def test_stats_align_with_samples_and_export(name):
    cls, kw = STAT_CASES[name]
    s = _mk(cls, **kw)
    s.warmup(50)
    s.run(60, thin=2)
    samples = s.get_samples()
    stats = s.get_sample_stats()
    assert stats["diverging"].shape == samples.shape[:2] == (30, 16)
    assert stats["energy"].shape == samples.shape[:2]
    assert stats["diverging"].dtype == bool
    assert (s.get_sample_stats(burn_in=5, thin=3)["energy"].shape
            == s.get_samples(burn_in=5, thin=3).shape[:2])
    # an easy target: no divergences, finite energies
    assert s.divergence_count.sum() == 0
    assert np.all(np.isfinite(stats["energy"]))
    d = to_inference_dict(s, burn_in=4, thin=2)
    assert d["posterior"]["theta"].shape == (16, 13, 3)
    for key in ("diverging", "energy"):
        assert d["sample_stats"][key].shape == (16, 13)
        np.testing.assert_array_equal(
            d["sample_stats"][key],
            np.moveaxis(s.get_sample_stats(burn_in=4, thin=2)[key], 0, 1))


def test_absurd_step_size_flags_divergences():
    s = _mk(mt.HMCSampler, n_leapfrog=8, step_size=50.0)
    s.run(50)  # no warmup: keep the absurd step
    assert s.divergence_count.sum() > 0
    assert s.last_mean_accept < 0.1


def test_funnel_nuts_divergences_localized_at_neck():
    """Neal's funnel: divergent transitions concentrate at small v, and the
    export carries them."""
    s = mt.NUTSSampler(mt.neal_funnel(3), 32, 3, seed=3, max_depth=4,
                       device="cpu")
    s.init_ball(np.zeros(3), scale=1.0, seed=4)
    s.warmup(60)
    s.run(60)
    div = s.get_sample_stats()["diverging"]
    assert div.sum() > 0
    v_all = s.get_samples()[:, :, 0]
    if div.sum() >= 5:  # as in the JAX test: don't flake on a few
        assert v_all[div].mean() < v_all.mean()
    exported = to_inference_dict(s)["sample_stats"]["diverging"]
    np.testing.assert_array_equal(exported, div.T)


def test_energy_bfmi_near_one_on_gaussian():
    s = _mk(mt.HMCSampler, n_leapfrog=8)
    s.warmup(100)
    s.run(200)
    en = s.get_sample_stats()["energy"]
    bfmi = np.square(np.diff(en, axis=0)).mean(axis=0) / en.var(axis=0)
    assert np.all(bfmi > 0.3)


def test_cap_truncation_keeps_alignment():
    row = 16 * (3 + 1) * 4
    s = _mk(mt.HMCSampler, n_leapfrog=4, max_chain_bytes=25 * row)
    assert s.run(60) is False  # EndOfChain
    assert s.get_samples().shape[0] == 25
    assert s.get_sample_stats()["diverging"].shape[0] == 25
