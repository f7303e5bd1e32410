"""Power-posterior parallel tempering in the port against the JAX package,
on the CPU.

Power-mode steps replay JAX's ``_step_power`` with JAX's own draws (each
rung's proposal and log u re-derived from its key, the exchange phase's from
the swap key): on a ladder with a β = 0 rung and a likelihood that is −inf
on half the line, from walkers started in and out of its support, the grids,
the swap counts and every evidence accumulator (the finite-masked Welford
mean, the streaming stepping-stone logsumexp, the step counts) agree within
1e-5 (float32; the logsumexp and the means sum in another order), −inf
where JAX has −inf and never a NaN. The rest mirrors
``tests/test_evidence.py`` at small sizes against the same conjugate
quadrature oracle, with the JAX test's own bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.tempering import power_ladder
from tests.test_torch_tempering import assert_states, jax_step_noise, \
    port_state

torch.set_num_threads(1)

# conjugate 1-D Gaussian: prior N(0, S0²), likelihood y_i ~ N(theta, 1)
S0 = 2.0
Y = np.array([1.14, 0.72, 0.21, 1.95, 0.38, 1.52, -0.34, 0.91, 1.18, 0.43],
             np.float32)
YT = torch.from_numpy(Y)


def logprior(t):
    return -0.5 * torch.sum(t * t) / S0 ** 2 - 0.5 * np.log(
        2 * np.pi * S0 ** 2)


def loglike(t):
    return torch.sum(-0.5 * (YT - t[0]) ** 2) - Y.size / 2 * np.log(
        2 * np.pi)


def ll_gated(t):
    # likelihood zero for t < 0, Gaussian otherwise
    return torch.where(t[0] < 0.0, -torch.inf,
                       -0.5 * torch.sum((t - 1.0) ** 2))


def j_logprior(t):
    return -0.5 * jnp.sum(t * t) / S0 ** 2 - 0.5 * np.log(2 * np.pi * S0 ** 2)


def j_ll_gated(t):
    return jnp.where(t[0] < 0.0, -jnp.inf, -0.5 * jnp.sum((t - 1.0) ** 2))


def _quadrature_logz():
    g = np.linspace(-12, 12, 200001)
    lp = (-0.5 * g ** 2 / S0 ** 2 - 0.5 * np.log(2 * np.pi * S0 ** 2)
          + np.sum(-0.5 * (Y[:, None] - g[None, :]) ** 2, axis=0)
          - Y.size / 2 * np.log(2 * np.pi))
    m = lp.max()
    return m + np.log(np.trapezoid(np.exp(lp - m), g))


LOGZ_TRUE = _quadrature_logz()


@pytest.mark.parametrize("swap_every", [1, 3])
def test_power_steps_replay_jax(swap_every):
    """Five power-mode steps from JAX's states with JAX's draws: K = 4
    power ladder (β = 0 rung), a gated likelihood (−inf for t < 0) and
    walkers started around 0, half of them outside the support."""
    j = jref.ParallelTemperingSampler(
        loglike_fn=j_ll_gated, logprior_fn=j_logprior, n_walkers=32,
        n_params=1, betas=jref.power_ladder(4), seed=5,
        swap_every=swap_every)
    j.init_ball(np.zeros(1), scale=1.0, seed=6)
    t = mt.ParallelTemperingSampler(
        loglike_fn=ll_gated, logprior_fn=logprior, n_walkers=32,
        n_params=1, betas=power_ladder(4), device="cpu",
        swap_every=swap_every)
    state = j.state
    assert np.isneginf(np.asarray(state.ll_red)).any()
    for _ in range(5):
        new_j = j._step(state)
        new_t = t.step(port_state(state), jax_step_noise(j, state))
        assert_states(new_t, new_j)
        for name in ("ll_mean", "ll_m2", "ss_max", "ss_sum", "acc_n",
                     "ll_n", "ll_red", "logp_red"):
            assert not torch.isnan(getattr(new_t, name)).any(), name
        state = new_j
    assert float(state.acc_n) == 5.0
    assert np.isfinite(np.asarray(state.ss_max)).all()


def test_accumulators_fed_the_same_ll_grids_agree():
    """The evidence accumulators alone, over twelve steps of seeded ll
    grids with −inf walkers and a rung whose mean is −inf on some steps:
    the JAX formulas (``tempering.py:441-478``, here in numpy float32 as
    JAX computes them) against ``_accumulate_evidence``."""
    from mcmcpp_tpu_torch.tempering import PTState, _accumulate_evidence

    rng = np.random.default_rng(0)
    k, h = 4, 16
    betas = power_ladder(k)
    s = mt.ParallelTemperingSampler(loglike_fn=loglike, logprior_fn=logprior,
                                    n_walkers=2 * h, n_params=1,
                                    betas=betas, device="cpu")
    acc = s._zero_evidence_acc()
    ref = {n: v.numpy().astype(np.float32) for n, v in acc.items()}
    b = betas.numpy()
    for step in range(12):
        ll = (rng.normal(size=(k, 2 * h)) * 4 - 10).astype(np.float32)
        ll[2, ::5] = -np.inf
        if step % 3 == 0:
            ll[1, :] = -np.inf
        state = PTState(*([None] * 4), 0, None, None, **acc)
        acc = _accumulate_evidence(state, torch.from_numpy(ll[:, :h]),
                                   torch.from_numpy(ll[:, h:]), betas)
        x = jnp.asarray(ll)
        step_mean = jnp.mean(x, axis=1)
        finite = jnp.isfinite(step_mean)
        safe_mean = jnp.where(finite, step_mean, 0.0)
        ll_n = ref["ll_n"] + finite.astype(jnp.float32)
        delta = safe_mean - ref["ll_mean"]
        ll_mean = jnp.where(finite, ref["ll_mean"] + delta
                            / jnp.maximum(ll_n, 1.0), ref["ll_mean"])
        ll_m2 = jnp.where(finite, ref["ll_m2"] + delta * (safe_mean
                                                          - ll_mean),
                          ref["ll_m2"])
        xs = jnp.where(jnp.isneginf(x[1:]), -jnp.inf,
                       (b[:-1] - b[1:])[:, None] * x[1:])
        lse = jax.scipy.special.logsumexp(xs, axis=1)
        m_new = jnp.maximum(ref["ss_max"], lse)
        safe = jnp.isfinite(m_new)
        ss_sum = jnp.where(safe, ref["ss_sum"] * jnp.exp(jnp.where(
            safe, ref["ss_max"] - m_new, 0.0)) + jnp.exp(jnp.where(
                safe, lse - m_new, -jnp.inf)), 0.0)
        ref = dict(ll_mean=ll_mean, ll_m2=ll_m2, ss_max=m_new, ss_sum=ss_sum,
                   acc_n=ref["acc_n"] + 1.0, ll_n=ll_n)
        for n in ref:
            np.testing.assert_allclose(acc[n].numpy(), np.asarray(ref[n]),
                                       rtol=1e-5, atol=1e-5, err_msg=n)


def _run_power_pt(n_temps=12, seed=0, w=64, burn=300, steps=1000):
    pt = mt.ParallelTemperingSampler(
        loglike_fn=loglike, logprior_fn=logprior, n_walkers=w, n_params=1,
        betas=power_ladder(n_temps), seed=seed, device="cpu")
    pt.init_ball(np.zeros(1), scale=1.0, seed=1)
    pt.run_mcmc(burn, thin=burn)  # burn-in
    pt.reset_evidence()
    pt.run_mcmc(steps, thin=5)
    return pt


def test_stepping_stone_matches_quadrature():
    """Mirror of ``test_evidence.py::test_stepping_stone_matches_quadrature``
    (W = 64, 300 + 1000 steps; the JAX test's bounds): stepping stone within
    0.1 and TI within 0.5 of the quadrature log Z, the cold chain's
    conjugate moments within 0.05, a monotone TI curve from β = 0 to 1."""
    pt = _run_power_pt()
    assert pt.log_evidence("stepping_stone") == pytest.approx(LOGZ_TRUE,
                                                              abs=0.1)
    assert pt.log_evidence("ti") == pytest.approx(LOGZ_TRUE, abs=0.5)
    post_prec = 1.0 / S0 ** 2 + Y.size
    samp = pt.get_samples(flat=True)
    assert samp.mean() == pytest.approx(Y.sum() / post_prec, abs=0.05)
    assert samp.std() == pytest.approx(post_prec ** -0.5, abs=0.05)
    betas, means = pt.ti_curve()
    assert betas[0] == 0.0 and betas[-1] == 1.0
    assert np.all(np.diff(means) >= -0.5)
    # the stored logp is the raw posterior (prior + log-likelihood)
    x = torch.from_numpy(pt.get_samples()[-1])
    np.testing.assert_allclose(
        pt.get_log_probs()[-1],
        (torch.func.vmap(logprior)(x) + torch.func.vmap(loglike)(x)).numpy(),
        rtol=1e-5, atol=1e-5)


def test_reset_evidence_restarts_accumulation():
    pt = mt.ParallelTemperingSampler(
        loglike_fn=loglike, logprior_fn=logprior, n_walkers=32, n_params=1,
        betas=power_ladder(4), seed=0, device="cpu")
    pt.init_ball(np.zeros(1), scale=1.0)
    pt.run_mcmc(50, thin=50)
    assert float(pt.state.acc_n) == 50
    pt.reset_evidence()
    assert float(pt.state.acc_n) == 0
    with pytest.raises(RuntimeError, match="no accumulated"):
        pt.log_evidence()
    pt.run_mcmc(10, thin=10)
    assert float(pt.state.acc_n) == 10
    with pytest.raises(ValueError, match="unknown method"):
        pt.log_evidence("harmonic")


def test_power_mode_validation():
    with pytest.raises(ValueError, match="BOTH"):
        mt.ParallelTemperingSampler(loglike_fn=loglike, n_walkers=8,
                                    n_params=1, device="cpu")
    with pytest.raises(ValueError, match="either"):
        mt.ParallelTemperingSampler(logp_fn=loglike, loglike_fn=loglike,
                                    logprior_fn=logprior, n_walkers=8,
                                    n_params=1, device="cpu")
    with pytest.raises(ValueError, match="improper"):
        mt.ParallelTemperingSampler(logp_fn=loglike, n_walkers=8,
                                    n_params=1, betas=power_ladder(4),
                                    device="cpu")
    for mover in (mt.EnsembleSliceMove(), mt.SequenceMove([1.0]),
                  mt.MixtureMover([(mt.StretchMove(), 1.0)])):
        with pytest.raises(ValueError, match="propose-based"):
            mt.ParallelTemperingSampler(loglike_fn=loglike,
                                        logprior_fn=logprior, n_walkers=8,
                                        n_params=1, mover=mover,
                                        device="cpu")
    pt = mt.ParallelTemperingSampler(
        logp_fn=lambda t: -0.5 * torch.sum(t * t), n_walkers=8, n_params=1,
        n_temps=2, device="cpu")
    with pytest.raises(RuntimeError, match="power-posterior"):
        pt.reset_evidence()
    with pytest.raises(RuntimeError, match="power-posterior"):
        pt.log_evidence()


def test_zero_likelihood_region_recovers():
    """Mirror of ``test_evidence.py::test_zero_likelihood_region_recovers``:
    walkers started where L = 0 still move, the evidence stays finite and
    within 0.25 of the quadrature truth, and the cold chain lands in the
    support."""
    pt = mt.ParallelTemperingSampler(
        loglike_fn=ll_gated, logprior_fn=logprior, n_walkers=64, n_params=1,
        betas=power_ladder(6), seed=0, device="cpu")
    pt.init_ball(np.full(1, -2.0), scale=0.3)
    pt.run_mcmc(300, thin=300)
    pt.reset_evidence()
    pt.run_mcmc(500, thin=5)
    ss = pt.log_evidence("stepping_stone")
    assert np.isfinite(ss)
    g = np.linspace(0, 12, 100001)
    lp = (-0.5 * g ** 2 / S0 ** 2 - 0.5 * np.log(2 * np.pi * S0 ** 2)
          - 0.5 * (g - 1.0) ** 2)
    m = lp.max()
    truth = m + np.log(np.trapezoid(np.exp(lp - m), g))
    assert ss == pytest.approx(truth, abs=0.25)
    assert (pt.get_samples(flat=True) >= 0).all()


def test_tune_ladder_rejected_in_power_mode():
    pt = mt.ParallelTemperingSampler(
        loglike_fn=loglike, logprior_fn=logprior, n_walkers=16, n_params=1,
        betas=power_ladder(4), seed=0, device="cpu")
    pt.init_ball(np.zeros(1), scale=1.0)
    with pytest.raises(RuntimeError, match="power-posterior"):
        pt.tune_ladder(n_blocks=1, block_steps=5)


def test_ti_survives_hard_constraints():
    """Mirror of ``test_evidence.py::test_ti_survives_hard_constraints``: a
    −inf log-likelihood walker does not NaN-poison the TI accumulator; TI
    warns and stays finite, every rung above β = 0 recovers."""
    pt = mt.ParallelTemperingSampler(
        loglike_fn=ll_gated, logprior_fn=logprior, n_walkers=64, n_params=1,
        betas=power_ladder(6), seed=0, device="cpu")
    pt.init_ball(np.full(1, -2.0), scale=0.3)
    pt.run_mcmc(200, thin=200)
    pt.reset_evidence()
    pt.run_mcmc(300, thin=5)
    with pytest.warns(UserWarning, match="non-finite|conditioned"):
        ti = pt.log_evidence("ti")
    assert np.isfinite(ti)
    betas, means = pt.ti_curve()
    assert np.isfinite(means[1:]).all()
