"""The port's ensemble sampler against the JAX package, and on its own.

Whole-slice replays: the JAX sampler runs on the flagship 10-D target
(Σ = 0.5·11ᵀ + 0.5·I, ``bench.py:63-73``) and the port runs the same steps
from the same numpy start, with each half-step's random numbers replayed
from the JAX run through the mover's ``draw_noise``. Chains, logps and
per-walker accept counts must agree to atol 1e-5 (float32: the same formulas,
the logp's product summed in another order).

The port-only tests mirror ``tests/test_sampler_core.py`` on the 2-D skewed
Gaussian, with the sampler on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.movers.fused import FusedStretchMove as JFusedStretchMove
from mcmcpp_tpu.ops.random import split_for_step
from mcmcpp_tpu_torch import (
    EnsembleSampler,
    FusedStretchMove,
    GaussianTarget,
    MixtureMover,
    StretchMove,
    equicorrelated_gaussian,
    skewed_gaussian,
)
from mcmcpp_tpu_torch.convert import state_from_numpy
from mcmcpp_tpu_torch.ops.random import UNIT_FLOOR
from tests.targets import skewed_gaussian_cov, skewed_gaussian_logp

torch.set_num_threads(1)

W, P, N_STEPS, THIN = 64, 10, 12, 3
REPLAY_ATOL = 1e-5


def _flagship_chol():
    cov = 0.5 * np.ones((P, P)) + 0.5 * np.eye(P)
    return np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)


def _jax_logp(L):
    Lj = jnp.asarray(L)

    def logp(x):
        y = x @ Lj
        return -0.5 * jnp.sum(y * y, axis=-1)

    return logp


def _start(seed=0):
    return np.random.default_rng(seed).normal(size=(W, P)).astype(np.float32)


def _run_jax(mover, seed):
    L = _flagship_chol()
    s = jref.EnsembleSampler(_jax_logp(L), W, P, mover=mover, seed=seed,
                             batched=True)
    s.set_initial_walker_pos(_start())
    assert s.run_mcmc(N_STEPS, thin=THIN)
    half_keys = [k for step in range(N_STEPS)
                 for k in split_for_step(s._effective_step_key(), step)]
    return s, half_keys


class _Replay:
    """Mixin: ``draw_noise`` pops the next pre-drawn half-step noise."""

    def __init__(self, noises, **kw):
        super().__init__(**kw)
        self._noises = iter(noises)

    def draw_noise(self, *args, **kwargs):
        return next(self._noises)


class ReplayStretch(_Replay, StretchMove):
    pass


class ReplayFused(_Replay, FusedStretchMove):
    pass


def _stretch_noise(key, n):
    """(shift, u, log_u) exactly as the JAX StretchMove draws them."""
    kp, ka = jax.random.split(key)
    kj, kz = jax.random.split(kp)
    shift = jax.random.randint(jax.random.fold_in(kj, 0), (), 0, n)
    u = jax.random.uniform(kz, (n,), jnp.float32)
    log_u = -jax.random.exponential(ka, (n,), jnp.float32)
    return (torch.tensor([int(shift)], dtype=torch.int32),
            torch.from_numpy(np.array(u)),
            torch.from_numpy(np.array(log_u)))


def _fused_noise(key, n):
    """(shift, u, ue) of the JAX fused kernel in interpret mode, whose
    hardware bits are zeros: u = ue = 2^-25."""
    shift = jax.random.randint(jax.random.split(key)[1], (), 0, n,
                               dtype=jnp.int32)
    floor = torch.full((n,), UNIT_FLOOR)
    return torch.tensor([int(shift)], dtype=torch.int32), floor, floor.clone()


def _run_port(mover):
    s = EnsembleSampler(GaussianTarget.from_numpy(_flagship_chol(), "cpu"),
                        W, P, mover=mover, batched=True, device="cpu")
    s.set_initial_walker_pos(_start())
    assert s.run_mcmc(N_STEPS, thin=THIN)
    return s


def _assert_same_run(j, t):
    assert t.get_samples().shape == (N_STEPS // THIN, W, P)
    np.testing.assert_allclose(t.get_samples(), j.get_samples(), rtol=0,
                               atol=REPLAY_ATOL)
    np.testing.assert_allclose(t.get_log_probs(), j.get_log_probs(), rtol=0,
                               atol=REPLAY_ATOL)
    np.testing.assert_array_equal(t.per_walker_accepted,
                                  j.per_walker_accepted)
    assert t.accepted_steps == j.accepted_steps
    assert t.total_steps == j.total_steps


def test_stretch_replays_jax_default_path():
    j, keys = _run_jax(jref.StretchMove(), seed=5)
    t = _run_port(ReplayStretch([_stretch_noise(k, W // 2) for k in keys]))
    _assert_same_run(j, t)
    assert 0 < j.accepted_steps < j.total_steps


def test_fused_replays_jax_interpret():
    j, keys = _run_jax(JFusedStretchMove(tile=32, interpret=True), seed=9)
    t = _run_port(ReplayFused([_fused_noise(k, W // 2) for k in keys]))
    _assert_same_run(j, t)


def test_init_state_logp_matches_jax():
    L = _flagship_chol()
    j = jref.EnsembleSampler(_jax_logp(L), W, P, batched=True)
    j.set_initial_walker_pos(_start(3))
    t = EnsembleSampler(GaussianTarget.from_numpy(L, "cpu"), W, P,
                        batched=True, device="cpu")
    t.set_initial_walker_pos(_start(3))
    for name in ("logp_red", "logp_black"):
        np.testing.assert_allclose(getattr(t.state, name).numpy(),
                                   np.asarray(getattr(j.state, name)),
                                   rtol=1e-6, atol=1e-6)


def test_state_from_numpy_roundtrip():
    j, _ = _run_jax(jref.StretchMove(), seed=1)
    fields = {f: np.asarray(getattr(j.state, f))
              for f in ("red", "black", "logp_red", "logp_black",
                        "accepted_red", "accepted_black")}
    st = state_from_numpy(**fields, step=int(j.state.step), device="cpu")
    for f, arr in fields.items():
        got = getattr(st, f)
        assert got.dtype == (torch.int32 if f.startswith("acc")
                             else torch.float32)
        np.testing.assert_array_equal(got.numpy(), arr)
    assert st.step == N_STEPS
    # the converted state is live: the port steps on from it
    t = EnsembleSampler(GaussianTarget.from_numpy(_flagship_chol(), "cpu"),
                        W, P, batched=True, device="cpu")
    t.state = st
    assert t.run_mcmc(2)
    assert t.stored_steps == 2


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    with pytest.raises(RuntimeError, match="is_available"):
        EnsembleSampler(skewed_gaussian(device="cpu"), 16, 2, batched=True,
                        device="cuda")


# -- port-only: statistics and mechanics (≙ tests/test_sampler_core.py) ----


def run_skewed(mover=None, n_walkers=100, n_steps=3000, burn=500, seed=3,
               **kw):
    s = EnsembleSampler(skewed_gaussian_logp, n_walkers, 2, mover=mover,
                        seed=seed, device="cpu", **kw)
    s.init_ball(np.zeros(2), scale=0.5)
    s.run_mcmc(burn, store=False)
    assert s.run_mcmc(n_steps)
    return s


@pytest.mark.parametrize("mover", ["stretch", "fused"])
def test_moments(mover):
    if mover == "stretch":
        s = run_skewed(StretchMove(), n_steps=4000)
    else:
        s = EnsembleSampler(skewed_gaussian(device="cpu"), 100, 2,
                            mover=FusedStretchMove(), seed=3, batched=True,
                            device="cpu")
        s.init_ball(np.zeros(2), scale=0.5)
        s.run_mcmc(500, store=False)
        assert s.run_mcmc(4000)
    flat = s.get_samples(flat=True)
    cov = np.cov(flat.T)
    assert np.allclose(cov, skewed_gaussian_cov(), atol=0.12), cov
    assert np.allclose(flat.mean(axis=0), 0.0, atol=0.15)


def test_acceptance_fraction_reasonable():
    s = run_skewed(StretchMove(), n_steps=1000)
    assert 0.3 < s.acceptance_fraction < 0.95
    assert s.total_steps == 1500 * 100
    assert s.per_walker_accepted.sum() == s.accepted_steps


def test_logp_stored_matches_positions():
    s = run_skewed(n_steps=50)
    pos = torch.from_numpy(s.get_samples())
    expect = torch.func.vmap(torch.func.vmap(skewed_gaussian_logp))(pos)
    np.testing.assert_allclose(expect.numpy(), s.get_log_probs(), rtol=1e-4,
                               atol=1e-4)


def test_determinism():
    a = run_skewed(n_steps=100, seed=7)
    b = run_skewed(n_steps=100, seed=7)
    assert np.array_equal(a.get_samples(), b.get_samples())


def test_seed_changes_chain():
    a = run_skewed(n_steps=50, seed=1)
    b = run_skewed(n_steps=50, seed=2)
    assert not np.array_equal(a.get_samples(), b.get_samples())


def _run_fused(seed, mover=None, n_steps=40):
    s = EnsembleSampler(skewed_gaussian(device="cpu"), 32, 2,
                        mover=mover or FusedStretchMove(), seed=seed,
                        batched=True, device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    assert s.run_mcmc(n_steps)
    return s


@pytest.mark.parametrize("mover", ["fused", "mixture"])
def test_fused_determinism_and_seed(mover):
    """The fused mover's keys come from the sampler's host generator: the
    same seed gives the same chain, another seed another, alone and inside
    a mixture (whose branch draws share that generator)."""
    def make():
        if mover == "fused":
            return FusedStretchMove()
        return MixtureMover([(FusedStretchMove(), 2.0), (StretchMove(), 1.0)])

    a, b, c = _run_fused(7, make()), _run_fused(7, make()), _run_fused(8, make())
    assert np.array_equal(a.get_samples(), b.get_samples())
    assert not np.array_equal(a.get_samples(), c.get_samples())
    assert 0 < a.accepted_steps < a.total_steps


def test_fused_cpu_noise_is_planes():
    """On the CPU the fused mover's noise is (shift, u, ue) with planes in
    [2^-25, 1), so a replay can hand ``apply`` any planes."""
    s = _run_fused(1, n_steps=1)
    noise = s.mover.draw_noise(s._step_gen, 16, 16, 2, s.device,
                               host_gen=s._host_gen)
    shift, u, ue = noise
    assert shift.shape == (1,) and shift.dtype == torch.int32
    for plane in (u, ue):
        assert plane.shape == (16,) and plane.dtype == torch.float32
        assert float(plane.min()) >= UNIT_FLOOR and float(plane.max()) < 1.0
    assert not torch.equal(u, ue)


def test_thinning():
    s = EnsembleSampler(skewed_gaussian_logp, 100, 2, seed=3, device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    s.run_mcmc(100, store=False)
    s.run_mcmc(105, thin=10)
    assert s.stored_steps == 10
    assert s.total_steps == 205 * 100


def test_chain_capacity_endofchain():
    row = 100 * 3 * 4  # W*(P+1)*itemsize
    s = EnsembleSampler(skewed_gaussian_logp, 100, 2, seed=0, device="cpu",
                        max_chain_bytes=row * 7, store_chunk_steps=3)
    s.init_ball(np.zeros(2), scale=0.5)
    assert not s.run_mcmc(20)  # ≙ IncrementStatus::EndOfChain
    assert s.stored_steps == 7
    # four chunks of 3 steps ran (the fourth was launched before the cap
    # hit, then dropped); their accepts are all counted
    assert s.total_steps == 12 * 100
    assert 0 < s.accepted_steps == s.per_walker_accepted.sum() < 1200


def test_chain_iterators():
    s = run_skewed(n_steps=6)
    steps = list(s.chain.iter_steps(burn_in=2, thin=2))
    assert len(steps) == 2
    np.testing.assert_array_equal(steps[1], s.get_samples()[4])
    psets = list(s.chain.iter_psets())
    assert len(psets) == 6 * 100
    np.testing.assert_array_equal(psets[101], s.get_samples()[1, 1])


def test_slice_and_burn():
    s = run_skewed(n_steps=100)
    n0 = s.stored_steps
    kept = s.get_samples()[20::5]
    s.slice_and_burn_chain(thin=5, burn_in=20)
    assert s.stored_steps == len(range(20, n0, 5))
    np.testing.assert_array_equal(s.get_samples(), kept)


def test_reset_keeps_position():
    s = run_skewed(n_steps=20)
    pos_before = s.current_positions.clone()
    s.reset()
    assert s.stored_steps == 0
    assert s.total_steps == 0
    assert s.accepted_steps == 0
    assert torch.equal(s.current_positions, pos_before)
    assert s.run_mcmc(5)
    assert s.stored_steps == 5


def test_store_current_positions():
    s = run_skewed(n_steps=5)
    n0 = s.stored_steps
    s.store_current_walker_positions()
    assert s.stored_steps == n0 + 1
    np.testing.assert_array_equal(s.get_samples()[-1],
                                  s.current_positions.numpy())


def test_bad_logp_rejected():
    with pytest.raises(TypeError):
        EnsembleSampler(lambda th: th, 10, 2, device="cpu")


def test_odd_walkers_rejected():
    with pytest.raises(ValueError):
        EnsembleSampler(skewed_gaussian_logp, 7, 2, device="cpu")


def test_fused_rejects_tempering():
    x = torch.zeros((4, 2))
    with pytest.raises(NotImplementedError, match="beta"):
        FusedStretchMove().apply(x, torch.zeros(4), x, None, (), None,
                                 beta=0.5)


def test_flagship_target_matches_bench_form():
    """equicorrelated_gaussian is the flagship's L, x @ L orientation."""
    t = equicorrelated_gaussian(device="cpu")
    x = np.random.default_rng(0).normal(size=(5, P)).astype(np.float32)
    np.testing.assert_allclose(
        t(torch.from_numpy(x)).numpy(),
        np.asarray(_jax_logp(_flagship_chol())(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6,
    )


# -- run hooks (≙ tests/test_diagnostics.py:53-90) -------------------------


def _hook_sampler(n_walkers=32, seed=4, **kw):
    s = EnsembleSampler(skewed_gaussian(device="cpu"), n_walkers, 2,
                        seed=seed, batched=True, device="cpu", **kw)
    s.init_ball(np.zeros(2), scale=0.5, seed=2)
    return s


def test_step_action_hook():
    """PostStepAction: one metric row per stored step, on the device."""
    s = _hook_sampler()

    def action(pos, logp):
        return {"mean": pos.mean(dim=0), "best": logp.max()}

    s.run_mcmc(100, step_action=action)
    m = s.step_metrics
    assert m["mean"].shape == (100, 2)
    assert m["best"].shape == (100,)
    assert isinstance(m["mean"], np.ndarray)
    np.testing.assert_allclose(m["mean"], s.get_samples().mean(axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m["best"], s.get_log_probs().max(axis=1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", ["tensor", "tuple"])
def test_step_action_tensor_and_tuple_outputs(shape):
    s = _hook_sampler(store_chunk_steps=7)
    if shape == "tensor":
        s.run_mcmc(20, thin=2, step_action=lambda pos, lp: lp.mean())
        assert s.step_metrics.shape == (10,)
        want = s.get_log_probs().mean(axis=1)
        np.testing.assert_allclose(s.step_metrics, want, rtol=1e-5)
    else:
        s.run_mcmc(20, thin=2,
                   step_action=lambda pos, lp: (pos[0], lp[:3]))
        first, lps = s.step_metrics
        assert first.shape == (10, 2) and lps.shape == (10, 3)
        np.testing.assert_array_equal(first, s.get_samples()[:, 0])
    # a run without an action clears the metrics
    s.run_mcmc(2)
    assert s.step_metrics is None


def test_chunk_action_hook():
    s = _hook_sampler(seed=5, store_chunk_steps=25)
    seen = []
    s.run_mcmc(100, chunk_action=lambda chain: seen.append(chain.n_steps))
    assert seen == [25, 50, 75, 100]


def test_sampling_mode_alias():
    s = _hook_sampler(n_walkers=16, seed=6)
    s.set_sampling_mode(thin=5)
    s.run_mcmc(50)
    assert s.stored_steps == 10
    s.set_slicing_mode(use_slicing=True, slicing_interval=4)
    s.run_mcmc(20)
    assert s.stored_steps == 15
    s.set_slicing_mode(use_slicing=False)
    s.run_mcmc(3)
    assert s.stored_steps == 18
    assert s.run_mcmc(6, thin=3) and s.stored_steps == 20


def test_per_walker_acceptance():
    """Per-walker fractions (≙ tests/test_per_walker_accept.py:38-45)."""
    s = _hook_sampler(n_walkers=64, seed=5)
    s.run_mcmc(200)
    frac = s.per_walker_acceptance
    assert frac.shape == (64,)
    assert np.all((0.0 <= frac) & (frac <= 1.0))
    assert np.ptp(frac) > 0.0
    assert np.isclose(frac.mean(), s.acceptance_fraction, atol=1e-12)
    np.testing.assert_allclose(frac, s.per_walker_accepted / 200)
    s.reset()
    assert np.all(s.per_walker_acceptance == 0.0)


def test_huge_thin_micro_chunked_path():
    """A thin above the harvest cap advances in harvested runs and stores
    each row on its own (≙ tests/test_review_fixes.py:65-75), with both
    hooks."""
    s = _hook_sampler(n_walkers=16)
    s._max_steps_per_harvest = 8
    seen = []
    assert s.run_mcmc(60, thin=20, step_action=lambda pos, lp: lp.max(),
                      chunk_action=lambda chain: seen.append(chain.n_steps))
    assert s.stored_steps == 3
    assert s.total_steps == 60 * 16
    assert 0 < s.accepted_steps <= 60 * 16
    assert s.accepted_steps == s.per_walker_accepted.sum()
    samples = s.get_samples()
    assert not np.allclose(samples[0], samples[-1])
    assert seen == [1, 2, 3]
    np.testing.assert_array_equal(s.step_metrics,
                                  s.get_log_probs().max(axis=1))
    # the same draws through the pipelined path give the same chain
    t = _hook_sampler(n_walkers=16)
    assert t.run_mcmc(60, thin=20)
    np.testing.assert_array_equal(t.get_samples(), samples)
