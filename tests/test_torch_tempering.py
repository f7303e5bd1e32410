"""Parallel tempering in the port against the JAX package, on the CPU.

The ladders equal JAX's in float32. ``_swap_phase`` replays JAX's with JAX's
−Exp(1) draws bit for bit (both parities, −inf pairs, co-swapped grids: it
is selection and one product a pair). Whole PT steps replay JAX's
``_step`` with the very draws JAX made (each rung's partner shift, z and
log u re-derived from its per-rung key as ``tests/test_torch_movers.py``'s
``jax_noise`` does, the swap phase's from the swap key): positions and
logps within 1e-5 (float32, the stretch proposal and the logp in another
order), swap counts equal. The rest mirrors ``tests/test_tempering.py`` at
small sizes (K ≤ 4, H ≤ 32, P ≤ 2) and checks the port's own rules: the
ladder as one vmapped half-step equals a loop over rungs bit for bit, a
host-branching mover runs its rungs in turn, the validation errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu import tempering as jtemp
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import tempering as ttemp
from mcmcpp_tpu_torch.movers.base import stack_noise
from tests.targets import skewed_gaussian_cov, skewed_gaussian_logp
from tests.test_torch_movers import jax_noise

torch.set_num_threads(1)

TOL = 1e-5
EPS = 0.13


def t_skewed(t):
    a, b = t[0] / 2 - t[1], t[0] / 2 + t[1]
    return -0.5 * (a * a / EPS + b * b)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def jax_step_noise(j, state, power=False):
    """The draws of the JAX sampler ``j``'s ``_step`` at ``state``, in the
    port's layout: (red rungs stacked, black rungs stacked, swap or None)."""
    k, h, p = state.red.shape
    key = jax.random.fold_in(j._epoch_key, state.step)
    k_red, k_black, k_swap = jax.random.split(key, 3)

    def rungs(kk):
        return stack_noise([jax_noise(j.mover, r, h, p)
                            for r in jax.random.split(kk, k)])

    swap = None
    if (int(state.step) + 1) % j.swap_every == 0:
        kr, kb = jax.random.split(k_swap)
        swap = tuple(_t(-jax.random.exponential(kk, (k - 1, h), jnp.float32))
                     for kk in (kr, kb))
    return rungs(k_red), rungs(k_black), swap


def port_state(jstate):
    """The port's PTState from the JAX one (copies)."""
    fields = {}
    for name in ttemp.PTState._fields:
        v = getattr(jstate, name)
        if v is not None:
            fields[name] = int(v) if name == "step" else _t(v)
    return ttemp.PTState(**fields)


def assert_states(t, j, tol=TOL):
    for name in ttemp.PTState._fields:
        a, b = getattr(t, name), getattr(j, name)
        if b is None:
            assert a is None
        elif name == "step":
            assert a == int(b)
        elif name.startswith("swaps"):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                       atol=tol, err_msg=name)


def test_ladders_equal_jax_float32():
    for k, bmin in [(6, 0.05), (8, 0.01), (16, 0.005)]:
        np.testing.assert_array_equal(
            ttemp.geometric_ladder(k, beta_min=bmin).numpy(),
            np.asarray(jtemp.geometric_ladder(k, beta_min=bmin)))
    for k, c in [(4, 5.0), (12, 5.0), (7, 3.0)]:
        np.testing.assert_array_equal(ttemp.power_ladder(k, c).numpy(),
                                      np.asarray(jtemp.power_ladder(k, c)))
    b = ttemp.geometric_ladder(6, beta_min=0.05).numpy()
    assert b[0] == 1.0 and b[-1] == pytest.approx(0.05)
    assert np.all(np.diff(b) < 0)
    assert ttemp.power_ladder(5)[-1] == 0.0


def test_neighbor_diff_is_neg_inf_safe():
    s = np.array([[0.0, -np.inf, 1.0], [-np.inf, -np.inf, 2.0],
                  [-1.0, -np.inf, -np.inf]], np.float32)
    got = ttemp._neighbor_diff(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtemp._neighbor_diff(
        jnp.asarray(s))))
    assert got[0, 1] == 0.0 and np.isneginf(got[1, 2])


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_phase_replays_jax_bitwise(parity):
    """K = 5 rungs, H = 24 walkers, P = 3, with −inf scores on both sides
    of some pairs and a co-swapped extra grid; JAX's draws from its key."""
    k, h, p = 5, 24, 3
    rng = np.random.default_rng(parity)
    pos_r, pos_b = (rng.normal(size=(k, h, p)).astype(np.float32)
                    for _ in range(2))
    lp_r, lp_b, ex_r, ex_b = (
        (rng.normal(size=(k, h)) * 3).astype(np.float32) for _ in range(4))
    lp_r[1, :5] = -np.inf
    lp_r[2, 3:8] = -np.inf
    lp_b[4, ::3] = -np.inf
    betas = jtemp.geometric_ladder(k, 0.1)
    key = jax.random.key(11 + parity)
    j = jtemp._swap_phase(key, *(jnp.asarray(a) for a in (pos_r, pos_b,
                                                          lp_r, lp_b)),
                          betas, parity, score_r=jnp.asarray(ex_r),
                          score_b=jnp.asarray(ex_b),
                          extra_r=(jnp.asarray(lp_r),),
                          extra_b=(jnp.asarray(lp_b),))
    kr, kb = jax.random.split(key)
    u = [_t(-jax.random.exponential(kk, (k - 1, h), jnp.float32))
         for kk in (kr, kb)]
    t = ttemp._swap_phase(*(_t(a) for a in (pos_r, pos_b, lp_r, lp_b)),
                          _t(betas), parity, *u, score_r=_t(ex_r),
                          score_b=_t(ex_b), extra_r=(_t(lp_r),),
                          extra_b=(_t(lp_b),))
    for a, b in zip(t[:6], j[:6]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t[6][0].numpy(), np.asarray(j[6][0]))
    np.testing.assert_array_equal(t[7][0].numpy(), np.asarray(j[7][0]))
    n_acc = t[4].numpy()
    assert n_acc[parity::2].sum() > 0 and n_acc[1 - parity::2].sum() == 0
    assert t[5].dtype == torch.int32 and t[4].dtype == torch.int32


def _pair(swap_every=1, n_temps=4, w=32, seed=3):
    j = jref.ParallelTemperingSampler(skewed_gaussian_logp, w, 2,
                                      n_temps=n_temps, seed=seed,
                                      swap_every=swap_every)
    j.init_ball(np.zeros(2), scale=0.5, seed=4)
    t = mt.ParallelTemperingSampler(t_skewed, w, 2, n_temps=n_temps,
                                    swap_every=swap_every, device="cpu")
    return j, t


@pytest.mark.parametrize("swap_every", [1, 2])
def test_pt_steps_replay_jax(swap_every):
    """Four steps, each from JAX's state with JAX's draws: both parities,
    steps with and without an exchange phase."""
    j, t = _pair(swap_every)
    state = j.state
    for _ in range(4):
        noise = jax_step_noise(j, state)
        assert (noise[2] is None) == ((int(state.step) + 1) % swap_every
                                      != 0)
        new_j = j._step(state)
        new_t = t.step(port_state(state), noise)
        assert_states(new_t, new_j)
        state = new_j
    assert int(state.swaps_proposed.sum()) > 0


def test_vmapped_ladder_equals_a_loop_over_rungs():
    """The ladder as one vmapped half-step gives the bits a loop of K
    half-steps gives (the path of the host-branching movers)."""
    t = mt.ParallelTemperingSampler(t_skewed, 32, 2, n_temps=4, seed=5,
                                    device="cpu")
    t.init_ball(np.zeros(2), 0.5)
    noise = t.draw_step_noise(t.state)
    a = t.step(t.state, noise)
    t._rung_loop = True
    per_rung = tuple([tuple(x[i] for x in half) for i in range(4)]
                     for half in noise[:2])
    b = t.step(t.state, (*per_rung, noise[2]))
    for x, y in zip(a, b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)


def test_cold_chain_targets_posterior():
    """Mirror of ``test_tempering.py::test_cold_chain_targets_posterior``
    (W = 64, K = 4, swap_every 2): the β = 1 replica reproduces the skewed
    Gaussian's covariance (atol 0.15, the JAX test's) and every pair
    exchanges (rate > 0.05)."""
    s = mt.ParallelTemperingSampler(t_skewed, n_walkers=64, n_params=2,
                                    n_temps=4, seed=0, swap_every=2,
                                    device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    assert s.run_mcmc(2000)
    cov = np.cov(s.get_samples(burn_in=300, flat=True).T)
    np.testing.assert_allclose(cov, skewed_gaussian_cov(), atol=0.15)
    rates = s.swap_acceptance
    assert rates.shape == (3,) and np.all(rates > 0.05)
    assert s.get_samples().shape == (2000, 64, 2)
    np.testing.assert_allclose(
        s.get_log_probs()[-1],
        [float(skewed_gaussian_logp(x)) for x in s.get_samples()[-1]],
        rtol=1e-5, atol=1e-5)


def test_swap_counts_past_int32_read_correctly():
    """The swap counts are int64 on the device: counts past 2^31 (a run of
    ~32k steps at W = 2^17 proposes that many a pair) go on adding up, and
    ``swap_acceptance`` reads them."""
    s = mt.ParallelTemperingSampler(t_skewed, 16, 2, n_temps=3, seed=2,
                                    device="cpu")
    s.init_ball(np.zeros(2), 0.5)
    start_acc = np.array([3 << 30, 5 << 30], np.int64)
    start_prop = np.array([(1 << 33) + 7, (3 << 32) + 1], np.int64)
    s.state = s.state._replace(swaps_accepted=torch.from_numpy(start_acc),
                               swaps_proposed=torch.from_numpy(start_prop))
    assert s.run_mcmc(6, thin=3)
    acc = s.state.swaps_accepted.numpy()
    prop = s.state.swaps_proposed.numpy()
    assert s.state.swaps_accepted.dtype == torch.int64
    # six exchange phases, alternating parity: three for each pair, each
    # proposing 2h = W swaps
    np.testing.assert_array_equal(prop - start_prop, [48, 48])
    assert np.all(acc - start_acc > 0) and np.all(acc - start_acc <= 48)
    np.testing.assert_array_equal(s.swap_acceptance, acc / prop)
    assert np.all(s.swap_acceptance > 0.3)


def test_host_branching_movers_run_rung_by_rung():
    """The mixture mover (branch drawn on the host) and the slice move
    (host-tested loops) cannot run under one vmap: their rungs run in turn,
    on the same ladder."""
    for mover in (mt.MixtureMover([(mt.StretchMove(), 0.5),
                                   (mt.DifferentialEvolutionMove(), 0.5)]),
                  mt.EnsembleSliceMove()):
        s = mt.ParallelTemperingSampler(t_skewed, 16, 2, n_temps=3, seed=1,
                                        mover=mover, device="cpu")
        assert s._rung_loop
        s.init_ball(np.zeros(2), 0.5)
        assert s.run_mcmc(10, thin=2)
        assert np.isfinite(s.get_samples()).all()
        assert s.get_samples().shape == (5, 16, 2)


def test_tune_ladder_keeps_a_monotone_ladder_and_clears():
    """``tune_ladder`` on a badly spaced ladder (the slow JAX test's start,
    a few blocks): β[0] stays 1, the ladder stays monotone, the cliff pair's
    gap shrinks, and the chain and swap counts are cleared."""
    s = mt.ParallelTemperingSampler(t_skewed, 32, 2,
                                    betas=[1.0, 0.9, 0.8, 0.001], seed=3,
                                    device="cpu")
    s.init_ball(np.zeros(2), scale=0.5)
    s.tune_ladder(n_blocks=3, block_steps=20, target=0.4)
    b = s.betas.numpy().astype(np.float64)
    assert b[0] == 1.0 and np.all(np.diff(b) < 0)
    assert b[-1] > 0.001
    assert s.chain.n_steps == 0 and s.swap_acceptance.sum() == 0.0
    assert s._betas_host == [float(x) for x in s.betas]


def test_validation_mirrors_jax():
    with pytest.raises(ValueError, match="cold chain"):
        mt.ParallelTemperingSampler(t_skewed, 16, 2, betas=[0.5, 0.1],
                                    device="cpu")
    with pytest.raises(ValueError, match="even"):
        mt.ParallelTemperingSampler(t_skewed, 15, 2, device="cpu")
    with pytest.raises(TypeError, match="required"):
        mt.ParallelTemperingSampler(t_skewed, device="cpu")
    with pytest.raises(ValueError, match="improper"):
        mt.ParallelTemperingSampler(t_skewed, 16, 2,
                                    betas=mt.power_ladder(4), device="cpu")
    # the fused kernel refuses β ≠ 1 in both packages
    with pytest.raises(NotImplementedError, match="StretchMove"):
        mt.ParallelTemperingSampler(t_skewed, 16, 2,
                                    mover=mt.FusedStretchMove(),
                                    device="cpu")
    s = mt.ParallelTemperingSampler(t_skewed, 16, 2, device="cpu")
    with pytest.raises(RuntimeError, match="init_ball"):
        s.run_mcmc(2)
    with pytest.raises(RuntimeError, match="power-posterior"):
        s.reset_evidence()
    with pytest.raises(ValueError, match="geometry"):
        mt.ParallelTemperingSampler(t_skewed, 16, 2, device="cpu",
                                    chain=mt.Chain(8, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mt.ParallelTemperingSampler(t_skewed, 16, 2)


def test_inference_dict_reads_the_cold_chain():
    """``export.to_inference_dict`` takes a PT sampler: its cold chain, as
    the JAX package's docstring says."""
    s = mt.ParallelTemperingSampler(t_skewed, 16, 2, n_temps=3, seed=2,
                                    device="cpu")
    s.init_ball(np.zeros(2), 0.5)
    s.run_mcmc(12, thin=3)
    d = mt.to_inference_dict(s)
    assert d["posterior"]["theta"].shape == (16, 4, 2)
    np.testing.assert_array_equal(d["posterior"]["theta"],
                                  np.moveaxis(s.get_samples(), 0, 1))
    np.testing.assert_array_equal(d["sample_stats"]["lp"],
                                  np.moveaxis(s.get_log_probs(), 0, 1))
