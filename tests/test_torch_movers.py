"""Every mover and partner mode of the port replays the JAX package.

Each test runs the JAX sampler on the flagship 10-D target (Σ = 0.5·11ᵀ +
0.5·I, ``bench.py:63-73``) for 12 steps at thin 3, then the port's sampler
for the same steps from the same numpy start, with every half-step's noise
re-derived from the JAX run's keys exactly as the JAX mover splits and
draws them (``jax_noise``). Chains must agree to atol 1e-5 (float32: the
same formulas, products and sums in another order), logps to atol 1e-5 plus
rtol 1e-5 (the logp −½‖x @ L‖² sums a 10-term product in another order, so
its error grows with |logp|, which reaches ~10^2 once walkers move far from
the mode), and the per-walker accept counts must be equal.

W = 64 is the default; at W = 64 block mode takes its per-walker fallback
(m // 128 < k), so W = 1024 covers its block-granular fast path.

The harness (``jax_noise``, ``replay``) is shared with
``tests/test_torch_partner.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.ops import partner as jpartner
from mcmcpp_tpu.ops.random import split_for_step
from mcmcpp_tpu.models import rosenbrock as jm_rosenbrock
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.convert import mover_state_from_numpy
from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.partner import block_fast_path
from mcmcpp_tpu_torch.ops.random import UNIT_FLOOR

torch.set_num_threads(1)

W, P, N_STEPS, THIN = 64, 10, 12, 3
REPLAY_ATOL = 1e-5
LOGP_RTOL = 1e-5


def flagship_chol():
    cov = 0.5 * np.ones((P, P)) + 0.5 * np.eye(P)
    return np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)


def jax_flagship_logp():
    lj = jnp.asarray(flagship_chol())

    def logp(x):
        y = x @ lj
        return -0.5 * jnp.sum(y * y, axis=-1)

    return logp


def start(w, seed=0, p=P):
    return np.random.default_rng(seed).normal(size=(w, p)).astype(np.float32)


# -- JAX's draws, re-derived from a half-step key ------------------------


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _log_u(key, n):
    return _t(-jax.random.exponential(key, (n,), jnp.float32))


def jax_partner_noise(key, n, m, k, mode):
    """The draws of ``mcmcpp_tpu.ops.partner.select_partners(key, ·, n, k,
    mode)`` in the port's layout (``ops/partner.py``)."""
    if mode == "roll":
        return _t(jpartner.distinct_shifts(key, m, k), np.int32)
    if mode == "block":
        k_r, k_q = jax.random.split(key)
        if block_fast_path(n, m, k):
            r = jax.random.randint(k_r, (), 0, m)
            nb = m // jpartner.BLOCK
            return (_t([r], np.int64),
                    _t(jpartner._distinct_batch(k_q, nb, nb, k), np.int64))
        n_blocks = -(-n // jpartner.BLOCK)
        return (_t(jpartner._distinct_batch(k_q, n_blocks, m, k), np.int64),)
    # gather: gather_partners' indices, bumped by sorted insertion
    cols = []
    for t in range(k):
        j = jax.random.randint(jax.random.fold_in(key, t), (n,), 0, m - t)
        if cols:
            prev = jnp.sort(jnp.stack(cols, axis=-1), axis=-1)
            for s in range(t):
                j = j + (j >= prev[:, s]).astype(j.dtype)
        cols.append(j)
    return _t(jnp.stack(cols, axis=-1), np.int64)


def jax_noise(jmover, key, n, p):
    """One half-step's noise of the JAX mover ``jmover`` in the layout of
    the port's ``draw_noise``."""
    m = n
    f32 = jnp.float32
    if isinstance(jmover, jref.MixtureMover):
        k_sel, k_mov = jax.random.split(key)
        idx = int(jax.random.categorical(k_sel, jmover.log_weights))
        return idx, jax_noise(jmover.movers[idx], k_mov, n, p)
    if isinstance(jmover, jref.DRAMMove):
        k1, k2, ka1, ka2 = jax.random.split(key, 4)
        return (_t(jax.random.normal(k1, (n, p), f32)),
                _t(jax.random.normal(k2, (n, p), f32)),
                _log_u(ka1, n), _log_u(ka2, n))
    if isinstance(jmover, jref.EnsembleSliceMove):
        k_pair, k_h, k_u, k_shrink = jax.random.split(key, 4)
        planes = []

        def shrink_uniforms(j):
            k = k_shrink if not planes else planes[-1][0]
            while len(planes) <= j:
                k, kk = jax.random.split(k)
                planes.append((k, _t(jax.random.uniform(kk, (n,), f32))))
            return planes[j][1]

        return (jax_partner_noise(k_pair, n, m, 2, jmover.partner_mode),
                _t(jax.random.exponential(k_h, (n,), f32)),
                _t(jax.random.uniform(k_u, (n,), f32)),
                shrink_uniforms)
    kp, ka = jax.random.split(key)
    if isinstance(jmover, jref.StretchMove):
        kj, kz = jax.random.split(kp)
        prop = (jax_partner_noise(kj, n, m, 1, jmover.partner_mode),
                _t(jax.random.uniform(kz, (n,), f32)))
    elif isinstance(jmover, jref.WalkMove):
        kj, kn = jax.random.split(kp)
        s = jmover.n_samples
        prop = (jax_partner_noise(kj, n, m, s, jmover.partner_mode),
                _t(jax.random.normal(kn, (n, s), f32)))
    elif isinstance(jmover, jref.DifferentialEvolutionMove):
        kj, ku = jax.random.split(kp)
        prop = (jax_partner_noise(kj, n, m, 2, jmover.partner_mode),
                _t(jax.random.uniform(ku, (n, p), f32)))
    elif isinstance(jmover, jref.DESnookerMove):
        prop = (jax_partner_noise(kp, n, m, 3, jmover.partner_mode),)
    elif isinstance(jmover, (jref.MetropolisHastingsMove,
                             jref.AutoRegressiveMove)):
        prop = (_t(jax.random.normal(kp, (n, p), f32)),)
    elif isinstance(jmover, jref.SequenceMove):
        prop = ()
    else:
        raise TypeError(f"no noise recipe for {type(jmover).__name__}")
    return prop if jmover.always_accept else (*prop, _log_u(ka, n))


# -- whole-run replays ---------------------------------------------------


class Replayed(Mover):
    """The port's ``inner`` mover with its draws replaced by pre-drawn
    half-step noise."""

    def __init__(self, inner, noises):
        self.inner = inner
        self.always_accept = inner.always_accept
        self._noises = iter(noises)

    def init_state(self, n_params, dtype, device):
        return self.inner.init_state(n_params, dtype, device)

    def draw_noise(self, *args, **kwargs):
        return next(self._noises)

    def apply(self, *args, **kwargs):
        return self.inner.apply(*args, **kwargs)


def replay(jmover, tmover, w=W, seed=0, noise_fn=None, step_action=None,
           jax_step_action=None, targets=None):
    """Run both samplers for N_STEPS at thin THIN from the same start;
    returns (jax sampler, port sampler). ``targets``: (JAX batched logp,
    port target module, P), by default the flagship's."""
    jlogp, ttarget, p = targets or (
        jax_flagship_logp(),
        mt.GaussianTarget.from_numpy(flagship_chol(), "cpu"), P)
    j = jref.EnsembleSampler(jlogp, w, p, mover=jmover, seed=seed,
                             batched=True)
    j.set_initial_walker_pos(start(w, p=p))
    assert j.run_mcmc(N_STEPS, thin=THIN, step_action=jax_step_action)
    keys = [k for step in range(N_STEPS)
            for k in split_for_step(j._effective_step_key(), step)]
    noise_fn = noise_fn or (lambda k: jax_noise(jmover, k, w // 2, p))
    t = mt.EnsembleSampler(
        ttarget, w, p, mover=Replayed(tmover, [noise_fn(k) for k in keys]),
        batched=True, device="cpu")
    t.set_initial_walker_pos(start(w, p=p))
    assert t.run_mcmc(N_STEPS, thin=THIN, step_action=step_action)
    return j, t


def assert_same_run(j, t, atol=REPLAY_ATOL):
    w = j.n_walkers
    assert t.get_samples().shape == (N_STEPS // THIN, w, j.n_params)
    np.testing.assert_allclose(t.get_samples(), j.get_samples(), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(t.get_log_probs(), j.get_log_probs(),
                               rtol=LOGP_RTOL, atol=atol)
    np.testing.assert_array_equal(t.per_walker_accepted,
                                  j.per_walker_accepted)
    assert t.accepted_steps == j.accepted_steps
    assert t.total_steps == j.total_steps


COV = 2.38 ** 2 / P * (0.5 * np.ones((P, P)) + 0.5 * np.eye(P))

CASES = {
    "walk_roll": lambda m: m.WalkMove(6),
    "walk_gather": lambda m: m.WalkMove(6, partner_mode="gather"),
    "de_roll": lambda m: m.DifferentialEvolutionMove(),
    "snooker": lambda m: m.DESnookerMove(),
    "mh_full": lambda m: m.MetropolisHastingsMove(covariance=COV),
    "mh_diag": lambda m: m.MetropolisHastingsMove(
        covariance=np.linspace(0.2, 0.6, P), scale=0.9),
    "dram_ensemble": lambda m: m.DRAMMove(),
    "dram_static": lambda m: m.DRAMMove(covariance=COV, scale=1.5,
                                        adapt=None),
    "slice": lambda m: m.EnsembleSliceMove(),
    "mixture": lambda m: m.MixtureMover([
        (m.StretchMove(), 2.0), (m.DifferentialEvolutionMove(), 1.0),
        (m.DESnookerMove(), 1.0)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mover_replays_jax(case):
    j, t = replay(CASES[case](jref), CASES[case](mt), seed=3)
    assert_same_run(j, t)
    if case != "slice":
        assert 0 < j.accepted_steps < j.total_steps
    else:
        assert j.accepted_steps == j.total_steps


def test_autoregressive_replays_jax():
    phis = np.linspace(0.1, 0.9, P)

    def make(m):
        return m.AutoRegressiveMove(np.linspace(-1, 1, P), phis,
                                    np.linspace(0.5, 2.0, P))

    j, t = replay(make(jref), make(mt), seed=4)
    assert_same_run(j, t)
    assert t.accepted_steps == t.total_steps


def test_sequence_replays_jax():
    steps = np.linspace(0.5, 1.5, P)
    j, t = replay(jref.SequenceMove(steps), mt.SequenceMove(steps), seed=1)
    assert_same_run(j, t)
    np.testing.assert_allclose(
        t.get_samples()[-1], start(W) + N_STEPS * steps.astype(np.float32),
        rtol=1e-6)


def test_stretch_step_metrics_replay_jax():
    """step_action runs once per stored step on the device, in both
    packages, on the same ensembles."""
    j, t = replay(
        jref.StretchMove(), mt.StretchMove(), seed=5,
        step_action=lambda pos, lp: {"mean": pos.mean(dim=0),
                                     "best": lp.max()},
        jax_step_action=lambda pos, lp: {"mean": jnp.mean(pos, axis=0),
                                         "best": jnp.max(lp)})
    assert_same_run(j, t)
    assert set(t.step_metrics) == {"mean", "best"}
    assert t.step_metrics["mean"].shape == (N_STEPS // THIN, P)
    for k in ("mean", "best"):
        np.testing.assert_allclose(t.step_metrics[k], j.step_metrics[k],
                                   rtol=0, atol=REPLAY_ATOL)


def test_fused_split_path_replays_jax_interpret_on_rosenbrock():
    """FusedStretchMove on a non-Gaussian target: JAX's Pallas kernel
    traces the banana into its body (interpret mode: u = ue = 2^-25); the
    port's plain versions of the split kernels replay the whole run."""
    from mcmcpp_tpu.movers.fused import FusedStretchMove as JFused

    banana = jm_rosenbrock()
    n = W // 2
    floor = torch.full((n,), UNIT_FLOOR)

    def noise(key):
        shift = jax.random.randint(jax.random.split(key)[1], (), 0, n,
                                   dtype=jnp.int32)
        return (torch.tensor([int(shift)], dtype=torch.int32), floor,
                floor.clone())

    j, t = replay(JFused(tile=32, interpret=True), mt.FusedStretchMove(),
                  seed=8, noise_fn=noise,
                  targets=(jax.vmap(banana.logp), mt.rosenbrock(), 2))
    assert_same_run(j, t)
    assert 0 < t.accepted_steps < t.total_steps


def test_mover_state_from_numpy_matches_init_state():
    """JAX mover states carried across equal the port's own init_state."""
    cases = [
        jref.MetropolisHastingsMove(covariance=COV),
        jref.DRAMMove(covariance=COV, adapt=None),
        jref.AutoRegressiveMove(np.zeros(P), np.full(P, 0.5), np.ones(P)),
        jref.SequenceMove(np.ones(P)),
        jref.MixtureMover([jref.MetropolisHastingsMove(),
                           jref.DRAMMove()]),
    ]
    ports = [
        mt.MetropolisHastingsMove(covariance=COV),
        mt.DRAMMove(covariance=COV, adapt=None),
        mt.AutoRegressiveMove(np.zeros(P), np.full(P, 0.5), np.ones(P)),
        mt.SequenceMove(np.ones(P)),
        mt.MixtureMover([mt.MetropolisHastingsMove(), mt.DRAMMove()]),
    ]
    for jm, tm in zip(cases, ports):
        carried = mover_state_from_numpy(
            jax.tree.map(np.asarray, jm.init_state(P, jnp.float32)),
            device="cpu")
        own = tm.init_state(P, torch.float32, "cpu")
        flat_c, flat_o = jax.tree.leaves(carried), jax.tree.leaves(own)
        assert jax.tree.structure(carried) == jax.tree.structure(own)
        for a, b in zip(flat_c, flat_o):
            assert a.dtype == b.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


# -- one half-step, apply against update_half -----------------------------


@pytest.mark.parametrize("case", ["dram_ensemble", "slice", "walk_gather"])
def test_single_half_step_matches_update_half(case):
    """One ``apply`` against one JAX ``update_half`` on the same inputs
    (n = 256, P = 3): the data-dependent cases at 1e-5 before whole runs
    compound them."""
    n, p = 256, 3
    rng = np.random.default_rng(11)
    act = rng.normal(size=(n, p)).astype(np.float32)
    oth = (1.3 * rng.normal(size=(n, p))).astype(np.float32)
    prec = np.diag([1.0, 2.0, 0.5]).astype(np.float32)

    def jlogp(x):
        return -0.5 * jnp.sum((x @ prec) * x, axis=-1)

    def tlogp(x):
        return -0.5 * torch.sum((x @ torch.from_numpy(prec)) * x, dim=-1)

    jm, tm = CASES[case](jref), CASES[case](mt)
    key = jax.random.key(7)
    j_out = jm.update_half(key, jnp.asarray(act), jlogp(jnp.asarray(act)),
                           jnp.asarray(oth), jlogp,
                           jm.init_state(p, jnp.float32))
    t_act = torch.from_numpy(act)
    t_out = tm.apply(t_act, tlogp(t_act), torch.from_numpy(oth), tlogp,
                     tm.init_state(p, torch.float32, "cpu"),
                     jax_noise(jm, key, n, p))
    np.testing.assert_array_equal(t_out[2].numpy(), np.asarray(j_out[2]))
    assert 0 < int(t_out[2].sum()) <= n
    for a, b in zip(t_out[:2], j_out[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
