"""Partner selection of the port in all three modes, against the JAX
package.

- Given JAX's own draws, ``select_partners`` gathers exactly (bitwise) the
  rows that JAX's ``block_partners`` and ``gather_partners`` gather.
- Whole sampler runs in block and gather mode replay the JAX sampler (the
  harness of ``tests/test_torch_movers.py``), at W = 64 (block's per-walker
  fallback) and W = 1024 (block's fast path).
- Mirrors of the non-slow tests of ``tests/test_partner.py``, on the port's
  own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.ops import partner as jpartner
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.ops.partner import (
    block_partners,
    distinct_shifts,
    draw_partner_noise,
    rolled_partners,
    select_partners,
    sorted_insertion,
)
from tests.targets import skewed_gaussian_cov, skewed_gaussian_logp
from tests.test_torch_movers import (
    assert_same_run,
    jax_partner_noise,
    replay,
)

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# -- bitwise selection given JAX's draws ---------------------------------


@pytest.mark.parametrize("m,n,k", [(1024, 1024, 2), (64, 64, 1),
                                   (300, 300, 3)])
def test_block_selection_equals_jax(m, n, k):
    """(1024, k = 2): the fast path, (i + r + 128·q[i // 128, j]) % m
    against JAX's roll + slab gather; the others: the per-walker fallback
    (m // 128 < k, and m not a multiple of 128)."""
    other = np.random.default_rng(m).normal(size=(m, 3)).astype(np.float32)
    key = jax.random.key(k)
    want = np.asarray(jpartner.block_partners(key, jnp.asarray(other), n, k))
    noise = jax_partner_noise(key, n, m, k, "block")
    assert len(noise) == (2 if m == 1024 else 1)
    got = select_partners(torch.from_numpy(other), n, noise, "block")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
def test_gather_selection_equals_jax(k):
    m = n = 64
    other = np.random.default_rng(k).normal(size=(m, 2)).astype(np.float32)
    key = jax.random.key(10 + k)
    want = np.asarray(jpartner.gather_partners(key, jnp.asarray(other), n, k))
    noise = jax_partner_noise(key, n, m, k, "gather")
    got = select_partners(torch.from_numpy(other), n, noise, "gather")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sorted_insertion_equals_jax_given_raw_draws():
    """Sorted insertion bumps JAX's raw draws to the distinct values of
    JAX's ``_distinct_batch``."""
    key = jax.random.key(3)
    rows, bound, k = 50, 7, 4
    raw = [torch.from_numpy(np.array(jax.random.randint(
        jax.random.fold_in(key, t), (rows,), 0, bound - t)))
        for t in range(k)]
    np.testing.assert_array_equal(
        sorted_insertion(raw).numpy(),
        np.asarray(jpartner._distinct_batch(key, rows, bound, k)))


# -- whole-run replays in block and gather mode ---------------------------


@pytest.mark.parametrize("mover,mode,w", [
    ("stretch", "block", 64), ("stretch", "block", 1024),
    ("stretch", "gather", 64),
    ("de", "block", 64), ("de", "block", 1024),
])
def test_partner_mode_replays_jax(mover, mode, w):
    def make(m):
        return (m.StretchMove(partner_mode=mode) if mover == "stretch"
                else m.DifferentialEvolutionMove(partner_mode=mode))

    j, t = replay(make(jref), make(mt), w=w, seed=6)
    assert_same_run(j, t)
    assert 0 < j.accepted_steps < j.total_steps


# -- mirrors of tests/test_partner.py -------------------------------------


def test_distinct_shifts_are_distinct_and_uniform():
    m, k = 12, 5
    counts = np.zeros(m)
    gen = _gen(0)
    for _ in range(400):
        s = distinct_shifts(gen, m, k, "cpu").numpy()
        assert len(set(s.tolist())) == k
        assert s.min() >= 0 and s.max() < m
        counts[s] += 1
    freq = counts / counts.sum()
    np.testing.assert_allclose(freq, np.full(m, 1 / m), atol=0.012)


def test_distinct_shifts_k_equals_m():
    s = np.sort(distinct_shifts(_gen(0), 6, 6, "cpu").numpy())
    np.testing.assert_array_equal(s, np.arange(6))


def test_gather_partners_distinct_rows():
    other = torch.arange(40.0).reshape(8, 5)
    noise = draw_partner_noise(_gen(3), 8, 8, 3, "gather", "cpu")
    parts = select_partners(other, 8, noise, "gather")
    ids = parts[:, :, 0].numpy() / 5  # recover row index from content
    for w in range(8):
        assert len(set(ids[:, w].tolist())) == 3


def test_rolled_partners_layout():
    other = torch.arange(12.0).reshape(6, 2)
    parts = rolled_partners(other, distinct_shifts(_gen(1), 6, 2, "cpu"))
    for j in range(2):
        r = int((parts[j, 0, 0] - other[0, 0]) / 2) % 6
        np.testing.assert_array_equal(parts[j].numpy(),
                                      np.roll(other.numpy(), -r, axis=0))


def test_select_partners_bad_mode():
    with pytest.raises(ValueError, match="unknown partner mode"):
        select_partners(torch.zeros((4, 2)), 4, None, "nope")
    with pytest.raises(ValueError, match="unknown partner mode"):
        draw_partner_noise(_gen(0), 4, 4, 1, "nope", "cpu")


@pytest.mark.parametrize("mode", ["roll", "block", "gather"])
def test_stretch_moments_both_modes(mode):
    """Every pairing mode recovers the skewed-Gaussian covariance."""
    s = mt.EnsembleSampler(skewed_gaussian_logp, n_walkers=128, n_params=2,
                           seed=21, mover=mt.StretchMove(partner_mode=mode),
                           device="cpu")
    s.init_ball(np.zeros(2), scale=0.5, seed=2)
    s.run_mcmc(400, store=False)
    s.run_mcmc(3000)
    cov = np.cov(s.get_samples(flat=True).T)
    np.testing.assert_allclose(cov, skewed_gaussian_cov(), atol=0.15)
    assert 0.3 < s.acceptance_fraction < 0.9


def test_block_partners_structure():
    """Each 128-walker block applies one shift; shifts vary across blocks
    and the k shifts of any block are distinct."""
    m, p, k = 512, 3, 2
    other = torch.arange(float(m * p)).reshape(m, p)
    noise = draw_partner_noise(_gen(7), m, m, k, "block", "cpu")
    parts = select_partners(other, m, noise, "block")
    assert parts.shape == (k, m, p)
    ids = (parts[:, :, 0].numpy() / p).astype(int)          # (k, m) rows
    shifts = (ids - np.arange(m)[None, :]) % m              # (k, m)
    for j in range(k):
        per_block = shifts[j].reshape(4, 128)
        assert (per_block == per_block[:, :1]).all()
    blk = shifts[:, ::128]                                   # (k, 4)
    for g in range(4):
        assert len(set(blk[:, g].tolist())) == k
    assert len(set(shifts[0, ::128].tolist())) > 1


def test_block_partners_marginal_uniform():
    """Every walker's partner is marginally uniform over the complement."""
    m = 16
    other = torch.arange(float(m))[:, None]
    counts = np.zeros((2, m))  # walkers 0 (block 0) and 9 (block 2)
    gen = _gen(0)
    for _ in range(600):
        noise = draw_partner_noise(gen, m, m, 1, "block", "cpu", block=4)
        part = block_partners(other, m, noise, block=4)[0]
        counts[0, int(part[0, 0])] += 1
        counts[1, int(part[9, 0])] += 1
    freq = counts / counts.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(freq, 1 / m, atol=0.035)


def test_block_partners_partial_trailing_block():
    """n not a multiple of the block size still yields n rows."""
    other = torch.arange(20.0).reshape(10, 2)
    noise = draw_partner_noise(_gen(1), 10, 10, 1, "block", "cpu", block=4)
    parts = block_partners(other, 10, noise, block=4)
    assert parts.shape == (1, 10, 2)
    ids = (parts[0, :, 0].numpy() / 2).astype(int)
    assert ((ids - np.arange(10)) % 10 == (ids[0] - 0) % 10).sum() >= 4


def test_block_partners_tiny_ensemble_k_exceeds_blocks():
    """m a multiple of 128 with fewer blocks than k takes the per-walker
    fallback, and the mover path runs end to end."""
    m, p, k = 128, 2, 2
    other = torch.arange(float(m * p)).reshape(m, p)
    noise = draw_partner_noise(_gen(3), m, m, k, "block", "cpu")
    assert len(noise) == 1
    parts = select_partners(other, m, noise, "block")
    assert parts.shape == (k, m, p)
    ids = (parts[:, :, 0].numpy() / p).astype(int)
    assert (ids[0] != ids[1]).all()
    s = mt.EnsembleSampler(
        skewed_gaussian_logp, n_walkers=256, n_params=2, seed=1,
        mover=mt.DifferentialEvolutionMove(partner_mode="block"),
        device="cpu")
    s.init_ball(np.zeros(2), scale=0.5, seed=2)
    s.run_mcmc(5, store=False)
    assert s.total_steps == 5 * 256


def test_walk_move_block_mode_honored_and_unknown_rejected():
    """WalkMove honours 'block'; a misspelt mode is rejected (the port
    rejects it when the mover is built, JAX at the first step)."""
    s = mt.EnsembleSampler(
        skewed_gaussian_logp, n_walkers=512, n_params=2, seed=3,
        mover=mt.WalkMove(n_samples=4, partner_mode="block"), device="cpu")
    s.init_ball(np.zeros(2), scale=0.5, seed=4)
    s.run_mcmc(400, store=False)
    s.run_mcmc(1500)
    cov = np.cov(s.get_samples(flat=True).T)
    np.testing.assert_allclose(cov, skewed_gaussian_cov(), atol=0.2)
    with pytest.raises(ValueError, match="unknown partner mode"):
        mt.WalkMove(n_samples=4, partner_mode="rol")
