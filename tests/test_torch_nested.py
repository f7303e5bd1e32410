"""The port's nested sampler held against the JAX package.

- One iteration of each kernel replayed from the JAX package's draws,
  re-derived from the iteration's key as ``NestedSampler._build_iterate``
  splits it (the slice kernel's for every possible loop iteration): the new
  live set, the dead points and the accept or evaluation count agree to
  1e-12 in float64 (slice) and to 1e-6 in float32 (stretch: the JAX
  package's stretch kernel does not trace under x64, its int32 accept
  counter meeting an int64 sum).
- Whole iterations through ``run()`` from the same live set and draws, and a
  second ``run()`` that continues: the host ledger (log Z, log X, the
  shells' log-weights, H, ESS, ``n_calls``) agrees to 1e-12 on the equal
  dead likelihoods of the float64 slice run, and to 1e-6 in float32.
- The slice kernel's "every walker done" test every ``CHECK_EVERY``
  iterations gives the same bits as a test every iteration.
- The 2-D evidence oracles of ``tests/test_nested.py`` (stretch, slice) at
  their bounds, with the ``n_calls`` identity; ``nested_to_inference_dict``
  equals the JAX package's on the same result.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmcpp_tpu import nested as jnest
from mcmcpp_tpu.export import nested_to_inference_dict as jax_export
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch import nested as tnest

torch.set_num_threads(1)

DIM = 2
LOGZ_TRUE = DIM * (-0.5 * np.log(2 * np.pi * 5.0) - 0.5 / 5.0)
TOL = {"slice": 1e-12, "stretch": 1e-6}
DTYPES = {"slice": (jnp.float64, torch.float64),
          "stretch": (jnp.float32, torch.float32)}


def model(lib):
    """``tests/test_nested.py``: prior N(0, 4I), likelihood N(1, I)."""

    def log_prior(t):
        return -0.5 * lib.sum(t ** 2, -1) / 4.0 - DIM / 2 * np.log(
            2 * np.pi * 4.0)

    def log_like(t):
        return -0.5 * lib.sum((t - 1.0) ** 2, -1) - DIM / 2 * np.log(
            2 * np.pi)

    return log_prior, log_like


def jax_prior(key, n):
    return 2.0 * jax.random.normal(key, (n, DIM))


def torch_prior(gen, n):
    return 2.0 * torch.randn((n, DIM), generator=gen, device=gen.device)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_iteration_noise(j, key):
    """The draws of one ``j._iterate(key, ...)`` in the port's layout."""
    n, b, m, dt = j.n_live, j.batch, j.n_mcmc, j.dtype
    k_seed, k_walk = jax.random.split(key)
    seed_idx = _t(jax.random.randint(k_seed, (b,), 0, n - b)).long()
    if j.kernel == "stretch":
        u, c, lu = [], [], []
        for i in range(m):
            kz, kp, ku = jax.random.split(jax.random.fold_in(k_walk, i), 3)
            u.append(jax.random.uniform(kz, (b,), dt))
            c.append(jax.random.randint(kp, (b,), 0, n - b))
            lu.append(-jax.random.exponential(ku, (b,), dt))
        return tnest.StretchNoise(seed_idx, _t(jnp.stack(u)),
                                  _t(jnp.stack(c)).long(),
                                  _t(jnp.stack(lu)))

    z, e, u0, j_lo, su = _slice_draws(m, j.max_slice_expand,
                                      j.max_slice_shrink, dt)(
        jax.random.split(k_walk, b))  # (b, m, ...)
    return tnest.SliceNoise(
        seed_idx, _t(jnp.swapaxes(z, 0, 1)), _t(e.T), _t(u0.T),
        _t(j_lo.T).long(), _t(jnp.transpose(su, (1, 2, 0))))


@functools.lru_cache(maxsize=None)
def _slice_draws(m, cap, shrink, dt):
    """Per walker key: each direction step's draws, its shrink uniforms
    from the key chain ``ks, ku = split(ks)``."""

    def direction(k, _):
        k, kd, kh, kb, kj, ks = jax.random.split(k, 6)

        def shrink_step(ks, _):
            ks, ku = jax.random.split(ks)
            return ks, jax.random.uniform(ku, (), dt)

        _, us = jax.lax.scan(shrink_step, ks, None, length=shrink)
        return k, (jax.random.normal(kd, (DIM,), dt),
                   jax.random.exponential(kh, (), dt),
                   jax.random.uniform(kb, (), dt),
                   jax.random.randint(kj, (), 0, cap + 1), us)

    return jax.jit(jax.vmap(
        lambda k: jax.lax.scan(direction, k, None, length=m)[1]))


@functools.lru_cache(maxsize=None)
def _jax_sampler(kernel):
    """One JAX sampler per kernel for this file's replays, so its iteration
    program compiles once (``reset()`` before each use)."""
    jlp, jll = model(jnp)
    return jnest.NestedSampler(jlp, jll, jax_prior, DIM, n_live=64,
                               batch=16, n_mcmc=2, kernel=kernel, seed=1,
                               dtype=DTYPES[kernel][0])


def _pair(kernel, n_live=64, batch=16, n_mcmc=2, **kw):
    jdt, tdt = DTYPES[kernel]
    j = _jax_sampler(kernel).reset()
    j._key = jax.random.key(1)
    tlp, tll = model(torch)
    t = mt.NestedSampler(tlp, tll, torch_prior, DIM, n_live=n_live,
                         batch=batch, n_mcmc=n_mcmc, kernel=kernel,
                         dtype=tdt, batched=True, device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("kernel", ["stretch", "slice"])
def test_one_iteration_replays_jax(kernel):
    tol = TOL[kernel]
    with jax.enable_x64(kernel == "slice"):
        j, t = _pair(kernel)
        live = jax_prior(jax.random.key(3), 64).astype(j.dtype)
        jlp, jll = model(jnp)
        ll, lpp = jll(live), jlp(live)
        key = jax.random.key(4)
        noise = jax_iteration_noise(j, key)
        want = j._iterate(key, live, ll, lpp)
    got = t.iterate(_t(live), _t(ll), _t(lpp), noise)
    for name, a, b in zip(("live", "ll", "lpp", "dead", "dead_ll", "acc"),
                          want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol,
                                   atol=tol, err_msg=name)
    assert int(got[-1]) > 0


@pytest.mark.parametrize("kernel", ["stretch", "slice"])
def test_ledger_replays_jax(kernel):
    """``run(max_iters=3)`` from JAX's live set and each iteration's draws:
    the ledger and the result agree; a second ``run()`` continues in
    both."""
    tol = TOL[kernel]
    with jax.enable_x64(kernel == "slice"):
        j, t = _pair(kernel)
        key, k_init = jax.random.split(j._key)
        live0 = np.asarray(jax_prior(k_init, 64).astype(j.dtype))
        noises = []
        for _ in range(5):
            key, k_it = jax.random.split(key)
            noises.append(jax_iteration_noise(j, k_it))
        want = [j.run(max_iters=3), j.run(max_iters=2)]
    t._prior_sample = lambda gen, n: _t(live0)
    it = iter(noises)
    t.draw_noise = lambda: next(it)
    got = [t.run(max_iters=3), t.run(max_iters=2)]
    for w, g in zip(want, got):
        assert g.n_iters == w.n_iters and g.n_calls == w.n_calls
        for name in ("logz", "logz_err", "h", "ess"):
            assert getattr(g, name) == pytest.approx(getattr(w, name),
                                                     rel=tol, abs=tol), name
        for name in ("samples", "logl", "logw"):
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       rtol=tol, atol=tol, err_msg=name)
    assert t._logx == pytest.approx(j._logx, rel=1e-12)
    np.testing.assert_allclose(np.concatenate(t._dead_logw),
                               np.concatenate(j._dead_logw), rtol=tol,
                               atol=tol)


def test_slice_loop_test_interval_gives_the_same_bits(monkeypatch):
    def run():
        t = mt.NestedSampler(*model(torch), torch_prior, DIM, n_live=64,
                             batch=16, n_mcmc=2, kernel="slice", seed=5,
                             batched=True, device="cpu")
        return t.run(max_iters=4), t.host_syncs

    (every_few, syncs_few) = run()
    monkeypatch.setattr(tnest, "CHECK_EVERY", 1)
    (every_one, syncs_one) = run()
    assert syncs_one > syncs_few
    for a, b in zip(every_few, every_one):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kernel", ["stretch", "slice"])
def test_gaussian_evidence_oracle(kernel):
    """``tests/test_nested.py:32`` (stretch) and ``:166`` (slice) at their
    bounds."""
    n_mcmc = 25 if kernel == "stretch" else 4
    ns = mt.NestedSampler(*model(torch), torch_prior, DIM, n_live=500,
                          batch=125, n_mcmc=n_mcmc, seed=0, kernel=kernel,
                          batched=True, device="cpu")
    r = ns.run(dlogz=0.01)
    tol = max(3.0 * r.logz_err, 0.15)
    assert r.logz == pytest.approx(LOGZ_TRUE, abs=tol)
    assert ns.log_evidence == r.logz
    post = ns.posterior_samples(4000, seed=1)
    s2 = 1.0 / (1.0 / 4.0 + 1.0)
    np.testing.assert_allclose(post.mean(0), [s2, s2], atol=0.1)
    if kernel == "stretch":
        np.testing.assert_allclose(post.var(0), [s2, s2], atol=0.15)
        assert r.n_calls == 500 + r.n_iters * 125 * 25
    else:
        assert r.n_calls > 500
    assert np.exp(r.logw).sum() == pytest.approx(1.0, abs=1e-6)
    assert 0 < r.ess <= r.samples.shape[0]
    assert r.h > 0
    # the exporter: the JAX package's on the same result
    got = mt.nested_to_inference_dict(ns, n_draws=300, seed=2)
    want = jax_export(jnest.NestedResult(*r), n_draws=300, seed=2)
    for group in ("posterior", "sample_stats"):
        assert got[group].keys() == want[group].keys()
        for k in got[group]:
            np.testing.assert_array_equal(got[group][k], want[group][k])


def test_validation():
    lp, ll = model(torch)
    with pytest.raises(ValueError, match="unknown kernel"):
        mt.NestedSampler(lp, ll, torch_prior, DIM, kernel="rejection",
                         device="cpu")
    with pytest.raises(ValueError, match="batch"):
        mt.NestedSampler(lp, ll, torch_prior, DIM, n_live=10, batch=10,
                         device="cpu")
    ns = mt.NestedSampler(lp, ll, torch_prior, DIM, device="cpu")
    with pytest.raises(RuntimeError, match="run"):
        ns.posterior_samples()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mt.NestedSampler(lp, ll, torch_prior, DIM)
