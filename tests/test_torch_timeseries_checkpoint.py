"""The time-series engines' checkpoint kinds: ``pmmh``, ``ibis`` and
``smc2``.

- A port checkpoint resumes bit for bit: save mid-run, load into a fresh
  sampler built with another seed, go on with both, and the states, chains
  and traces are equal (SMC² after the exchange step has grown Nx too).
- ``allow_device_change=True`` takes a file written on the other device
  type (the generators reseeded), as for the other kinds.
- A file written by the JAX package loads the same state through
  ``convert.sampler_from_jax_checkpoint`` (the chain, the observation
  buffers, the counters), and the run goes on.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu_torch as mt
from mcmcpp_tpu import IBISSampler as JIBIS
from mcmcpp_tpu import PMMHSampler as JPMMH
from mcmcpp_tpu import SMC2Sampler as JSMC2
from mcmcpp_tpu import StateSpaceModel as JSSM
from mcmcpp_tpu.io import checkpoint as jck
from mcmcpp_tpu_torch.convert import sampler_from_jax_checkpoint
from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

SIG_Q, M0, P0 = 0.35, 1.0, 2.0
LOG2PI = np.log(2 * np.pi)


def _ys(t_n, seed=0):
    rng = np.random.default_rng(seed)
    x = M0 + np.cumsum(SIG_Q * rng.standard_normal(t_n))
    return (x + 0.6 * rng.standard_normal(t_n)).astype(np.float32)


def _ssm():
    def obs(y, x, t, th):
        s = torch.exp(th[0])
        z = (y[0] - x[:, 0]) / s
        return -0.5 * z * z - th[0] - 0.5 * LOG2PI

    return mt.StateSpaceModel(
        lambda g, n, th: M0 + np.sqrt(P0) * torch.randn((n, 1), generator=g),
        lambda g, x, t, th: x + SIG_Q * torch.randn(x.shape, generator=g),
        obs)


def _jssm():
    def obs(y, x, t, th):
        s = jnp.exp(th[0])
        z = (y[0] - x[:, 0]) / s
        return -0.5 * z * z - th[0] - 0.5 * LOG2PI

    return JSSM(lambda k, n, th: M0 + np.sqrt(P0) * jax.random.normal(
        k, (n, 1)), lambda k, x, t, th: x + SIG_Q * jax.random.normal(
        k, x.shape), obs)


def _pmmh(seed, ys):
    return mt.PMMHSampler(_ssm(), ys, lambda th: -0.5 * th[0] ** 2, 1,
                          n_particles=32, proposal_scale=0.3, n_chains=8,
                          seed=seed, device="cpu")


def _ibis(seed, batch_size=4, n=256):
    return mt.IBISSampler(
        lambda t: -0.5 * t[0] ** 2 / 4.0, lambda t, y: -0.5 * (y - t[0]) ** 2,
        lambda g, m: 2.0 * torch.randn((m, 1), generator=g), n, 1,
        batch_size=batch_size, seed=seed, device="cpu")


def _smc2(seed, **kw):
    return mt.SMC2Sampler(_ssm(), lambda th: -0.5 * th[0] ** 2,
                          lambda g, n: torch.randn((n, 1), generator=g),
                          n_theta=64, n_params=1, seed=seed, device="cpu",
                          **kw)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pmmh_resumes_bitwise_and_across_devices(tmp_path):
    ys = _ys(20)
    a = _pmmh(0, ys)
    a.init(np.zeros((8, 1)))
    a.tune(20, window=10)
    a.run(6)
    path = save_checkpoint(a, tmp_path / "pmmh.npz")
    b = _pmmh(5, ys)
    load_checkpoint(b, path)
    assert torch.equal(b._prop_chol, a._prop_chol)
    a.run(5)
    b.run(5)
    _same(a.state, b.state)
    np.testing.assert_array_equal(a.get_samples(), b.get_samples())
    np.testing.assert_array_equal(a.get_log_probs(), b.get_log_probs())
    np.testing.assert_array_equal(a.acceptance_fraction,
                                  b.acceptance_fraction)
    # a file of the other device type: refused, then taken on request
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    meta["device"] = "cuda"
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    for name in ("step", "aux"):
        payload[f"rng_{name}"] = np.arange(16, dtype=np.uint8)
    np.savez(path, **payload)
    c = _pmmh(1, ys)
    with pytest.raises(ValueError, match="different streams"):
        load_checkpoint(c, path)
    load_checkpoint(c, path, allow_device_change=True)
    assert c.run(3) and c.get_samples().shape == (9, 8, 1)
    with pytest.raises(ValueError, match="chain count"):
        load_checkpoint(mt.PMMHSampler(_ssm(), ys, lambda th: 0.0 * th[0], 1,
                                       n_chains=4, device="cpu"),
                        path, allow_device_change=True)


def test_ibis_resumes_bitwise_with_array_and_dict_data(tmp_path):
    ys = _ys(40, seed=9)
    a = _ibis(0)
    a.update(ys[:20])
    path = save_checkpoint(a, tmp_path / "ibis.npz")
    b = _ibis(7)
    load_checkpoint(b, path)
    a.update(ys[20:])
    b.update(ys[20:])
    _same(a.state, b.state)
    assert a.log_evidence_trace == b.log_evidence_trace
    assert a.n_resamples == b.n_resamples
    with pytest.raises(ValueError, match="particle count"):
        load_checkpoint(_ibis(0, n=128), path)
    with pytest.raises(ValueError, match="batch_size"):
        load_checkpoint(_ibis(0, batch_size=2), path)

    rng = np.random.default_rng(2)
    X = rng.standard_normal((20, 2)).astype(np.float32)
    y = (X @ np.array([1.0, -0.5])).astype(np.float32)

    def build(seed):
        return mt.IBISSampler(
            lambda t: -0.5 * torch.sum(t * t),
            lambda t, row: -0.5 * (row["y"] - torch.dot(row["x"], t)) ** 2
            / 0.25, lambda g, m: torch.randn((m, 2), generator=g), 256, 2,
            batch_size=4, seed=seed, device="cpu")

    a = build(0)
    a.update({"x": X[:12], "y": y[:12]})
    path = save_checkpoint(a, tmp_path / "ibis2.npz")
    b = build(5)
    load_checkpoint(b, path)
    a.update({"x": X[12:], "y": y[12:]})
    b.update({"x": X[12:], "y": y[12:]})
    _same(a.state, b.state)


def test_smc2_resumes_bitwise_after_growth_and_refuses_early_save(tmp_path):
    ys = _ys(30, seed=31)
    a = _smc2(6, n_particles=2, grow_particles=True, grow_threshold=0.4,
              max_particles=16)
    a.update(ys[:14])
    assert a.n_growths >= 1
    path = save_checkpoint(a, tmp_path / "smc2.npz")
    b = _smc2(999, n_particles=2, grow_particles=True, grow_threshold=0.4,
              max_particles=16)
    load_checkpoint(b, path)
    assert b.n_x == a.n_x and b.n_growths == a.n_growths
    a.update(ys[14:])
    b.update(ys[14:])
    _same(a.state, b.state)
    assert a.log_evidence_trace == b.log_evidence_trace
    with pytest.raises(ValueError, match="theta-particle count"):
        load_checkpoint(mt.SMC2Sampler(_ssm(), lambda th: 0.0 * th[0],
                                       None, n_theta=32, n_params=1,
                                       device="cpu"), path)
    early = _smc2(0)
    early.init()
    with pytest.raises(RuntimeError, match="before update"):
        save_checkpoint(early, tmp_path / "early.npz")


def _jax_file(sampler, path):
    jck.save_checkpoint(sampler, path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


def test_jax_files_load_through_convert(tmp_path):
    ys = _ys(16, seed=4)
    j = JPMMH(_jssm(), ys, lambda th: -0.5 * th[0] ** 2, 1, n_particles=32,
              proposal_scale=0.3, n_chains=8)
    j.init(np.zeros((8, 1), np.float32))
    j.run(4)
    arrays, meta = _jax_file(j, tmp_path / "jpmmh.npz")
    p = sampler_from_jax_checkpoint(arrays, meta, _pmmh(0, ys))
    np.testing.assert_array_equal(p.state.position.numpy(),
                                  np.asarray(j.state.position))
    np.testing.assert_array_equal(p.state.accepted.numpy(),
                                  np.asarray(j.state.accepted))
    np.testing.assert_array_equal(p._prop_chol.numpy(),
                                  np.asarray(j._prop_chol))
    np.testing.assert_array_equal(p.get_samples(), np.asarray(j.get_samples()))
    assert p._n_steps_done == j._n_steps_done and p.run(2)

    ji = JIBIS(lambda t: -0.5 * t[0] ** 2 / 4.0,
               lambda t, y: -0.5 * (y - t[0]) ** 2,
               lambda k, m: 2.0 * jax.random.normal(k, (m, 1)), 256, 1,
               batch_size=4)
    ji.update(ys)
    arrays, meta = _jax_file(ji, tmp_path / "jibis.npz")
    ti = sampler_from_jax_checkpoint(arrays, meta, _ibis(0))
    for name in ti.state._fields:
        np.testing.assert_array_equal(getattr(ti.state, name).numpy(),
                                      np.asarray(getattr(ji.state, name)))
    np.testing.assert_array_equal(ti._data.numpy(), np.asarray(ji._data))
    assert ti.log_evidence_trace == pytest.approx(ji.log_evidence_trace)
    assert ti.n_resamples == ji.n_resamples
    ti.update(_ys(8, seed=5))
    assert len(ti.log_evidence_trace) == 6

    js = JSMC2(_jssm(), lambda th: -0.5 * th[0] ** 2,
               lambda k, n: jax.random.normal(k, (n, 1)), n_theta=64,
               n_params=1, n_particles=16)
    js.update(ys)
    arrays, meta = _jax_file(js, tmp_path / "jsmc2.npz")
    ts = sampler_from_jax_checkpoint(arrays, meta, _smc2(0, n_particles=4))
    assert ts.n_x == 16
    for name in ts.state._fields:
        np.testing.assert_array_equal(getattr(ts.state, name).numpy(),
                                      np.asarray(getattr(js.state, name)))
    np.testing.assert_array_equal(ts._ys.numpy(), np.asarray(js._ys))
    ts.update(_ys(4, seed=6))
    assert len(ts.log_evidence_trace) == 20
    with pytest.raises(TypeError, match="IBISSampler"):
        sampler_from_jax_checkpoint(arrays, dict(meta, kind="ibis"),
                                    _smc2(0))
