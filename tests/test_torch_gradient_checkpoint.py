"""Checkpoint kinds of the gradient engines: ``gradient``, ``sgmcmc``,
``mclmc`` and ``mams``, on the CPU.

For each kind, N stored steps + save + load into a sampler built with
another seed + N steps equals the uninterrupted run bitwise: state, step
sizes, metric, ChEES's trajectory adaptation, the chain, the sample stats
and the generators. Mismatched files are refused before anything moves.
A checkpoint written by the JAX package, one of each kind, loads through
``convert.sampler_from_jax_checkpoint`` with equal state, step sizes,
metric, chain and stats, and the run goes on under the port's own seed.
Mirrors the gradient cases of ``tests/test_io.py`` and the checkpoint
tests of ``tests/test_mclmc.py``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.io import save_checkpoint as jax_save_checkpoint
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.convert import sampler_from_jax_checkpoint
from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

P, C = 4, 16
IDX = np.arange(P)
COV = 0.5 ** np.abs(IDX[:, None] - IDX[None, :])
PREC = np.linalg.inv(COV).astype(np.float32)


def logp(x):
    return -0.5 * torch.sum((x @ torch.from_numpy(PREC)) * x, dim=-1)


def j_logp(t):
    return -0.5 * t @ (jnp.asarray(PREC) @ t)


def data():
    return np.random.default_rng(0).normal(0.3, 1.0, (256, P)).astype(
        np.float32)


def logprior(t):
    return -0.5 * torch.sum(t * t, dim=-1)


def loglike(t, batch):
    return -0.5 * torch.sum((batch[None] - t[:, None]) ** 2, dim=(1, 2))


KINDS = {
    "hmc": lambda seed: mt.HMCSampler(logp, C, P, seed=seed, n_leapfrog=1,
                                      device="cpu"),
    "hmc_dense": lambda seed: mt.HMCSampler(logp, C, P, seed=seed,
                                            n_leapfrog=4, metric="dense",
                                            device="cpu"),
    "nuts": lambda seed: mt.NUTSSampler(logp, C, P, seed=seed, max_depth=4,
                                        device="cpu"),
    "chees_continuous": lambda seed: mt.CheesHMCSampler(
        logp, C, P, seed=seed, continuous_adapt=True, device="cpu"),
    "meads": lambda seed: mt.MEADSSampler(logp, C, P, seed=seed,
                                          device="cpu"),
    "sgld": lambda seed: mt.SGLDSampler(
        logprior, loglike, data(), C, P, batch_size=32, seed=seed,
        step_size=1e-3, step_size_decay=(50.0, 0.6), device="cpu"),
    "sghmc": lambda seed: mt.SGHMCSampler(
        logprior, loglike, data(), C, P, batch_size=32, seed=seed,
        step_size=1e-3, device="cpu"),
    "mclmc": lambda seed: mt.MCLMCSampler(logp, C, P, seed=seed,
                                          inv_mass=np.linspace(0.5, 2, P),
                                          device="cpu"),
    "mams": lambda seed: mt.MAMSSampler(logp, C, P, seed=seed,
                                        device="cpu"),
}
KIND_OF = {"hmc": "gradient", "hmc_dense": "gradient", "nuts": "gradient",
           "chees_continuous": "gradient", "meads": "gradient",
           "sgld": "sgmcmc", "sghmc": "sgmcmc", "mclmc": "mclmc",
           "mams": "mams"}


def _warm(s):
    if isinstance(s, mt.MCLMCSampler):
        s.tune(60)
    elif hasattr(s, "warmup"):
        s.warmup(10)


def _equal(a, b):
    for x, y in zip(a.state, b.state):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    np.testing.assert_array_equal(a.get_samples(), b.get_samples())
    np.testing.assert_array_equal(a.get_log_probs(), b.get_log_probs())
    if hasattr(a, "get_sample_stats"):
        for k, v in a.get_sample_stats().items():
            np.testing.assert_array_equal(v, b.get_sample_stats()[k])
    assert a._step_gen.get_state().equal(b._step_gen.get_state())
    for name in ("step_size", "inv_mass", "traj_length",
                 "decoherence_length"):
        x, y = getattr(a, name, None), getattr(b, name, None)
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert torch.equal(u, v)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", [k for k in KINDS if k != "hmc"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, name):
    a = KINDS[name](1)
    a.init_ball(np.zeros(P), 1.0)
    _warm(a)
    kw = ({"checkpoint_path": tmp_path / "ck"}
          if isinstance(a, mt.gradient.hmc.GradientSampler) else {})
    a.run(12, thin=2, **kw)
    if not kw:
        save_checkpoint(a, tmp_path / "ck")
    assert (tmp_path / "ck.npz").exists()
    a.run(11, thin=2)
    b = KINDS[name](9)
    b.init_ball(np.ones(P), 0.3)  # different everything
    assert load_checkpoint(b, tmp_path / "ck") is b
    with np.load(tmp_path / "ck.npz") as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["kind"] == KIND_OF[name] and meta["port"] == "torch"
    if name == "chees_continuous":
        assert b._sadapt is not None and b.traj_length is not None
    b.run(11, thin=2)
    _equal(a, b)
    assert a.get_samples().shape[0] == 11


def test_mid_run_checkpoint_is_consistent(tmp_path):
    """Snapshots written by ``checkpoint_every`` while the run goes on: the
    in-flight chunk lands first, so the chain's last row is the state."""
    s = mt.HMCSampler(logp, C, P, seed=2, n_leapfrog=2, device="cpu")
    s._store_chunk_steps = lambda: 3
    s.init_ball(np.zeros(P), 1.0)
    seen = []
    real = s.chain.append

    def spy(pos, lp):
        ok = real(pos, lp)
        if (tmp_path / "auto.npz").exists():
            with np.load(tmp_path / "auto.npz") as z:
                seen.append((z["chain_samples"].shape[0],
                             z["chain_samples"][-1].copy(),
                             z["position"].copy(),
                             z["stat_energy"].shape[0]))
        return ok

    s.chain.append = spy
    s.run(30, checkpoint_path=tmp_path / "auto.npz", checkpoint_every=2)
    assert len({rows for rows, *_ in seen}) >= 2
    for rows, last, position, n_stats in seen:
        np.testing.assert_array_equal(last, position)
        assert n_stats == rows


def _edit_meta(path, **changes):
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    meta.update(changes)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)


@pytest.mark.parametrize("writer,reader,changes,error,match", [
    ("mams", "mclmc", {}, TypeError, "MAMSSampler"),
    ("mclmc", "mams", {}, TypeError, "unadjusted"),
    ("meads", "hmc_dense", {"metric": "dense"}, TypeError, "MEADS"),
    ("hmc_dense", "nuts", {}, ValueError, "metric"),
    ("sgld", "hmc_dense", {}, TypeError, "stochastic-gradient"),
    ("nuts", "sgld", {}, TypeError, "gradient sampler"),
    ("nuts", "nuts", {"n_chains": 2 * C}, ValueError, "chain count"),
    ("nuts", "nuts", {"device": "cuda"}, ValueError, "different streams"),
], ids=["mams-into-mclmc", "mclmc-into-mams", "meads-into-hmc",
        "dense-into-diag", "sgld-into-hmc", "nuts-into-sgld", "n_chains",
        "device"])
def test_mismatches_raise(tmp_path, writer, reader, changes, error, match):
    a = KINDS[writer](1)
    a.init_ball(np.zeros(P), 1.0)
    path = save_checkpoint(a, tmp_path / "ck")
    _edit_meta(path, **changes)
    b = KINDS[reader](2)
    b.init_ball(np.zeros(P), 1.0)
    before = [x.clone() for x in b.state if isinstance(x, torch.Tensor)]
    with pytest.raises(error, match=match):
        load_checkpoint(b, path)
    after = [x for x in b.state if isinstance(x, torch.Tensor)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))


# -- JAX-written checkpoints, through convert ----------------------------------


def _jax_file(tmp_path, j):
    path = jax_save_checkpoint(j, tmp_path / "jax_ck.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


def _j_data():
    return jnp.asarray(data())


JAX_KINDS = {
    "hmc": (lambda: jref.HMCSampler(j_logp, n_chains=C, n_params=P, seed=0,
                                    n_leapfrog=1), True),
    "sgld": (lambda: jref.SGLDSampler(
        lambda t: -0.5 * jnp.sum(t * t),
        lambda t, b: -0.5 * jnp.sum((b - t[None]) ** 2), _j_data(),
        n_chains=C, n_params=P, batch_size=32, seed=0, step_size=1e-3,
        step_size_decay=(50.0, 0.6)), False),
    "mclmc": (lambda: jref.MCLMCSampler(j_logp, n_chains=C, n_params=P,
                                        seed=0, step_size=0.5,
                                        decoherence_length=2.0,
                                        inv_mass=np.linspace(0.5, 2, P)),
              False),
    "mams": (lambda: jref.MAMSSampler(j_logp, n_chains=C, n_params=P, seed=0,
                                      step_size=0.5, decoherence_length=2.0),
             False),
}


@pytest.mark.parametrize("name", list(JAX_KINDS))
def test_jax_checkpoint_loads_through_convert(tmp_path, name):
    make, warm = JAX_KINDS[name]
    j = make()
    j.init_ball(np.zeros(P), scale=1.0, seed=1)
    if warm:
        j.warmup(5)
    j.run(6, thin=2)
    arrays, meta = _jax_file(tmp_path, j)
    p = KINDS[name](3)
    assert sampler_from_jax_checkpoint(arrays, meta, p) is p
    for field in j.state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(p.state, field)),
                                      np.asarray(getattr(j.state, field)))
    np.testing.assert_array_equal(p.get_samples(), j.get_samples())
    np.testing.assert_array_equal(p.get_log_probs(), j.get_log_probs())
    if hasattr(j, "get_sample_stats"):
        for k, v in j.get_sample_stats().items():
            np.testing.assert_array_equal(p.get_sample_stats()[k], v)
        np.testing.assert_array_equal(np.asarray(p.step_size, np.float32),
                                      np.asarray(j.step_size, np.float32))
    if name == "hmc":
        np.testing.assert_array_equal(p.inv_mass.numpy(),
                                      np.asarray(j.inv_mass))
    if name in ("mclmc", "mams"):
        assert (p.step_size, p.decoherence_length) == (
            j.step_size, j.decoherence_length)
        if name == "mclmc":
            np.testing.assert_array_equal(p.inv_mass.numpy(),
                                          np.asarray(j.inv_mass))
    # the run goes on under the port's own seed
    rows = p.get_samples().shape[0]
    assert p.run(4, thin=2) and p.get_samples().shape[0] == rows + 2
    assert np.isfinite(p.get_samples()).all()


@pytest.mark.parametrize("name", ["chees_continuous", "meads", "hmc_dense"])
def test_jax_format_optional_arrays_load_through_convert(name):
    """The JAX format's optional parts of the gradient kind, laid out by
    hand as ``mcmcpp_tpu.io.save_checkpoint`` writes them (``:226-261``):
    ChEES's ``traj_length`` and ``sadapt_*``, MEADS's ``momentum``, a dense
    metric's ``inv_mass_cov`` (its factors rebuilt on the port's device)."""
    rng = np.random.default_rng(4)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    arrays = dict(position=f32(C, P), logp=f32(C), grad=f32(C, P),
                  step_size=np.asarray(0.37, np.float32),
                  inv_mass=np.abs(f32(P)) + 0.5, key=np.zeros(2, np.uint32),
                  chain_samples=f32(3, C, P), chain_logp=f32(3, C),
                  stat_diverging=np.zeros((3, C), bool),
                  stat_energy=f32(3, C))
    meta = {"format": 3, "class": "X", "kind": "gradient", "n_params": P,
            "n_chains": C, "prng_impl": "threefry2x32"}
    if name == "meads":
        arrays["momentum"] = f32(C, P)
    elif name == "hmc_dense":
        meta["metric"] = "dense"
        arrays["inv_mass_cov"] = COV.astype(np.float32)
        del arrays["inv_mass"]
    else:
        meta["traj_length"] = 1.25
        arrays.update(sadapt_log_traj=np.asarray(0.2, np.float32),
                      sadapt_m=np.asarray(0.01, np.float32),
                      sadapt_v=np.asarray(0.002, np.float32),
                      sadapt_count=np.asarray(17, np.int32))
    p = KINDS[name](5)
    sampler_from_jax_checkpoint(arrays, meta, p)
    for field in p.state._fields:
        np.testing.assert_array_equal(getattr(p.state, field).numpy(),
                                      arrays[field])
    assert p.step_size == np.float32(0.37)
    np.testing.assert_array_equal(p.get_sample_stats()["energy"],
                                  arrays["stat_energy"])
    if name == "hmc_dense":
        np.testing.assert_array_equal(p.inv_mass.cov.numpy(),
                                      arrays["inv_mass_cov"])
        np.testing.assert_allclose(
            (p.inv_mass.chol @ p.inv_mass.chol.T).numpy(), COV, atol=1e-6)
    if name == "chees_continuous":
        assert p.traj_length == 1.25
        log_traj, adam = p._sadapt
        assert float(log_traj) == np.float32(0.2) and adam.count == 17
        assert (float(adam.m), float(adam.v)) == (np.float32(0.01),
                                                  np.float32(0.002))
    assert p.run(4, thin=2) and p.get_samples().shape[0] == 5


def test_jax_legacy_mclmc_checkpoint_loads_into_mams(tmp_path):
    """A JAX file without the adjusted marker (kind "mclmc" for both
    algorithms) resumes under MAMS with a warning; kind "mams" stays
    strict."""
    j = JAX_KINDS["mams"][0]()
    j.init_ball(np.zeros(P), scale=1.0, seed=1)
    j.run(2)
    arrays, meta = _jax_file(tmp_path, j)
    legacy = {k: v for k, v in meta.items() if k != "adjusted"}
    with pytest.raises(TypeError, match="MAMSSampler"):
        sampler_from_jax_checkpoint(arrays, legacy, KINDS["mclmc"](0))
    legacy["kind"] = "mclmc"
    m = KINDS["mams"](0)
    with pytest.warns(UserWarning, match="legacy"):
        sampler_from_jax_checkpoint(arrays, legacy, m)
    assert m.run(2)
