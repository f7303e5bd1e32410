"""Checkpoint and resume of the port's ensemble sampler, on the CPU.

N steps + save + load into a fresh sampler + N steps equals 2N uninterrupted,
bitwise, for ``StretchMove``, ``FusedStretchMove`` (the CPU's planes path) and
the mixture (whose branch comes from the host generator), with the in-memory
chain, a ``DiskChain`` and a bfloat16 store. A checkpoint taken mid-run by
``checkpoint_every`` is consistent, every mismatch raises, and a checkpoint
written by the JAX package's sampler loads through
``convert.sampler_from_jax_checkpoint`` with equal walkers, logps, counters
and chain. Mirrors the ensemble cases of ``tests/test_io.py`` and
``tests/test_store_dtype.py``.
"""

import json

import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.io import save_checkpoint as jax_save_checkpoint
from mcmcpp_tpu_torch import (
    DESnookerMove,
    EnsembleSampler,
    FusedStretchMove,
    MixtureMover,
    StretchMove,
    WalkMove,
    equicorrelated_gaussian,
    skewed_gaussian,
)
from mcmcpp_tpu_torch.chain_disk import DiskChain
from mcmcpp_tpu_torch.convert import sampler_from_jax_checkpoint
from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint
from tests.targets import skewed_gaussian_logp

torch.set_num_threads(1)

W, P = 32, 4
MOVERS = {
    "stretch": StretchMove,
    "fused": FusedStretchMove,
    "mixture": lambda: MixtureMover([(StretchMove(), 0.4), (WalkMove(), 0.3),
                                     (DESnookerMove(), 0.3)]),
}
CHAINS = {
    "memory": lambda d, tag: {},
    "disk": lambda d, tag: {"chain": DiskChain(d / f"spool_{tag}", W, P)},
    "bf16": lambda d, tag: {"store_dtype": torch.bfloat16},
    "disk_bf16": lambda d, tag: {
        "store_dtype": torch.bfloat16,
        "chain": DiskChain(d / f"spool_{tag}", W, P, dtype="bfloat16")},
}


def _sampler(mover, seed, **kw):
    return EnsembleSampler(equicorrelated_gaussian(P, device="cpu"), W, P,
                           mover=mover, seed=seed, batched=True, device="cpu",
                           store_chunk_steps=4, **kw)


def _equal_samplers(a, b):
    for x, y in zip(a.state[:6], b.state[:6]):
        assert torch.equal(x, y)
    assert a.state.step == b.state.step
    assert a.total_steps == b.total_steps
    assert a.accepted_steps == b.accepted_steps
    np.testing.assert_array_equal(a.per_walker_accepted,
                                  b.per_walker_accepted)
    np.testing.assert_array_equal(a.chain.get(held=True),
                                  b.chain.get(held=True))
    np.testing.assert_array_equal(a.chain.get_logp(held=True),
                                  b.chain.get_logp(held=True))
    np.testing.assert_array_equal(a.get_samples(), b.get_samples())


@pytest.mark.parametrize("chain_kind", list(CHAINS))
@pytest.mark.parametrize("mover_kind", list(MOVERS))
def test_resume_equals_uninterrupted_bitwise(tmp_path, mover_kind, chain_kind):
    n, thin = 30, 3
    a = _sampler(MOVERS[mover_kind](), 1, **CHAINS[chain_kind](tmp_path, "a"))
    a.init_ball(np.zeros(P), 1.0)
    a.run_mcmc(7, store=False)
    a.run_mcmc(n, thin=thin, checkpoint_path=tmp_path / "ck")
    assert (tmp_path / "ck.npz").exists()  # the suffix rule
    a.run_mcmc(n, thin=thin)

    b = _sampler(MOVERS[mover_kind](), 99,
                 **CHAINS[chain_kind](tmp_path, "b"))
    b.init_ball(np.ones(P), 0.3)  # different everything
    b.run_mcmc(5)
    assert load_checkpoint(b, tmp_path / "ck") is b
    assert b.stored_steps == n // thin and b.state.step == 7 + n
    b.run_mcmc(n, thin=thin)
    _equal_samplers(a, b)
    assert a.stored_steps == 2 * (n // thin)
    assert a.chain.dtype.name == (
        "bfloat16" if "bf16" in chain_kind else "float32")


def test_explicit_save_after_reset_and_leftover_steps(tmp_path):
    """reset() moves the step base and clears the host counters; a run whose
    length is no multiple of thin ends on unstored steps. Both survive."""
    a = _sampler(FusedStretchMove(), 3)
    a.init_ball(np.zeros(P), 1.0)
    a.run_mcmc(20)
    a.reset()
    a.run_mcmc(23, thin=5)
    path = save_checkpoint(a, tmp_path / "deep" / "dir" / "ck.npz")
    assert path == tmp_path / "deep" / "dir" / "ck.npz"
    assert not list(path.parent.glob("*.tmp*"))  # atomic replace, no debris
    a.run_mcmc(11, thin=2)
    b = _sampler(FusedStretchMove(), 4)
    load_checkpoint(b, path)
    assert b.total_steps == 23 * W and b.stored_steps == 4
    b.run_mcmc(11, thin=2)
    _equal_samplers(a, b)


def test_init_ball_after_load_draws_the_same_ball(tmp_path):
    """The auxiliary generator is part of the checkpoint."""
    a = _sampler(StretchMove(), 5)
    a.init_ball(np.zeros(P), 1.0)
    save_checkpoint(a, tmp_path / "ck")
    b = _sampler(StretchMove(), 6)
    load_checkpoint(b, tmp_path / "ck")
    a.init_ball(np.zeros(P), 1.0)
    b.init_ball(np.zeros(P), 1.0)
    assert torch.equal(a.current_positions, b.current_positions)


def test_mid_run_checkpoint_is_consistent(tmp_path):
    """Snapshots written by ``checkpoint_every`` while the run goes on: the
    in-flight chunk is landed first, so state step == stored rows × thin and
    the chain's last row is the state."""
    thin, seen = 2, []
    s = _sampler(StretchMove(), 7)
    s.init_ball(np.zeros(P), 1.0)

    def after_chunk(chain):
        if (tmp_path / "auto.npz").exists():
            with np.load(tmp_path / "auto.npz") as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                seen.append((int(z["step"]), z["chain_samples"].shape[0],
                             z["chain_samples"][-1].copy(), z["red"].copy(),
                             z["black"].copy(), meta))

    s.run_mcmc(44, thin=thin, checkpoint_path=tmp_path / "auto.npz",
               checkpoint_every=2, chunk_action=after_chunk)
    assert len({step for step, *_ in seen}) >= 2  # several distinct saves
    for step, rows, last, red, black, meta in seen:
        assert step == rows * thin and rows < 22
        np.testing.assert_array_equal(last, np.concatenate([red, black]))
        assert meta["kind"] == "ensemble" and meta["port"] == "torch"
        assert meta["class"] == "EnsembleSampler" and meta["device"] == "cpu"
    # the final snapshot holds the whole run and resumes
    r = _sampler(StretchMove(), 8)
    load_checkpoint(r, tmp_path / "auto.npz")
    assert r.stored_steps == 22 and r.state.step == 44
    assert r.run_mcmc(10) is True and r.stored_steps == 32


def test_archive_has_no_pickles_and_the_documented_names(tmp_path):
    s = _sampler(FusedStretchMove(), 9, store_dtype=torch.bfloat16)
    s.init_ball(np.zeros(P), 1.0)
    s.run_mcmc(8, thin=2)
    path = save_checkpoint(s, tmp_path / "ck")
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert z["chain_samples"].dtype == np.int16  # raw bits
        assert z["chain_samples"].shape == (4, W, P)
        for g in ("rng_step", "rng_aux", "rng_host"):
            assert z[g].dtype == np.uint8 and z[g].ndim == 1
    assert names == {"red", "black", "logp_red", "logp_black",
                     "accepted_red", "accepted_black", "step",
                     "accepted_walkers_host", "chain_samples", "chain_logp",
                     "rng_step", "rng_aux", "rng_host", "__meta__"}
    assert meta["chain_dtype"] == meta["chain_logp_dtype"] == "bfloat16"
    assert meta["reset_step_base"] == 0 and meta["n_walkers"] == W


def _edit_meta(path, **changes):
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    for k, v in changes.items():
        if v is None:
            meta.pop(k, None)
        else:
            meta[k] = v
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)


@pytest.mark.parametrize("changes,error,match", [
    ({"n_walkers": 2 * W}, ValueError, "walker count"),
    ({"n_params": P + 1}, ValueError, "n_params"),
    ({"format": 2}, ValueError, "incompatible checkpoint format"),
    ({"device": "cuda"}, ValueError, "different streams"),
    ({"kind": "gradient"}, TypeError, "gradient sampler"),
    ({"kind": "pt"}, TypeError, "ParallelTemperingSampler"),
    ({"kind": "smc2"}, NotImplementedError, "A11"),
    ({"kind": "mystery"}, ValueError, "unknown checkpoint kind"),
    ({"port": None}, ValueError, "sampler_from_jax_checkpoint"),
], ids=["n_walkers", "n_params", "format", "device", "kind-gradient",
        "kind-pt", "kind-smc2", "kind-unknown", "no-port-marker"])
def test_mismatches_raise(tmp_path, changes, error, match):
    s = _sampler(StretchMove(), 10)
    s.init_ball(np.zeros(P), 1.0)
    s.run_mcmc(4)
    path = save_checkpoint(s, tmp_path / "ck.npz")
    before = [t.clone() for t in s.state[:6]]
    _edit_meta(path, **changes)
    with pytest.raises(error, match=match):
        load_checkpoint(s, path)
    for x, y in zip(before, s.state[:6]):  # a refused load changes nothing
        assert torch.equal(x, y)


def test_file_from_the_card_opens_on_the_cpu_by_opt_in(tmp_path):
    """A checkpoint whose meta says ``cuda`` (its step and auxiliary
    generator states a CUDA generator's 16 bytes, which a CPU generator
    cannot take) is refused by default and loads with
    ``allow_device_change=True``: state, counters and chain as written, the
    host generator restored, the device generators reseeded from the saved
    states, so the run goes on deterministically (not bitwise: the card
    would have drawn other numbers)."""
    a = _sampler(StretchMove(), 12)
    a.init_ball(np.zeros(P), 1.0)
    a.run_mcmc(6)
    path = save_checkpoint(a, tmp_path / "ck.npz")
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    for name in ("step", "aux"):  # a CUDA generator's (seed, offset)
        payload[f"rng_{name}"] = np.arange(16, dtype=np.uint8) + len(name)
    np.savez(path, **payload)
    _edit_meta(path, device="cuda")
    b = _sampler(StretchMove(), 99)
    b.init_ball(np.zeros(P), 1.0)
    with pytest.raises(ValueError, match="allow_device_change"):
        load_checkpoint(b, path)
    runs = []
    for seed in (99, 98):
        b = _sampler(StretchMove(), seed)
        load_checkpoint(b, path, allow_device_change=True)
        _equal_samplers(a, b)
        assert torch.equal(b._host_gen.get_state(), a._host_gen.get_state())
        b.run_mcmc(5)
        runs.append(b.get_samples())
    a.run_mcmc(5)
    # deterministic for the file, whatever the new sampler's seed ...
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.isfinite(runs[0]).all() and runs[0].shape == (11, W, P)
    # ... and not the run the writer's generators would have drawn
    assert not np.array_equal(runs[0][6:], a.get_samples()[6:])


def test_uninitialised_and_foreign_samplers_raise(tmp_path):
    s = _sampler(StretchMove(), 11)
    with pytest.raises(RuntimeError, match="uninitialized"):
        save_checkpoint(s, tmp_path / "ck")
    with pytest.raises(TypeError, match="unsupported sampler type"):
        save_checkpoint(object(), tmp_path / "ck")
    s.init_ball(np.zeros(P), 1.0)
    path = save_checkpoint(s, tmp_path / "ck")
    with pytest.raises(TypeError, match="EnsembleSampler"):
        load_checkpoint(type("NotASampler", (), {"n_params": P})(), path)


def _jax_run(tmp_path, **kw):
    j = jref.EnsembleSampler(skewed_gaussian_logp, n_walkers=16, n_params=2,
                             seed=0, **kw)
    j.init_ball(np.zeros(2), scale=0.3, seed=1)
    j.run_mcmc(20)
    j.reset()
    j.run_mcmc(37, thin=3)
    path = jax_save_checkpoint(j, tmp_path / "jax_ck.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return j, path, arrays, meta


def _port_sampler(**kw):
    return EnsembleSampler(skewed_gaussian(device="cpu"), 16, 2, seed=3,
                           batched=True, device="cpu", **kw)


@pytest.mark.parametrize("store", [None, "bfloat16"])
def test_jax_checkpoint_loads_through_convert(tmp_path, store):
    import jax.numpy as jnp

    kw = {} if store is None else {"store_dtype": jnp.bfloat16}
    j, path, arrays, meta = _jax_run(tmp_path, **kw)
    p = _port_sampler(**({} if store is None
                         else {"store_dtype": torch.bfloat16}))
    assert sampler_from_jax_checkpoint(arrays, meta, p) is p
    for field in ("red", "black", "logp_red", "logp_black", "accepted_red",
                  "accepted_black"):
        np.testing.assert_array_equal(getattr(p.state, field).numpy(),
                                      np.asarray(getattr(j.state, field)))
    assert p.state.step == int(j.state.step) == 57
    assert p.total_steps == j.total_steps == 37 * 16
    assert p.accepted_steps == j.accepted_steps
    assert p.acceptance_fraction == j.acceptance_fraction
    np.testing.assert_array_equal(p.per_walker_accepted,
                                  j.per_walker_accepted)
    np.testing.assert_array_equal(p.get_samples(), j.get_samples())
    np.testing.assert_array_equal(p.get_log_probs(), j.get_log_probs())
    assert p.stored_steps == 12
    # the run goes on under the port's own seed, on the same target
    assert p.run_mcmc(30, thin=3) and p.stored_steps == 22
    assert p.total_steps == (37 + 30) * 16
    assert np.isfinite(p.get_samples()).all()
    np.testing.assert_allclose(
        p.get_log_probs()[-1],
        [float(skewed_gaussian_logp(x)) for x in p.get_samples()[-1]],
        rtol=2e-2 if store else 1e-5, atol=2e-2 if store else 1e-5)


def test_neither_package_takes_the_others_file(tmp_path):
    j, jax_path, arrays, meta = _jax_run(tmp_path)
    p = _port_sampler()
    with pytest.raises(ValueError, match="sampler_from_jax_checkpoint"):
        load_checkpoint(p, jax_path)
    p.init_ball(np.zeros(2), 0.3)
    p.run_mcmc(5)
    port_path = save_checkpoint(p, tmp_path / "port_ck.npz")
    with pytest.raises(ValueError, match="incompatible checkpoint format"):
        jref.io.load_checkpoint(j, port_path)
    with np.load(port_path, allow_pickle=False) as z:
        port_meta = json.loads(bytes(z["__meta__"]).decode())
    with pytest.raises(ValueError, match="load_checkpoint"):
        sampler_from_jax_checkpoint(arrays, port_meta, p)
    with pytest.raises(ValueError, match="only the ensemble"):
        sampler_from_jax_checkpoint(arrays, dict(meta, kind="pmmh"), p)
    with pytest.raises(TypeError, match="SMCSampler"):
        sampler_from_jax_checkpoint(arrays, dict(meta, kind="smc"), p)
    with pytest.raises(TypeError, match="ParallelTemperingSampler"):
        sampler_from_jax_checkpoint(arrays, dict(meta, kind="pt"), p)
    with pytest.raises(TypeError, match="gradient sampler"):
        sampler_from_jax_checkpoint(arrays, dict(meta, kind="gradient"), p)
    with pytest.raises(ValueError, match="walker count"):
        sampler_from_jax_checkpoint(arrays, dict(meta, n_walkers=32), p)
    with pytest.raises(ValueError, match="n_params"):
        sampler_from_jax_checkpoint(arrays, dict(meta, n_params=3), p)
