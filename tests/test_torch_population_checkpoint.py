"""Checkpoint kinds of the population engines: ``pt`` (logp and power
mode), ``pcn``, ``elliptical`` and ``gibbs``, on the CPU.

For each kind, N stored steps + save + load into a sampler built with
another seed + N steps equals the uninterrupted run bitwise: the state (the
replica grids, the step, the swap counters on the device and the host, the
tuned ladder, the evidence accumulators; pCN's accept counters, steps and
tuned β; every Gibbs block), the chain and the generators. Mismatched files
are refused before anything moves. A checkpoint written by the JAX package,
one of each kind, loads through ``convert.sampler_from_jax_checkpoint``
with equal state and chain, and the run goes on under the port's own seed.
Mirrors the checkpoint cases of ``tests/test_pcn.py`` and the population
kinds of ``tests/test_io.py``.
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

P = 3
PREC = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 1.5]],
                np.float32)
CHOL = np.linalg.cholesky(np.linalg.inv(PREC)).astype(np.float32)
Y = np.array([0.4, -0.9, 1.3], np.float32)


def logp(t):
    return -0.5 * t @ (torch.from_numpy(PREC) @ t)


def j_logp(t):
    return -0.5 * t @ (jnp.asarray(PREC) @ t)


def loglike(t):
    return -0.5 * torch.sum((torch.from_numpy(Y) - t) ** 2) / 0.5


def j_loglike(t):
    return -0.5 * jnp.sum((jnp.asarray(Y) - t) ** 2) / 0.5


def logprior(t):
    return -0.5 * torch.sum(t * t)


def j_logprior(t):
    return -0.5 * jnp.sum(t * t)


def _gibbs_blocks(pkg, mod):
    def x_logp(x, o):
        return -0.5 * mod.sum(x * x) - 0.2 * mod.sum(o["z"]) * x[0]

    def z_like(z, o):
        return -0.5 * mod.sum((z - o["x"].sum()) ** 2)

    return [("x", 2, pkg.MALAKernel(x_logp, 0.5)),
            ("z", 3, pkg.EllipticalSliceKernel(z_like,
                                               prior_scale=np.ones(3)))]


def make(kind, seed):
    if kind == "pt":
        return mt.ParallelTemperingSampler(logp, 16, P, n_temps=3, seed=seed,
                                           swap_every=2, device="cpu")
    if kind == "pt_power":
        return mt.ParallelTemperingSampler(
            loglike_fn=loglike, logprior_fn=logprior, n_walkers=16,
            n_params=P, betas=mt.power_ladder(4), seed=seed, device="cpu")
    if kind == "pcn":
        return mt.PCNSampler(loglike, prior_mean=np.zeros(P),
                             prior_chol=CHOL, beta=1.0, n_chains=8, seed=seed,
                             device="cpu")
    if kind == "elliptical":
        return mt.EllipticalSliceSampler(loglike, prior_mean=np.zeros(P),
                                         prior_chol=CHOL, n_chains=8,
                                         seed=seed, device="cpu")
    from mcmcpp_tpu_torch import gibbs as tg

    return mt.BlockedGibbsSampler(
        _gibbs_blocks(tg, torch), n_chains=8, seed=seed, device="cpu",
        logp_fn=lambda v: -0.5 * torch.sum(v["x"] ** 2))


def start(s, kind):
    if kind.startswith("pt"):
        s.init_ball(np.zeros(P), 0.5)
    elif kind == "gibbs":
        s.init({"x": np.zeros(2), "z": np.ones(3)})
    else:
        s.init_prior()
        if kind == "pcn":
            s.tune(n_steps=40, window=10)  # the tuned β travels


def run(s, kind, n):
    if kind.startswith("pt"):
        return s.run_mcmc(n, thin=2)
    return s.run(n, thin=2)


def state_tensors(s):
    state = s.state
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return [x for x in state if isinstance(x, torch.Tensor)]


def assert_same(a, b, kind):
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.get_samples(), b.get_samples())
    np.testing.assert_array_equal(a.chain.get_logp(), b.chain.get_logp())
    if kind.startswith("pt"):
        assert a.state.step == b.state.step
        np.testing.assert_array_equal(a.swap_acceptance, b.swap_acceptance)
        assert torch.equal(a.betas, b.betas)
    if kind == "pt_power":
        assert a.log_evidence() == b.log_evidence()
        assert a.log_evidence("ti") == b.log_evidence("ti")
    if kind == "pcn":
        assert a.total_steps == b.total_steps and a.beta == b.beta
        assert a.acceptance_fraction == b.acceptance_fraction


KINDS = ["pt", "pt_power", "pcn", "elliptical", "gibbs"]


@pytest.mark.parametrize("kind", KINDS)
def test_resume_equals_uninterrupted_bitwise(tmp_path, kind):
    n = 12
    a = make(kind, 3)
    start(a, kind)
    if kind == "pt":
        a.tune_ladder(n_blocks=2, block_steps=10)  # a tuned ladder travels
    assert run(a, kind, n)
    path = save_checkpoint(a, tmp_path / f"{kind}.npz")
    assert run(a, kind, n)
    b = make(kind, 99)
    load_checkpoint(b, path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["kind"] == kind.split("_")[0] and meta["port"] == "torch"
    assert run(b, kind, n)
    assert_same(a, b, kind)


@pytest.mark.parametrize("kind,changes,error,match", [
    ("pt", {"n_temps": 4}, ValueError, "ladder size"),
    ("pt", {"power": True}, ValueError, "power-posterior"),
    ("pt", {"n_walkers": 32}, ValueError, "walker count"),
    ("pcn", {"n_chains": 16}, ValueError, "chain count"),
    ("elliptical", {"kind": "pcn"}, TypeError, "PCNSampler"),
    ("gibbs", {"layout": [["x", 2], ["z", 4]]}, ValueError, "layout"),
], ids=["pt-ladder", "pt-power", "pt-walkers", "pcn-chains",
        "elliptical-kind", "gibbs-layout"])
def test_mismatches_raise(tmp_path, kind, changes, error, match):
    s = make(kind, 1)
    start(s, kind)
    run(s, kind, 4)
    path = save_checkpoint(s, tmp_path / "ck.npz")
    with np.load(path, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    meta.update(changes)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)
    before = [t.clone() for t in state_tensors(s)]
    with pytest.raises(error, match=match):
        load_checkpoint(s, path)
    for x, y in zip(before, state_tensors(s)):  # nothing moved
        assert torch.equal(x, y)


# -- JAX files carried across ----------------------------------------------


def jax_sampler(kind):
    if kind == "pt":
        j = jref.ParallelTemperingSampler(j_logp, 16, P, n_temps=3, seed=0,
                                          swap_every=2)
    elif kind == "pt_power":
        j = jref.ParallelTemperingSampler(
            loglike_fn=j_loglike, logprior_fn=j_logprior, n_walkers=16,
            n_params=P, betas=jref.power_ladder(4), seed=0)
    elif kind == "pcn":
        j = jref.PCNSampler(j_loglike, prior_mean=np.zeros(P),
                            prior_chol=CHOL, beta=1.0, n_chains=8, seed=0)
    elif kind == "elliptical":
        j = jref.EllipticalSliceSampler(j_loglike, prior_mean=np.zeros(P),
                                        prior_chol=CHOL, n_chains=8, seed=0)
    else:
        from mcmcpp_tpu import gibbs as jg

        j = jref.BlockedGibbsSampler(
            _gibbs_blocks(jg, jnp), n_chains=8, seed=0,
            logp_fn=lambda v: -0.5 * jnp.sum(v["x"] ** 2))
    start(j, kind)
    run(j, kind, 10)
    return j


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_carried_across(tmp_path, kind):
    j = jax_sampler(kind)
    path = jax_save_checkpoint(j, tmp_path / f"jax_{kind}.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    p = make(kind, 5)
    assert sampler_from_jax_checkpoint(arrays, meta, p) is p
    if kind == "gibbs":
        for name in ("x", "z"):
            np.testing.assert_array_equal(p.state[name].numpy(),
                                          np.asarray(j.state[name]))
    else:
        for name, v in zip(j.state._fields, j.state):
            if v is None:
                assert getattr(p.state, name) is None
            elif name == "step":
                assert p.state.step == int(v)
            elif name.startswith("swaps_"):
                # the port's int64 counts on the device hold JAX's counts
                # since its last harvest plus its harvested total
                host = (j._swaps_acc_host if name == "swaps_accepted"
                        else j._swaps_prop_host)
                assert getattr(p.state, name).dtype == torch.int64
                np.testing.assert_array_equal(
                    getattr(p.state, name).numpy(),
                    np.asarray(v, np.int64) + host, err_msg=name)
            else:
                np.testing.assert_array_equal(
                    getattr(p.state, name).numpy(), np.asarray(v),
                    err_msg=name)
    np.testing.assert_array_equal(p.get_samples(), j.get_samples())
    np.testing.assert_array_equal(p.chain.get_logp(), j.chain.get_logp())
    if kind.startswith("pt"):
        np.testing.assert_array_equal(p.swap_acceptance, j.swap_acceptance)
        np.testing.assert_array_equal(p.betas.numpy(), np.asarray(j.betas))
    if kind == "pt_power":
        assert p.log_evidence() == pytest.approx(j.log_evidence(), rel=1e-6)
    if kind == "pcn":
        assert p.beta == j.beta != 1.0
        assert p.total_steps == j.total_steps
        assert p.acceptance_fraction == j.acceptance_fraction
    # the run goes on under the port's own seed
    n_before = p.chain.n_steps
    assert run(p, kind, 6)
    assert p.chain.n_steps == n_before + 3
    assert np.isfinite(p.get_samples()).all()


def test_jax_file_of_another_kind_is_refused(tmp_path):
    j = jax_sampler("pcn")
    path = jax_save_checkpoint(j, tmp_path / "jax_pcn.npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    with pytest.raises(TypeError, match="PCNSampler"):
        sampler_from_jax_checkpoint(arrays, meta, make("elliptical", 1))
    with pytest.raises(ValueError, match="chain count"):
        sampler_from_jax_checkpoint(arrays, dict(meta, n_chains=4),
                                    make("pcn", 1))
