"""Checkpoint kinds of the evidence and variational engines: ``smc``,
``nested``, ``neutra`` and ``advi``, on the CPU.

- Each kind resumes bit for bit: a run interrupted by a save and a load into
  an engine built with another seed ends where the uninterrupted run ends
  (SMC stage by stage, ensemble and flow mutation with the flow's
  parameters and Adam state; nested with both kernels, the host ledger
  included; NeuTra's ``fit(k); fit(k, resume=True)`` against ``fit(2k)``;
  ADVI's ``fit(k); fit(k)`` against ``fit(2k)``).
- A file written by the JAX package, one of each kind, loads through
  ``convert.sampler_from_jax_checkpoint`` with the same state (flow
  parameters and optax's Adam leaves included), and the run goes on.
- ``allow_device_change=True`` takes a file of the other device type, as
  for the other kinds; mismatched files are refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmcpp_tpu as jref
from mcmcpp_tpu.io import save_checkpoint as jax_save_checkpoint
from mcmcpp_tpu.neutra import RealNVP as JRealNVP
import mcmcpp_tpu_torch as mt
from mcmcpp_tpu_torch.convert import (
    adam_state_from_numpy,
    advi_params_from_numpy,
    sampler_from_jax_checkpoint,
)
from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint
from mcmcpp_tpu_torch.optim import adam_leaves
from tests.test_torch_checkpoint import _edit_meta

torch.set_num_threads(1)

DIM = 2


def tmodel():
    def lp(t):
        return -0.5 * torch.sum(t ** 2, -1) / 4.0

    def ll(t):
        return -0.5 * torch.sum((t - 1.0) ** 2, -1)

    def ps(gen, n):
        return 2.0 * torch.randn((n, DIM), generator=gen, device=gen.device)

    return lp, ll, ps


def jmodel():
    return (lambda t: -0.5 * jnp.sum(t ** 2) / 4.0,
            lambda t: -0.5 * jnp.sum((t - 1.0) ** 2),
            lambda key, n: 2.0 * jax.random.normal(key, (n, DIM)))


def _load_jax(path):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the engines, each in a form that resumes ------------------------------


def make_smc(mutation, seed=0, n=128):
    lp, ll, ps = tmodel()
    return mt.SMCSampler(lp, ll, ps, n, DIM, n_mcmc=2, seed=seed,
                         mutation=mutation, batched=True, device="cpu",
                         flow=mt.RealNVP(DIM, n_layers=2, hidden=8),
                         flow_fit_steps=8, flow_batch=32)


def make_nested(kernel, seed=0):
    lp, ll, ps = tmodel()
    return mt.NestedSampler(lp, ll, ps, DIM, n_live=64, batch=16, n_mcmc=2,
                            kernel=kernel, seed=seed, batched=True,
                            device="cpu")


def make_neutra(seed=0):
    lp, ll, _ = tmodel()
    return mt.NeuTra(lambda t: lp(t) + ll(t), DIM, seed=seed, batched=True,
                     device="cpu", flow=mt.SplineCoupling(
                         DIM, n_layers=2, hidden=8, n_bins=4))


def make_advi(seed=0):
    lp, ll, _ = tmodel()
    return mt.ADVI(lambda t: lp(t) + ll(t), DIM, full_rank=True, n_mc=8,
                   seed=seed, batched=True, device="cpu")


@pytest.mark.parametrize("mutation", ["ensemble", "flow"])
def test_smc_resumes_bitwise(tmp_path, mutation):
    full = make_smc(mutation).run()
    a = make_smc(mutation)
    with pytest.warns(UserWarning, match="max_stages"):
        a.run(max_stages=1)
    path = save_checkpoint(a, tmp_path / "smc.npz")
    b = load_checkpoint(make_smc(mutation, seed=9), path)
    b.run()
    _equal(full.state, b.state)
    assert b.n_stages == full.n_stages >= 2
    assert b.beta_ladder == full.beta_ladder
    if mutation == "flow":
        _equal(full._flow.param_list(), b._flow.param_list())
        assert full._flow_opt_state.count == b._flow_opt_state.count
        _equal(full._flow_opt_state.nu, b._flow_opt_state.nu)


@pytest.mark.parametrize("kernel", ["stretch", "slice"])
def test_nested_resumes_bitwise(tmp_path, kernel):
    full = make_nested(kernel).run(max_iters=6)
    a = make_nested(kernel)
    a.run(max_iters=3)
    path = save_checkpoint(a, tmp_path / "nested.npz")
    b = load_checkpoint(make_nested(kernel, seed=9), path)
    got = b.run(max_iters=3)
    assert got.n_iters == full.n_iters == 6
    assert got.n_calls == full.n_calls
    for x, y in zip(got, full):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(RuntimeError, match="live set"):
        save_checkpoint(make_nested(kernel), tmp_path / "empty.npz")


def test_neutra_fit_resumes_bitwise(tmp_path):
    full = make_neutra().fit(20, batch=16)
    a = make_neutra().fit(10, batch=16)
    path = save_checkpoint(a, tmp_path / "neutra.npz")
    b = load_checkpoint(make_neutra(seed=9), path)
    assert b.fit_result.elbo_history.tolist() == \
        a.fit_result.elbo_history.tolist()
    b.fit(10, batch=16, resume=True)
    _equal(full.params, b.params)
    assert b.fit_result.elbo_history.tolist() == \
        full.fit_result.elbo_history[10:].tolist()


def test_advi_resumes_bitwise(tmp_path):
    full = make_advi().fit(20)
    a = make_advi().fit(10)
    path = save_checkpoint(a, tmp_path / "advi.npz")
    b = load_checkpoint(make_advi(seed=9), path)
    b.fit(10)
    _equal(full.params, b.params)
    assert b.elbo_trace == full.elbo_trace
    assert b.opt_state.count == 20


# -- files of the JAX package ------------------------------------------------


def test_jax_smc_flow_file_loads(tmp_path):
    """A flow-mutation file: the carry after three optax Adam updates of the
    flow's parameters (as a stage's refit leaves it: count, mu, nu all
    non-trivial), written by the JAX package's own save."""
    import optax

    lp, ll, ps = jmodel()
    j = jref.SMCSampler(lp, ll, ps, 128, DIM, n_mcmc=2, seed=1,
                        mutation="flow", flow=JRealNVP(DIM, n_layers=2,
                                                       hidden=8),
                        flow_fit_steps=8, flow_batch=32)
    j.init()
    params, opt_state = j._flow_carry
    opt = optax.adam(1e-3)

    @jax.jit
    def update(params, opt_state, key):
        grads = jax.tree.map(lambda p: jax.random.normal(key, p.shape,
                                                         p.dtype), params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state

    for i in range(3):
        params, opt_state = update(params, opt_state, jax.random.key(i))
    j._flow_carry = (params, opt_state)
    j.n_stages, j.beta_ladder = 1, [0.0]
    arrays, meta = _load_jax(jax_save_checkpoint(j, tmp_path / "j.npz"))
    t = sampler_from_jax_checkpoint(arrays, meta, make_smc("flow"))
    for a, b in zip(j.state, t.state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    leaves = jax.tree_util.tree_leaves(j._flow_carry)
    params, opt = t._flow_carry
    mine = [p.detach().numpy() for p in params] + adam_leaves(opt)
    assert len(mine) == len(leaves) == 3 * len(params) + 1
    for a, b in zip(leaves, mine):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert int(np.asarray(leaves[len(params)])) == 3
    assert t.n_stages == 1 and t.beta_ladder == j.beta_ladder
    t.run()
    assert float(t.state.beta) == 1.0


def test_jax_nested_file_loads_and_continues(tmp_path):
    lp, ll, ps = jmodel()
    j = jref.NestedSampler(lp, ll, ps, DIM, n_live=64, batch=16, n_mcmc=2,
                           seed=1)
    j.run(max_iters=2)
    arrays, meta = _load_jax(jax_save_checkpoint(j, tmp_path / "j.npz"))
    t = sampler_from_jax_checkpoint(arrays, meta, make_nested("stretch"))
    for name in ("_live", "_ll", "_lpp"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert (t._logz, t._logx, t._n_calls, t._iters_done) == (
        j._logz, j._logx, j._n_calls, j._iters_done)
    np.testing.assert_array_equal(np.concatenate(t._dead_logw),
                                  np.concatenate(j._dead_logw))
    r = t.run(max_iters=2)
    assert r.n_iters == 4 and r.n_calls == 64 + 4 * 16 * 2


def test_jax_neutra_and_advi_files_load(tmp_path):
    lp, ll, _ = jmodel()
    j = jref.NeuTra(lambda t: lp(t) + ll(t), DIM, seed=1,
                    flow=JRealNVP(DIM, n_layers=2, hidden=8)).fit(5,
                                                                  batch=16)
    arrays, meta = _load_jax(jax_save_checkpoint(j, tmp_path / "n.npz"))
    tlp, tll, _ = tmodel()
    t = sampler_from_jax_checkpoint(arrays, meta, mt.NeuTra(
        lambda x: tlp(x) + tll(x), DIM, batched=True, device="cpu",
        flow=mt.RealNVP(DIM, n_layers=2, hidden=8)))
    for a, b in zip(jax.tree_util.tree_leaves(j.params), t.params):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    for a, b in zip(jax.tree_util.tree_leaves(j._opt_state),
                    adam_leaves(t._opt_state)):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(t.fit_result.elbo_history,
                                  j.fit_result.elbo_history)
    t.fit(3, batch=16, resume=True)
    assert t._opt_state.count == 8

    v = jref.ADVI(lambda t: lp(t) + ll(t), DIM, full_rank=True, n_mc=8,
                  seed=1).fit(5)
    arrays, meta = _load_jax(jax_save_checkpoint(v, tmp_path / "a.npz"))
    t = sampler_from_jax_checkpoint(arrays, meta, make_advi())
    for a, b in zip(v.params, t.params):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree_util.tree_leaves(v.opt_state),
                    adam_leaves(t.opt_state)):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert t.elbo_trace == v.elbo_trace
    # the same state through convert's functions, from the JAX objects
    params = advi_params_from_numpy(*(np.asarray(x) for x in v.params),
                                    full_rank=True, device="cpu")
    assert type(params).__name__ == "FullRankParams"
    _equal(params, t.params)
    opt = adam_state_from_numpy([np.asarray(x) for x in
                                 jax.tree_util.tree_leaves(v.opt_state)],
                                list(params))
    assert opt.count == t.opt_state.count == 5
    _equal(opt.mu + opt.nu, t.opt_state.mu + t.opt_state.nu)
    with pytest.raises(ValueError, match="full_rank"):
        sampler_from_jax_checkpoint(arrays, meta, mt.ADVI(
            lambda x: -x.sum(-1), DIM, batched=True, device="cpu"))


# -- device change and refusals ---------------------------------------------


@pytest.mark.parametrize("kind", ["smc", "nested", "neutra", "advi"])
def test_device_change_needs_allow(tmp_path, kind):
    make = {"smc": lambda s: make_smc("ensemble", s),
            "nested": lambda s: make_nested("stretch", s),
            "neutra": make_neutra, "advi": make_advi}[kind]
    a = make(0)
    {"smc": lambda: a.init(), "nested": lambda: a.run(max_iters=1),
     "neutra": lambda: a.fit(2, batch=8), "advi": lambda: a.fit(2)}[kind]()
    path = save_checkpoint(a, tmp_path / "ck.npz")
    _edit_meta(path, device="cuda")
    with pytest.raises(ValueError, match="allow_device_change"):
        load_checkpoint(make(1), path)
    b = load_checkpoint(make(1), path, allow_device_change=True)
    assert b._step_gen.get_state().tolist() != a._step_gen.get_state().tolist()


def test_mismatched_files_are_refused(tmp_path):
    a = make_smc("ensemble").init()
    path = save_checkpoint(a, tmp_path / "smc.npz")
    with pytest.raises(ValueError, match="particle count"):
        load_checkpoint(make_smc("ensemble", n=64), path)
    with pytest.raises(ValueError, match="flow-mutation mismatch"):
        load_checkpoint(make_smc("flow"), path)
    with pytest.raises(TypeError, match="is for an SMCSampler"):
        load_checkpoint(make_nested("stretch"), path)
    n = make_nested("stretch")
    n.run(max_iters=1)
    path = save_checkpoint(n, tmp_path / "nested.npz")
    with pytest.raises(ValueError, match="kernel mismatch"):
        load_checkpoint(make_nested("slice"), path)
    path = save_checkpoint(make_neutra(), tmp_path / "neutra.npz")
    lp, ll, _ = tmodel()
    with pytest.raises(ValueError, match="flow family"):
        load_checkpoint(mt.NeuTra(lambda t: lp(t) + ll(t), DIM, batched=True,
                                  device="cpu"), path)
    path = save_checkpoint(make_advi(), tmp_path / "advi.npz")
    with pytest.raises(ValueError, match="full_rank"):
        load_checkpoint(mt.ADVI(lambda t: lp(t) + ll(t), DIM, batched=True,
                                device="cpu"), path)
