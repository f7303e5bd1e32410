"""Checkpoint / resume for the ensemble sampler, the gradient engines, the
population engines, the evidence and variational engines and the
time-series engines.

Counterpart of ``mcmcpp_tpu/io/checkpoint.py`` (the reference has no
checkpointing, SURVEY.md §5) for its kinds ``ensemble``, ``gradient`` (HMC,
NUTS, MALA, Barker, ChEES, MEADS), ``sgmcmc`` (SGLD, SGHMC), ``mclmc``,
``mams``, ``pt`` (parallel tempering, with the evidence accumulators of
power mode), ``pcn``, ``elliptical``, ``gibbs``, and the evidence and
variational engines' ``smc`` (with the flow mutation's parameters and Adam
state), ``nested`` (the live set and the host ledger), ``neutra`` (the flow's
parameters, Adam state and fit traces) and ``advi``, and the time-series
engines' ``pmmh`` (with the tuned proposal), ``ibis`` and ``smc2`` (each with
its absorbed observations, which a move re-scores). A checkpoint is one
``.npz`` archive holding the device state (positions, log-probs, gradients,
momenta, counters, step sizes, the mass matrix, ChEES's trajectory
adaptation, the sample stats, the variational parameters), the state of the
sampler's random generators and the host chain, where the engine keeps one:
enough to resume bitwise-identically to an uninterrupted run on the same
kind of device. A parameter list and an Adam state are stored as the JAX
package stores their pytrees, leaf by leaf (``flow_leaf_i``, ``opt_leaf_i``,
``vi_leaf_i``; Adam's leaves ``[count, *mu, *nu]``).

Format: flat name → array dict plus a JSON meta blob; no pickling, so
checkpoints are portable and safe to load from untrusted storage. Array
names are the JAX package's where they mean the same. Where that package
saves one threefry key, this one saves the sampler's ``torch.Generator``
states (step and auxiliary on its device, host on the CPU) as ``uint8``
arrays, and the meta records the device type: a CUDA and a CPU generator
draw different streams, so a checkpoint loads only into a sampler on the
kind of device that wrote it. A chain whose rows are held as raw bits
(bfloat16, 8-bit floats) is saved as those bits beside the dtype's name.
The meta carries ``"port": "torch"`` and a format tag of its own, so
neither package takes the other's file for its own; a file of the JAX
package is read with :func:`mcmcpp_tpu_torch.convert.sampler_from_jax_checkpoint`.
"""

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import from_held

_FORMAT_VERSION = "torch-1"
_PORT = "torch"

# what a refused load says the file is for, by kind
FOR_SAMPLER = {
    "ensemble": "an EnsembleSampler",
    "gradient": "a gradient sampler",
    "sgmcmc": "a stochastic-gradient sampler",
    "mclmc": "an (unadjusted) MCLMCSampler",
    "mams": "a MAMSSampler",
    "pt": "a ParallelTemperingSampler",
    "pcn": "a PCNSampler",
    "elliptical": "an EllipticalSliceSampler",
    "gibbs": "a BlockedGibbsSampler",
    "smc": "an SMCSampler",
    "nested": "a NestedSampler",
    "neutra": "a NeuTra transport",
    "advi": "an ADVI fit",
    "pmmh": "a PMMHSampler",
    "ibis": "an IBISSampler",
    "smc2": "an SMC2Sampler",
}

# the nested sampler's configuration a file must match (≙ the JAX loader)
NESTED_FIELDS = ("n_live", "batch", "kernel", "n_mcmc", "a")

_GENERATORS = ("step", "aux", "host")


def checkpoint_kind(sampler):
    """The checkpoint kind of ``sampler``, or None."""
    from mcmcpp_tpu_torch.gradient.hmc import GradientSampler
    from mcmcpp_tpu_torch.gradient.mclmc import MAMSSampler, MCLMCSampler
    from mcmcpp_tpu_torch.gradient.sgmcmc import StochasticGradientSampler
    from mcmcpp_tpu_torch.elliptical import EllipticalSliceSampler
    from mcmcpp_tpu_torch.gibbs import BlockedGibbsSampler
    from mcmcpp_tpu_torch.ibis import IBISSampler
    from mcmcpp_tpu_torch.particle import PMMHSampler
    from mcmcpp_tpu_torch.smc2 import SMC2Sampler
    from mcmcpp_tpu_torch.pcn import PCNSampler
    from mcmcpp_tpu_torch.sampler import EnsembleSampler
    from mcmcpp_tpu_torch.nested import NestedSampler
    from mcmcpp_tpu_torch.neutra import NeuTra
    from mcmcpp_tpu_torch.smc import SMCSampler
    from mcmcpp_tpu_torch.tempering import ParallelTemperingSampler
    from mcmcpp_tpu_torch.vi import ADVI

    for cls, kind in ((EnsembleSampler, "ensemble"),
                      (GradientSampler, "gradient"),
                      (StochasticGradientSampler, "sgmcmc"),
                      (MAMSSampler, "mams"), (MCLMCSampler, "mclmc"),
                      (ParallelTemperingSampler, "pt"), (PCNSampler, "pcn"),
                      (EllipticalSliceSampler, "elliptical"),
                      (BlockedGibbsSampler, "gibbs"), (SMCSampler, "smc"),
                      (NestedSampler, "nested"), (NeuTra, "neutra"),
                      (ADVI, "advi"), (PMMHSampler, "pmmh"),
                      (IBISSampler, "ibis"), (SMC2Sampler, "smc2")):
        if isinstance(sampler, cls):
            return kind
    return None


def _npz_path(path):
    path = Path(path)
    if path.suffix != ".npz":
        # np.savez appends .npz itself; normalize so the returned path is
        # the file that actually exists
        path = path.with_name(path.name + ".npz")
    return path


def _host(t):
    return t.cpu().numpy()


def _one_rank(sampler):
    """A checkpoint holds the whole run: a sampler sharded over more than
    one rank (``mesh=``) holds only its rows (there is no sharded
    checkpoint kind, as in the JAX package). In a group of one a sharded
    sampler saves and loads as an unsharded one."""
    layout = getattr(sampler, "mesh", None)
    if layout is not None and layout.world_size > 1:
        raise NotImplementedError(
            f"a {type(sampler).__name__} over {layout.world_size} ranks "
            "holds only its own rows; no checkpoint kind saves or loads a "
            "sharded run")


def _save_ensemble(sampler, meta, arrays):
    s = sampler.state
    meta.update(n_walkers=sampler.n_walkers,
                reset_step_base=sampler._reset_step_base)
    arrays.update(
        red=_host(s.red), black=_host(s.black),
        logp_red=_host(s.logp_red), logp_black=_host(s.logp_black),
        accepted_red=_host(s.accepted_red),
        accepted_black=_host(s.accepted_black),
        step=np.asarray(s.step, np.int64),
        accepted_walkers_host=(
            sampler._accepted_walkers_host
            if sampler._accepted_walkers_host is not None
            else np.zeros((0,), np.int64)
        ),
    )


def _save_gradient(sampler, meta, arrays):
    from mcmcpp_tpu_torch.gradient.metric import is_dense

    s = sampler.state
    meta.update(n_chains=sampler.n_chains, metric=sampler.metric)
    # ChEES carries an adapted trajectory length and, under
    # continuous_adapt, the live (log T, Adam) state
    if getattr(sampler, "traj_length", None) is not None:
        meta["traj_length"] = float(sampler.traj_length)
    sa = getattr(sampler, "_sadapt", None)
    if sa is not None:
        arrays.update(sadapt_log_traj=sa[0].numpy(), sadapt_m=sa[1].m.numpy(),
                      sadapt_v=sa[1].v.numpy(),
                      sadapt_count=np.asarray(sa[1].count, np.int64))
    arrays.update({name: _host(getattr(s, name)) for name in s._fields})
    # a per-chain tensor after warmup, else a host float (kept exactly)
    step = sampler.step_size
    arrays["step_size"] = (_host(step) if isinstance(step, torch.Tensor)
                           else np.asarray(step, np.float64))
    if is_dense(sampler.inv_mass):
        # the factors are recomputed on load, bit for bit
        arrays["inv_mass_cov"] = _host(sampler.inv_mass.cov)
    else:
        arrays["inv_mass"] = _host(sampler.inv_mass)
    stats = sampler.get_sample_stats()
    arrays["stat_diverging"] = stats["diverging"]
    arrays["stat_energy"] = stats["energy"]


def _save_sgmcmc(sampler, meta, arrays):
    s = sampler.state
    meta["n_chains"] = sampler.n_chains
    arrays.update(position=_host(s.position), velocity=_host(s.velocity),
                  sg_step=np.asarray(s.step, np.int64))


def _save_mclmc(sampler, meta, arrays):
    s = sampler.state
    meta.update(n_chains=sampler.n_chains, adjusted=meta["kind"] == "mams",
                step_size=float(sampler.step_size),
                decoherence_length=float(sampler.decoherence_length),
                energy_var=float(sampler.energy_var))
    if meta["kind"] == "mams":
        meta.update(target_accept=float(sampler.target_accept),
                    last_mean_accept=float(sampler.last_mean_accept))
    arrays.update({name: _host(getattr(s, name)) for name in s._fields})
    if sampler.inv_mass is not None:
        arrays["inv_mass"] = _host(sampler.inv_mass)


def _save_pt(sampler, meta, arrays):
    from mcmcpp_tpu_torch.tempering import EVIDENCE_FIELDS

    s = sampler.state
    meta.update(n_walkers=sampler.n_walkers, n_temps=sampler.n_temps,
                power=bool(sampler._power))
    arrays.update(
        red=_host(s.red), black=_host(s.black),
        logp_red=_host(s.logp_red), logp_black=_host(s.logp_black),
        step=np.asarray(s.step, np.int64),
        swaps_accepted=_host(s.swaps_accepted),
        swaps_proposed=_host(s.swaps_proposed),
        # a tuned ladder travels with the checkpoint
        betas=_host(sampler.betas))
    if sampler._power:
        arrays.update({name: _host(getattr(s, name))
                       for name in ("ll_red", "ll_black") + EVIDENCE_FIELDS})


def _save_pcn(sampler, meta, arrays):
    s = sampler.state
    # tune() changes beta: it is part of the state
    meta.update(n_chains=sampler.n_chains, total_steps=sampler.total_steps,
                beta=sampler.beta)
    arrays.update(position=_host(s.position), loglike=_host(s.loglike),
                  accepted=_host(s.accepted))


def _save_elliptical(sampler, meta, arrays):
    s = sampler.state
    meta.update(n_chains=sampler.n_chains, counters=dict(sampler.counters))
    arrays.update(position=_host(s.position), loglike=_host(s.loglike))


def _save_gibbs(sampler, meta, arrays):
    meta.update(n_chains=sampler.n_chains,
                layout=[[n, int(sz)] for n, sz in sampler._layout])
    arrays.update({f"block_{name}": _host(sampler.state[name])
                   for name, _ in sampler._layout})


def _pack(arrays, meta, prefix, leaves):
    """A list of numpy leaves as ``{prefix}_leaf_i`` and their count."""
    meta[f"n_{prefix}_leaves"] = len(leaves)
    arrays.update({f"{prefix}_leaf_{i}": leaf for i, leaf in
                   enumerate(leaves)})


def _param_leaves(params):
    return [_host(p.detach()) for p in params]


def _save_smc(sampler, meta, arrays):
    from mcmcpp_tpu_torch.optim import adam_leaves

    s = sampler.state
    meta.update(n_particles=sampler.n, n_stages=sampler.n_stages,
                beta_ladder=[float(b) for b in sampler.beta_ladder])
    arrays.update({name: _host(getattr(s, name)) for name in s._fields})
    if sampler._flow is not None:
        # the flow mutation's carry, as the JAX package's leaves of
        # (params, optax state): the parameters, then [count, *mu, *nu]
        params, opt = sampler._flow_carry
        _pack(arrays, meta, "flow", _param_leaves(params) + adam_leaves(opt))


def _save_nested(sampler, meta, arrays):
    d = sampler.n_params
    meta.update({f: getattr(sampler, f) for f in NESTED_FIELDS})
    meta.update(iters_done=sampler._iters_done,
                n_calls=int(sampler._n_calls), logz=float(sampler._logz),
                logx=float(sampler._logx),
                low_acc_warned=bool(sampler._low_acc_warned))

    def stacked(parts, shape):
        return np.concatenate(parts, 0) if parts else np.zeros(shape)

    arrays.update(live=_host(sampler._live), ll=_host(sampler._ll),
                  lpp=_host(sampler._lpp),
                  dead_pos=stacked(sampler._dead_pos, (0, d)),
                  dead_ll=stacked(sampler._dead_ll, (0,)),
                  dead_logw=stacked(sampler._dead_logw, (0,)))


def _save_neutra(sampler, meta, arrays):
    from mcmcpp_tpu_torch.optim import adam_leaves

    meta["flow"] = type(sampler.flow).__name__
    _pack(arrays, meta, "flow", _param_leaves(sampler.params))
    if sampler._opt_state is not None:
        _pack(arrays, meta, "opt", adam_leaves(sampler._opt_state))
    for attr in ("fit_result", "refit_result"):
        fr = getattr(sampler, attr)
        if fr is not None:
            arrays[f"{attr}_hist"] = np.asarray(fr.elbo_history)


def _save_advi(sampler, meta, arrays):
    from mcmcpp_tpu_torch.optim import adam_leaves

    meta["full_rank"] = bool(sampler.full_rank)
    arrays["elbo_trace"] = np.asarray(sampler.elbo_trace, np.float64)
    _pack(arrays, meta, "vi", _param_leaves(sampler.params))
    _pack(arrays, meta, "opt", adam_leaves(sampler.opt_state))


def _save_pmmh(sampler, meta, arrays):
    s = sampler.state
    meta.update(n_chains=sampler.n_chains,
                n_steps_done=sampler._n_steps_done)
    arrays.update({name: _host(getattr(s, name)) for name in s._fields})
    # a tuned proposal travels with the state
    arrays["prop_chol"] = _host(sampler._prop_chol)


def _save_stream(sampler, meta, arrays):
    """What IBIS and SMC² share: the state's fields, the prequential trace
    and the resample count."""
    s = sampler.state
    meta["n_resamples"] = sampler.n_resamples
    arrays.update({name: _host(getattr(s, name)) for name in s._fields})
    arrays["evidence_trace"] = np.asarray(sampler.log_evidence_trace,
                                          np.float64)


def _save_ibis(sampler, meta, arrays):
    if sampler._data is None:
        raise RuntimeError("cannot checkpoint an IBISSampler before update()")
    meta.update(n_particles=sampler.n, batch_size=sampler.batch_size)
    _save_stream(sampler, meta, arrays)
    # the absorbed stream travels with the state: a move re-scores its
    # proposals against it. An array, or a flat dict of arrays.
    if isinstance(sampler._data, dict):
        keys = sorted(sampler._data)
        meta.update(data_format="dict", data_keys=keys)
        arrays.update({f"data_{i}": _host(sampler._data[k])
                       for i, k in enumerate(keys)})
    else:
        meta["data_format"] = "array"
        arrays["data_0"] = _host(sampler._data)


def _save_smc2(sampler, meta, arrays):
    if sampler._ys is None:
        raise RuntimeError("cannot checkpoint an SMC2Sampler before update()")
    meta.update(n_theta=sampler.m, n_x=sampler.n_x,
                n_growths=sampler.n_growths)
    _save_stream(sampler, meta, arrays)
    # a rejuvenation re-filters the absorbed prefix
    arrays["ys"] = _host(sampler._ys)


_SAVERS = {"ensemble": _save_ensemble, "gradient": _save_gradient,
           "sgmcmc": _save_sgmcmc, "mclmc": _save_mclmc, "mams": _save_mclmc,
           "pt": _save_pt, "pcn": _save_pcn, "elliptical": _save_elliptical,
           "gibbs": _save_gibbs, "smc": _save_smc, "nested": _save_nested,
           "neutra": _save_neutra, "advi": _save_advi, "pmmh": _save_pmmh,
           "ibis": _save_ibis, "smc2": _save_smc2}


def save_checkpoint(sampler, path):
    """Write ``sampler``'s full resumable state to ``path`` (.npz)."""
    kind = checkpoint_kind(sampler)
    if kind is None:
        raise TypeError(f"unsupported sampler type {type(sampler).__name__}")
    _one_rank(sampler)
    if kind == "nested" and sampler._live is None:
        raise RuntimeError("cannot checkpoint a NestedSampler before run() "
                           "has initialized the live set")
    if getattr(sampler, "state", ()) is None:
        raise RuntimeError("cannot checkpoint an uninitialized sampler")
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "format": _FORMAT_VERSION,
        "port": _PORT,
        "class": type(sampler).__name__,
        "kind": kind,
        "n_params": sampler.n_params,
        "device": sampler.device.type,
    }
    arrays = {}
    chain = getattr(sampler, "chain", None)
    if chain is not None:
        meta.update(chain_dtype=chain.dtype.name,
                    chain_logp_dtype=getattr(chain, "logp_dtype",
                                             chain.dtype).name)
        arrays.update(chain_samples=chain.get(held=True),
                      chain_logp=chain.get_logp(held=True))
    _SAVERS[kind](sampler, meta, arrays)
    for name in _GENERATORS:
        gen = getattr(sampler, f"_{name}_gen", None)
        if gen is not None:
            arrays[f"rng_{name}"] = gen.get_state().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    # atomic replace: a crash mid-save must not destroy the previous good
    # checkpoint (the whole point of checkpointing)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def _load_ensemble(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.sampler import EnsembleState

    sampler.state = EnsembleState(
        red=dev("red"), black=dev("black"),
        logp_red=dev("logp_red"), logp_black=dev("logp_black"),
        accepted_red=dev("accepted_red"),
        accepted_black=dev("accepted_black"),
        step=int(arrays["step"]),
    )
    awh = arrays["accepted_walkers_host"]
    sampler._accepted_walkers_host = (
        awh.astype(np.int64) if awh.shape[0] else None
    )
    sampler._reset_step_base = int(meta["reset_step_base"])


def _load_gradient(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.gradient.chees import AdamState
    from mcmcpp_tpu_torch.gradient.hmc import HMCState
    from mcmcpp_tpu_torch.gradient.meads import MEADSState
    from mcmcpp_tpu_torch.gradient.metric import dense_mass_from_cov

    cls = MEADSState if "momentum" in arrays else HMCState
    sampler.state = cls(*(dev(name) for name in cls._fields))
    step_size = arrays["step_size"]
    sampler.step_size = (float(step_size) if step_size.ndim == 0
                         else dev("step_size"))
    sampler.inv_mass = (dense_mass_from_cov(dev("inv_mass_cov"))
                        if meta["metric"] == "dense" else dev("inv_mass"))
    sampler._divergences = ([arrays["stat_diverging"]]
                            if arrays["stat_diverging"].shape[0] else [])
    sampler._energies = ([arrays["stat_energy"]]
                         if arrays["stat_energy"].shape[0] else [])
    if "traj_length" in meta:
        sampler.traj_length = float(meta["traj_length"])
    if hasattr(sampler, "_sadapt"):
        sampler._sadapt = None if "sadapt_log_traj" not in arrays else (
            torch.from_numpy(arrays["sadapt_log_traj"]),
            AdamState(m=torch.from_numpy(arrays["sadapt_m"]),
                      v=torch.from_numpy(arrays["sadapt_v"]),
                      count=int(arrays["sadapt_count"])))


def _load_sgmcmc(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.gradient.sgmcmc import SGState

    sampler.state = SGState(dev("position"), dev("velocity"),
                            int(arrays["sg_step"]))


def _load_mclmc(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.gradient.mclmc import MCLMCState

    sampler.state = MCLMCState(*(dev(name) for name in MCLMCState._fields))
    sampler.step_size = float(meta["step_size"])
    sampler.decoherence_length = float(meta["decoherence_length"])
    sampler.energy_var = float(meta["energy_var"])
    sampler.inv_mass = dev("inv_mass") if "inv_mass" in arrays else None
    if meta["kind"] == "mams":
        sampler.target_accept = float(meta["target_accept"])
        sampler.last_mean_accept = float(meta["last_mean_accept"])


def load_pt_state(sampler, arrays, dev):
    """The PT sampler's state, ladder and swap counts from a file's arrays
    (this package's or the JAX package's: the names are the same);
    ``dev(name)`` gives an array as a tensor on the sampler's device."""
    from mcmcpp_tpu_torch.tempering import EVIDENCE_FIELDS, PTState

    def counts(name, host):
        # int64 on the device; a JAX file keeps the int32 counts since its
        # last harvest apart from the harvested total
        c = dev(name).to(torch.int64)
        if host in arrays:
            c = c + torch.from_numpy(
                np.asarray(arrays[host], np.int64)).to(c.device)
        return c

    extra = {}
    if sampler._power:
        extra = {name: dev(name)
                 for name in ("ll_red", "ll_black") + EVIDENCE_FIELDS}
    sampler.state = PTState(
        red=dev("red"), black=dev("black"), logp_red=dev("logp_red"),
        logp_black=dev("logp_black"), step=int(arrays["step"]),
        swaps_accepted=counts("swaps_accepted", "swaps_acc_host"),
        swaps_proposed=counts("swaps_proposed", "swaps_prop_host"), **extra)
    sampler._set_betas(np.asarray(arrays["betas"]))


def _load_pt(sampler, meta, arrays, dev):
    load_pt_state(sampler, arrays, dev)


def _load_pcn(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.pcn import PCNState

    sampler.state = PCNState(dev("position"), dev("loglike"),
                             dev("accepted").to(torch.int32))
    sampler.total_steps = int(meta["total_steps"])
    if "beta" in meta:  # absent in the JAX package's pre-tune() files
        sampler.beta = float(meta["beta"])


def _load_elliptical(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.elliptical import EllipticalState

    sampler.state = EllipticalState(dev("position"), dev("loglike"))
    if "counters" in meta:
        sampler.counters = {k: int(v) for k, v in meta["counters"].items()}


def _load_gibbs(sampler, meta, arrays, dev):
    sampler.state = {name: dev(f"block_{name}") for name, _ in
                     sampler._layout}


def _unpack(arrays, meta, prefix, like):
    """The leaves ``{prefix}_leaf_i`` as numpy, after checking their count
    and shapes against the tensors ``like`` (the sampler's configuration),
    or their count alone where ``like`` is an int."""
    n = int(meta.get(f"n_{prefix}_leaves", 0))
    want = like if isinstance(like, int) else len(like)
    if n != want:
        raise ValueError(
            f"checkpoint stores {n} {prefix} leaves but the sampler's "
            f"configuration implies {want} — flow/optimizer architecture "
            "mismatch")
    leaves = [np.asarray(arrays[f"{prefix}_leaf_{i}"]) for i in range(n)]
    if not isinstance(like, int):
        for i, (a, t) in enumerate(zip(leaves, like)):
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"{prefix} leaf {i} shape {a.shape} != the sampler "
                    f"configuration's {tuple(t.shape)} — same-depth but "
                    "different-width architecture mismatch")
    return leaves


@torch.no_grad()
def _set_params(params, leaves):
    for p, a in zip(params, leaves):
        p.copy_(torch.from_numpy(np.array(a)).to(p.device, p.dtype))


def _load_smc(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.optim import adam_from_leaves
    from mcmcpp_tpu_torch.smc import SMCState

    sampler.state = SMCState(*(dev(name).to(sampler.dtype)
                               for name in SMCState._fields))
    sampler.n_stages = int(meta["n_stages"])
    sampler.beta_ladder = [float(b) for b in meta["beta_ladder"]]
    if sampler._flow is not None:
        params = sampler._flow.param_list()
        leaves = _unpack(arrays, meta, "flow", 3 * len(params) + 1)
        _set_params(params, leaves[:len(params)])
        sampler._flow_opt_state = adam_from_leaves(leaves[len(params):],
                                                   params)


def _load_nested(sampler, meta, arrays, dev):
    sampler._live = dev("live").to(sampler.dtype)
    sampler._ll, sampler._lpp = dev("ll"), dev("lpp")

    def parts(name):
        a = np.asarray(arrays[name])
        return [a] if a.shape[0] else []

    sampler._dead_pos = parts("dead_pos")
    sampler._dead_ll = parts("dead_ll")
    sampler._dead_logw = parts("dead_logw")
    sampler._logz, sampler._logx = float(meta["logz"]), float(meta["logx"])
    sampler._n_calls = int(meta["n_calls"])
    sampler._iters_done = int(meta["iters_done"])
    sampler._low_acc_warned = bool(meta["low_acc_warned"])
    sampler.result = None  # stale; run() finalizes again


def _load_neutra(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.neutra import FitResult
    from mcmcpp_tpu_torch.optim import adam_from_leaves

    params = sampler.params
    _set_params(params, _unpack(arrays, meta, "flow", params))
    sampler._opt_state = (
        adam_from_leaves(_unpack(arrays, meta, "opt", 2 * len(params) + 1),
                         params)
        if "n_opt_leaves" in meta else None)
    for attr in ("fit_result", "refit_result"):
        hist = arrays.get(f"{attr}_hist")
        setattr(sampler, attr, None if hist is None else FitResult(
            np.asarray(hist), float(np.asarray(hist)[-100:].mean())))


def _load_advi(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.optim import adam_from_leaves

    like = list(sampler.params)
    leaves = _unpack(arrays, meta, "vi", like)
    sampler.params = type(sampler.params)(*(
        torch.from_numpy(np.array(a)).to(t.device, t.dtype)
        for a, t in zip(leaves, like)))
    sampler.opt_state = adam_from_leaves(
        _unpack(arrays, meta, "opt", 2 * len(like) + 1), like)
    sampler.elbo_trace = [float(v) for v in arrays["elbo_trace"]]


#: the kinds whose file layout is the JAX package's, array for array, so
def _load_pmmh(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.particle import PMMHState

    s = PMMHState(*(dev(name) for name in PMMHState._fields))
    sampler.state = s._replace(accepted=s.accepted.to(torch.int32))
    sampler._n_steps_done = int(meta["n_steps_done"])
    if "prop_chol" in arrays:
        sampler._prop_chol = dev("prop_chol").to(sampler.dtype)


def _load_stream(sampler, meta, arrays, dev, state_cls):
    state = state_cls(*(dev(name) for name in state_cls._fields))
    sampler.state = state._replace(n_included=state.n_included.to(
        torch.int32))
    sampler.n_resamples = int(meta["n_resamples"])
    sampler.log_evidence_trace = [float(v) for v in arrays["evidence_trace"]]


def _load_ibis(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.ibis import IBISState

    _load_stream(sampler, meta, arrays, dev, IBISState)
    if meta["data_format"] == "dict":
        sampler._data = {k: dev(f"data_{i}")
                         for i, k in enumerate(meta["data_keys"])}
    else:
        sampler._data = dev("data_0")


def _load_smc2(sampler, meta, arrays, dev):
    from mcmcpp_tpu_torch.smc2 import SMC2State

    _load_stream(sampler, meta, arrays, dev, SMC2State)
    # n_x is run-time state (the exchange step doubles it): adopted, not
    # checked
    sampler.n_x = int(meta["n_x"])
    sampler.n_growths = int(meta.get("n_growths", 0))
    sampler._ys = dev("ys").to(sampler.dtype)


#: ``convert.sampler_from_jax_checkpoint`` loads its files with these
SHARED_LOADERS = ("smc", "nested", "neutra", "advi", "ibis", "smc2")

_LOADERS = {"ensemble": _load_ensemble, "gradient": _load_gradient,
            "sgmcmc": _load_sgmcmc, "mclmc": _load_mclmc, "mams": _load_mclmc,
            "pt": _load_pt, "pcn": _load_pcn, "elliptical": _load_elliptical,
            "gibbs": _load_gibbs, "smc": _load_smc, "nested": _load_nested,
            "neutra": _load_neutra, "advi": _load_advi, "pmmh": _load_pmmh,
            "ibis": _load_ibis, "smc2": _load_smc2}


def refuse_geometry(kind, meta, sampler):
    """Raise if the file's geometry (walkers, chains, particles, ladder,
    power mode, block layout, the nested sampler's configuration, the flow
    family, full rank) differs from ``sampler``'s; shared with
    ``convert.sampler_from_jax_checkpoint``."""
    if kind in ("ensemble", "pt"):
        if meta["n_walkers"] != sampler.n_walkers:
            raise ValueError("walker count mismatch")
    elif kind == "smc":
        if meta["n_particles"] != sampler.n:
            raise ValueError("particle count mismatch")
        n_flow = int(meta.get("n_flow_leaves", 0))
        if (n_flow > 0) != (sampler._flow is not None):
            raise ValueError(
                f"flow-mutation mismatch: checkpoint "
                f"{'has' if n_flow else 'lacks'} flow state but the sampler "
                f"was built with mutation={sampler.mutation!r}")
    elif kind == "nested":
        for field in NESTED_FIELDS:
            # n_mcmc and a are absent from early JAX files: the remaining
            # fields still guard the load
            if field in meta and meta[field] != getattr(sampler, field):
                raise ValueError(
                    f"{field} mismatch: checkpoint {meta[field]!r}, "
                    f"sampler {getattr(sampler, field)!r}")
    elif kind == "neutra":
        if meta["flow"] != type(sampler.flow).__name__:
            raise ValueError(f"flow family mismatch: checkpoint "
                             f"{meta['flow']}, sampler "
                             f"{type(sampler.flow).__name__}")
    elif kind == "advi":
        if bool(meta["full_rank"]) != bool(sampler.full_rank):
            raise ValueError("checkpoint/sampler disagree on full_rank mode")
    elif kind == "ibis":
        if meta["n_particles"] != sampler.n:
            raise ValueError("particle count mismatch")
        if meta["batch_size"] != sampler.batch_size:
            raise ValueError("batch_size mismatch")
    elif kind == "smc2":
        if meta["n_theta"] != sampler.m:
            raise ValueError("theta-particle count mismatch")
    elif meta["n_chains"] != sampler.n_chains:
        raise ValueError("chain count mismatch")
    if kind == "pt":
        if meta["n_temps"] != sampler.n_temps:
            raise ValueError("ladder size mismatch")
        if bool(meta["power"]) != bool(sampler._power):
            raise ValueError(
                "checkpoint/sampler disagree on power-posterior mode")
    if kind == "gibbs":
        layout = [(n, int(sz)) for n, sz in meta["layout"]]
        if layout != list(sampler._layout):
            raise ValueError(f"block layout mismatch: checkpoint {layout}, "
                             f"sampler {list(sampler._layout)}")


def _refuse_mismatch(sampler, meta, arrays, allow_device_change=False):
    """Raise if the file cannot resume ``sampler`` (before anything moves)."""
    kind = meta["kind"]
    if checkpoint_kind(sampler) != kind:
        raise TypeError(f"checkpoint is for {FOR_SAMPLER[kind]}")
    if meta["n_params"] != sampler.n_params:
        raise ValueError(
            f"checkpoint has n_params={meta['n_params']}, "
            f"sampler has {sampler.n_params}"
        )
    refuse_geometry(kind, meta, sampler)
    if meta["device"] != sampler.device.type and not allow_device_change:
        raise ValueError(
            f"checkpoint was written on a {meta['device']} sampler and this "
            f"one is on {sampler.device.type}: their generators draw "
            "different streams, so the run would not resume (pass "
            "allow_device_change=True to load it and go on, not bitwise)"
        )
    if kind == "gradient":
        from mcmcpp_tpu_torch.gradient.meads import MEADSSampler

        if meta["metric"] != sampler.metric:
            raise ValueError(f"checkpoint has metric={meta['metric']!r}, "
                             f"sampler has {sampler.metric!r}")
        if ("momentum" in arrays) != isinstance(sampler, MEADSSampler):
            raise TypeError("a MEADS checkpoint (it carries momenta) loads "
                            "into a MEADSSampler and no other")
    saved = {n for n in _GENERATORS if f"rng_{n}" in arrays}
    held = {n for n in _GENERATORS
            if getattr(sampler, f"_{n}_gen", None) is not None}
    if saved != held:
        raise ValueError(f"checkpoint holds the generators {sorted(saved)}, "
                         f"the sampler {sorted(held)}")


def _reseeded(gen, saved_state):
    """``gen`` seeded from a digest of a generator state saved on another
    device type (whose state ``gen`` cannot take)."""
    digest = hashlib.sha256(np.ascontiguousarray(saved_state).tobytes())
    gen.manual_seed(int.from_bytes(digest.digest()[:8], "little"))


def load_checkpoint(sampler, path, allow_device_change=False):
    """Restore state saved by :func:`save_checkpoint` into ``sampler``.

    ``sampler`` must be constructed with the same target and shape, and by
    default on the same device type (validated against the stored meta):
    then the run resumes bitwise. Returns the sampler.

    ``allow_device_change=True`` also takes a file written on the other
    device type (a run begun on the card, looked at or continued on the
    CPU, or the reverse). The state and the chain load as written, and the
    host generator (a CPU one on both) is restored; the generators on the
    sampler's device cannot take a state of the other type's, so each is
    reseeded from a digest of its saved state. The continuation is a valid
    run of the same chain, deterministic for a given file, but NOT the one
    the writing device would have drawn: it is not bitwise.
    """
    _one_rank(sampler)
    path = Path(path)
    if path.suffix != ".npz" and not path.exists():
        path = path.with_name(path.name + ".npz")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("port") != _PORT:
        raise ValueError(
            "not a checkpoint of this package (no port marker): a file "
            "written by mcmcpp_tpu is read with np.load and "
            "convert.sampler_from_jax_checkpoint"
        )
    version = meta.get("format", 0)
    if version != _FORMAT_VERSION:
        raise ValueError(
            f"incompatible checkpoint format {version} (this build reads "
            f"{_FORMAT_VERSION}); re-save the checkpoint with the version "
            "that wrote it, or resume from raw samples"
        )
    kind = meta["kind"]
    if kind not in _LOADERS:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    _refuse_mismatch(sampler, meta, arrays, allow_device_change)

    def dev(name):
        return torch.from_numpy(arrays[name]).to(sampler.device)

    _LOADERS[kind](sampler, meta, arrays, dev)
    moved = meta["device"] != sampler.device.type
    for name in _GENERATORS:
        if f"rng_{name}" in arrays:
            gen = getattr(sampler, f"_{name}_gen")
            saved = arrays[f"rng_{name}"]
            if moved and name != "host":  # it lived on the file's device
                _reseeded(gen, saved)
            else:
                gen.set_state(torch.from_numpy(saved))
    if getattr(sampler, "chain", None) is not None:
        sampler.chain.clear()
        if arrays["chain_samples"].shape[0]:
            sampler.chain.append(
                from_held(arrays["chain_samples"], meta["chain_dtype"]),
                from_held(arrays["chain_logp"], meta["chain_logp_dtype"]),
            )
    return sampler
