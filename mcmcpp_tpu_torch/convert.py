"""Carry targets, sampler states and mover states across from the JAX
package.

The caller takes numpy arrays from the JAX objects (``np.asarray`` of a
``mcmcpp_tpu`` state's fields, the ``prec_chol`` a Gaussian target closes
over, the covariance of a dense metric, the ``name``, ``dim``, ``mean``,
``cov`` and ``extras`` of a ``mcmcpp_tpu.models.Target``, the
``jax.tree_util.tree_leaves`` of a flow's params or of an optax Adam state);
this module builds the port's objects from them. It imports nothing of JAX.
"""

import warnings

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.chees import AdamState
from mcmcpp_tpu_torch.gradient.hmc import HMCState
from mcmcpp_tpu_torch.gradient.meads import MEADSSampler, MEADSState
from mcmcpp_tpu_torch.gradient.mclmc import MAMSSampler, MCLMCState
from mcmcpp_tpu_torch.gradient.metric import dense_mass_from_cov
from mcmcpp_tpu_torch.gradient.sgmcmc import SGState
from mcmcpp_tpu_torch.io.checkpoint import (
    _LOADERS,
    FOR_SAMPLER,
    SHARED_LOADERS,
    checkpoint_kind,
    load_pt_state,
    refuse_geometry,
)

from mcmcpp_tpu_torch.models.targets import (
    BayesianLinearRegression,
    GaussianMixture,
    GaussianTarget,
    LogisticRegression,
    NealFunnel,
    Rosenbrock,
)
from mcmcpp_tpu_torch.optim import adam_from_leaves
from mcmcpp_tpu_torch.sampler import EnsembleState
from mcmcpp_tpu_torch.vi import FullRankParams, MeanFieldParams

__all__ = ["GaussianTarget", "adam_state_from_numpy", "advi_params_from_numpy",
           "dense_mass_from_numpy", "flow_params_from_numpy",
           "gradient_state_from_numpy", "lgss_params_from_numpy",
           "mover_state_from_numpy", "sampler_from_jax_checkpoint",
           "state_from_numpy", "target_from_numpy"]


def _tensor(x, device, dtype=np.float32):
    # a copy: the JAX package's host arrays are read-only views
    return torch.from_numpy(np.array(x, dtype)).to(device)


def state_from_numpy(red, black, logp_red, logp_black, accepted_red,
                     accepted_black, step, device="cuda"):
    """The port's :class:`EnsembleState` from numpy arrays (float32
    positions and logps, int32 per-walker accept counters)."""

    # copies: the JAX package's host arrays are read-only views
    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    def i32(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    red, black = f32(red), f32(black)
    if red.shape != black.shape:
        raise ValueError(f"red {tuple(red.shape)} and black "
                         f"{tuple(black.shape)} halves differ")
    return EnsembleState(
        red=red, black=black,
        logp_red=f32(logp_red), logp_black=f32(logp_black),
        accepted_red=i32(accepted_red), accepted_black=i32(accepted_black),
        step=int(step),
    )


def gradient_state_from_numpy(position, logp, grad, momentum=None,
                              device="cuda"):
    """The port's state of a gradient sampler from numpy arrays (float32):
    an ``HMCState``, or a ``MEADSState`` when ``momentum`` is given."""
    if momentum is None:
        return HMCState(*(_tensor(x, device) for x in (position, logp, grad)))
    return MEADSState(*(_tensor(x, device)
                        for x in (position, momentum, logp, grad)))


def dense_mass_from_numpy(cov, device="cuda"):
    """The port's :class:`DenseMassMatrix` from a numpy covariance (the
    ``cov`` field of the JAX package's), factored on ``device``."""
    return dense_mass_from_cov(_tensor(cov, device))


@torch.no_grad()
def flow_params_from_numpy(flow, leaves):
    """Copy a JAX flow's params, given as ``jax.tree_util.tree_leaves(params)``
    (numpy), into the port's ``flow`` (RealNVP, IAF or SplineCoupling of the
    same configuration): the layouts are the same, an MLP weight ``(in,
    out)``, so leaf i is parameter i. Returns ``flow``."""
    params = flow.param_list()
    if len(leaves) != len(params):
        raise ValueError(f"{type(flow).__name__} has {len(params)} "
                         f"parameters, got {len(leaves)} leaves")
    for p, a in zip(params, leaves):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"leaf of shape {a.shape} for a parameter of "
                             f"shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(a)).to(p.device, p.dtype))
    return flow


def adam_state_from_numpy(leaves, params):
    """The port's Adam state (:mod:`mcmcpp_tpu_torch.optim`) from an optax
    ``adam`` state's ``jax.tree_util.tree_leaves``: ``ScaleByAdamState(count,
    mu, nu)`` then the learning rate's empty state, i.e. ``[count, *mu,
    *nu]``, over the tensors ``params``."""
    return adam_from_leaves(leaves, params)


def advi_params_from_numpy(mu, second, full_rank, device="cuda",
                           dtype=torch.float32):
    """The port's ``MeanFieldParams(mu, log_sigma)`` or
    ``FullRankParams(mu, chol_raw)`` from the JAX package's fields."""
    cls = FullRankParams if full_rank else MeanFieldParams
    return cls(*(torch.from_numpy(np.array(a)).to(device, dtype)
                 for a in (mu, second)))


def lgss_params_from_numpy(params, dtype=torch.float32, device="cuda"):
    """The port's :class:`~mcmcpp_tpu_torch.models.lgss.LGSSParams` from a
    JAX ``LGSSParams``'s fields as numpy (the namedtuple itself, or its
    eight arrays A, b, Q, H, c, R, m0, P0 in order), time-varying axes
    kept."""
    from mcmcpp_tpu_torch.models.lgss import LGSSParams

    return LGSSParams(*(torch.from_numpy(np.array(a)).to(device, dtype)
                        for a in params))


def _refuse_mclmc(kind, meta, sampler):
    """The JAX package's rule for the MCLMC family: ``mams`` loads only into
    a MAMSSampler; ``mclmc`` with the adjusted marker only into an
    unadjusted MCLMCSampler, and a legacy ``mclmc`` file (no marker) into
    either, with a warning under MAMS."""
    family = checkpoint_kind(sampler)
    if family not in ("mclmc", "mams") or (kind == "mams"
                                           and family != "mams"):
        raise TypeError(f"checkpoint is for {FOR_SAMPLER[kind]}")
    if kind == "mclmc" and family == "mams":
        if "adjusted" in meta:
            raise TypeError(
                "checkpoint is for an (unadjusted) MCLMCSampler — resuming "
                "it under MAMS would silently change the algorithm")
        warnings.warn(
            "legacy MCLMC checkpoint without an adjusted/unadjusted marker: "
            "resuming under MAMS with the sampler's current target_accept",
            UserWarning)


def _jax_gradient(arrays, meta, sampler):
    dev = sampler.device
    sampler.state = gradient_state_from_numpy(
        arrays["position"], arrays["logp"], arrays["grad"],
        arrays.get("momentum"), device=dev)
    step_size = np.asarray(arrays["step_size"])
    sampler.step_size = (float(step_size) if step_size.ndim == 0
                         else _tensor(step_size, dev))
    sampler.inv_mass = (
        dense_mass_from_numpy(arrays["inv_mass_cov"], dev)
        if sampler.metric == "dense" else _tensor(arrays["inv_mass"], dev))
    div = arrays.get("stat_diverging")
    sampler._divergences = ([np.array(div, bool)]
                            if div is not None and div.shape[0] else [])
    en = arrays.get("stat_energy")
    sampler._energies = ([np.array(en, np.float32)]
                         if en is not None and en.shape[0] else [])
    if "traj_length" in meta and hasattr(sampler, "traj_length"):
        sampler.traj_length = float(meta["traj_length"])
    if hasattr(sampler, "_sadapt"):
        sampler._sadapt = None if "sadapt_log_traj" not in arrays else (
            _tensor(arrays["sadapt_log_traj"], "cpu"),
            AdamState(m=_tensor(arrays["sadapt_m"], "cpu"),
                      v=_tensor(arrays["sadapt_v"], "cpu"),
                      count=int(arrays["sadapt_count"])))


def _jax_sgmcmc(arrays, meta, sampler):
    dev = sampler.device
    sampler.state = SGState(_tensor(arrays["position"], dev),
                            _tensor(arrays["velocity"], dev),
                            int(arrays["sg_step"]))


def _jax_mclmc(arrays, meta, sampler):
    dev = sampler.device
    sampler.state = MCLMCState(*(_tensor(arrays[k], dev)
                                 for k in MCLMCState._fields))
    sampler.step_size = float(meta["step_size"])
    sampler.decoherence_length = float(meta["decoherence_length"])
    sampler.energy_var = float(meta["energy_var"])
    sampler.inv_mass = (np.asarray(arrays["inv_mass"]) if "inv_mass" in arrays
                        else None)
    if meta["kind"] == "mams" and isinstance(sampler, MAMSSampler):
        sampler.target_accept = float(meta["target_accept"])
        sampler.last_mean_accept = float(meta["last_mean_accept"])


def _jax_ensemble(arrays, meta, sampler):
    sampler.state = state_from_numpy(
        *(arrays[k] for k in ("red", "black", "logp_red", "logp_black",
                              "accepted_red", "accepted_black", "step")),
        device=sampler.device)
    awh = np.asarray(arrays["accepted_walkers_host"])
    sampler._accepted_walkers_host = (
        awh.astype(np.int64) if awh.shape[0] else None)
    sampler._reset_step_base = int(meta["reset_step_base"])


def _jax_pt(arrays, meta, sampler):
    # the arrays' own dtypes: the counters are int32, the grids float32
    load_pt_state(sampler, arrays, lambda name: torch.from_numpy(
        np.array(arrays[name])).to(sampler.device))


def _jax_pcn(arrays, meta, sampler):
    from mcmcpp_tpu_torch.pcn import PCNState

    dev = sampler.device
    sampler.state = PCNState(_tensor(arrays["position"], dev),
                             _tensor(arrays["loglike"], dev),
                             _tensor(arrays["accepted"], dev, np.int32))
    sampler.total_steps = int(meta["total_steps"])
    if "beta" in meta:
        sampler.beta = float(meta["beta"])


def _jax_elliptical(arrays, meta, sampler):
    from mcmcpp_tpu_torch.elliptical import EllipticalState

    dev = sampler.device
    sampler.state = EllipticalState(_tensor(arrays["position"], dev),
                                    _tensor(arrays["loglike"], dev))


def _jax_gibbs(arrays, meta, sampler):
    sampler.state = {name: _tensor(arrays[f"block_{name}"], sampler.device)
                     for name, _ in sampler._layout}


def _jax_pmmh(arrays, meta, sampler):
    # the arrays' own dtypes (the accept counters int32), then the
    # sampler's float dtype
    _LOADERS["pmmh"](sampler, meta, arrays, lambda name: torch.from_numpy(
        np.array(arrays[name])).to(sampler.device))
    sampler.state = sampler.state._replace(**{
        k: getattr(sampler.state, k).to(sampler.dtype)
        for k in ("position", "loglik", "logprior")})


_JAX_LOADERS = {"ensemble": _jax_ensemble, "gradient": _jax_gradient,
                "sgmcmc": _jax_sgmcmc, "mclmc": _jax_mclmc,
                "mams": _jax_mclmc, "pt": _jax_pt, "pcn": _jax_pcn,
                "elliptical": _jax_elliptical, "gibbs": _jax_gibbs,
                "pmmh": _jax_pmmh}


def sampler_from_jax_checkpoint(arrays, meta, sampler):
    """Load a checkpoint written by the JAX package into a port sampler, so
    that a long run begun there goes on here.

    ``arrays`` and ``meta`` are the file's contents as numpy and a dict::

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}

    Kinds ``ensemble`` (walkers, log-probs, the per-walker accept counters,
    the step counter with its reset base), ``gradient`` (state, step sizes,
    ``inv_mass`` or the dense ``inv_mass_cov``, ChEES's ``traj_length`` and
    ``sadapt_*``, MEADS's momenta, the sample stats), ``sgmcmc`` (position,
    velocity, the decay schedule's step) and ``mclmc``/``mams`` (state, step
    size, decoherence length, metric, MAMS's tuning), ``pt`` (the replica
    grids, the step, the swap counters on the device and the host, the
    ladder, and in power mode the log-likelihood grids and the evidence
    accumulators; the cold chain), ``pcn`` (state, accept counters, steps,
    the tuned β), ``elliptical`` (state) and ``gibbs`` (every block, after a
    check of the block layout), each with the stored chain, so that
    ``get_samples`` and the statistics read as they did; and ``smc`` (the
    particle state, the stage count and β ladder, the flow mutation's
    parameters and Adam state), ``nested`` (the live set and the host
    ledger; ``run()`` continues), ``neutra`` (the flow's parameters, the
    Adam state, the fit traces) and ``advi`` (the variational parameters,
    the Adam state, the ELBO trace). The
    threefry key is not carried: the port draws from another generator
    family, so the resumed chain continues under the port's own ``seed``,
    as a valid continuation but not the one the JAX package would have
    drawn. Returns the sampler.
    """
    if meta.get("port") is not None:
        raise ValueError(
            f"a checkpoint of the {meta['port']} port, not of the JAX "
            "package: load it with io.load_checkpoint")
    kind = meta.get("kind")
    if kind not in _JAX_LOADERS and kind not in SHARED_LOADERS:
        raise ValueError(
            f"checkpoint kind {kind!r}: only the ensemble sampler's, the "
            "gradient engines', the population engines' (pt, pcn, "
            "elliptical, gibbs), the evidence and variational engines' "
            "(smc, nested, neutra, advi) and the time-series engines' "
            "(pmmh, ibis, smc2) states can be carried across")
    if kind in ("mclmc", "mams"):
        _refuse_mclmc(kind, meta, sampler)
    elif checkpoint_kind(sampler) != kind:
        raise TypeError(f"checkpoint is for {FOR_SAMPLER[kind]}")
    if meta["n_params"] != sampler.n_params:
        raise ValueError(
            f"checkpoint has n_params={meta['n_params']}, "
            f"sampler has {sampler.n_params}")
    refuse_geometry(kind, meta, sampler)
    if kind == "gradient":
        # the JAX package marks only a dense metric
        if meta.get("metric", "diag") != sampler.metric:
            raise ValueError(
                f"checkpoint has metric={meta.get('metric', 'diag')!r}, "
                f"sampler has {sampler.metric!r}")
        if ("momentum" in arrays) != isinstance(sampler, MEADSSampler):
            raise TypeError("a MEADS checkpoint (it carries momenta) loads "
                            "into a MEADSSampler and no other")
    if kind in SHARED_LOADERS:
        # the JAX package's arrays and leaves under the same names
        _LOADERS[kind](sampler, meta, arrays, lambda name: torch.from_numpy(
            np.array(arrays[name])).to(sampler.device))
        return sampler
    _JAX_LOADERS[kind](arrays, meta, sampler)
    sampler.chain.clear()
    if arrays["chain_samples"].shape[0]:
        sampler.chain.append(np.asarray(arrays["chain_samples"]),
                             np.asarray(arrays["chain_logp"]))
    return sampler


def mover_state_from_numpy(state, device="cuda"):
    """A mover state (MH, DRAM, AR, Sequence: a dict of arrays; a mixture:
    a tuple of its movers' states; ``()`` for none) with every array a
    float32 tensor on ``device``."""
    if isinstance(state, dict):
        return {k: mover_state_from_numpy(v, device) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(mover_state_from_numpy(v, device) for v in state)
    return torch.from_numpy(np.array(state, np.float32)).to(device)


def target_from_numpy(name, dim, mean=None, cov=None, extras=None,
                      device="cuda"):
    """The port's target from a JAX ``Target``'s fields: its data (X, y,
    the mixture's means, …) come from ``extras``, so both packages hold the
    same arrays. The linear regression's prior scale, which the JAX target
    does not keep, is recovered from its posterior covariance:
    cov⁻¹ = XᵀX/noise² + I/prior_scale²."""
    extras = dict(extras or {})
    if name == "rosenbrock":
        return Rosenbrock(extras["a"], extras["b"], extras["scale"])
    if name == "gaussian_mixture":
        return GaussianMixture(extras["means"], extras["weights"],
                               extras["scales"], device=device)
    if name == "neal_funnel":
        return NealFunnel(dim, extras["sigma_v"])
    if name == "bayesian_linear_regression":
        x, noise = np.asarray(extras["X"], np.float64), extras["noise"]
        prior_prec = np.linalg.inv(np.asarray(cov)) - x.T @ x / noise ** 2
        prior_scale = 1.0 / np.sqrt(np.mean(np.diag(prior_prec)))
        return BayesianLinearRegression(x, extras["y"], noise, prior_scale,
                                        extras.get("w_true"), device=device)
    if name == "logistic_regression":
        return LogisticRegression(extras["X"], extras["y"],
                                  extras["prior_scale"], extras.get("w_true"),
                                  device=device)
    raise ValueError(f"no port of target {name!r}")
