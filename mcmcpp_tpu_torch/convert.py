"""Carry targets, sampler states and mover states across from the JAX
package.

The caller takes numpy arrays from the JAX objects (``np.asarray`` of a
``mcmcpp_tpu`` state's fields, the ``prec_chol`` a Gaussian target closes
over, or the ``name``, ``dim``, ``mean``, ``cov`` and ``extras`` of a
``mcmcpp_tpu.models.Target``); this module builds the port's objects from
them. It imports nothing of JAX.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.models.targets import (
    BayesianLinearRegression,
    GaussianMixture,
    GaussianTarget,
    LogisticRegression,
    NealFunnel,
    Rosenbrock,
)
from mcmcpp_tpu_torch.sampler import EnsembleState

__all__ = ["GaussianTarget", "mover_state_from_numpy",
           "sampler_from_jax_checkpoint", "state_from_numpy",
           "target_from_numpy"]


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


def sampler_from_jax_checkpoint(arrays, meta, sampler):
    """Load an ensemble checkpoint written by the JAX package into a port
    sampler, so that a long run begun there goes on here.

    ``arrays`` and ``meta`` are the file's contents as numpy and a dict::

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}

    Walkers, log-probs, the per-walker accept counters (device and host),
    the step counter with its reset base, and the stored chain are carried
    over, so ``total_steps``, ``acceptance_fraction`` and ``get_samples``
    read as they did. The threefry key is not: the port draws from another
    generator family, so the resumed chain continues under the port's own
    ``seed``, as a valid continuation but not the one the JAX package would
    have drawn. Returns the sampler.
    """
    if meta.get("port") is not None:
        raise ValueError(
            f"a checkpoint of the {meta['port']} port, not of the JAX "
            "package: load it with io.load_checkpoint")
    if meta.get("kind") != "ensemble":
        raise ValueError(
            f"checkpoint kind {meta.get('kind')!r}: only the ensemble "
            "sampler's state can be carried across")
    if meta["n_params"] != sampler.n_params:
        raise ValueError(
            f"checkpoint has n_params={meta['n_params']}, "
            f"sampler has {sampler.n_params}")
    if meta["n_walkers"] != sampler.n_walkers:
        raise ValueError("walker count mismatch")
    sampler.state = state_from_numpy(
        *(arrays[k] for k in ("red", "black", "logp_red", "logp_black",
                              "accepted_red", "accepted_black", "step")),
        device=sampler.device)
    awh = np.asarray(arrays["accepted_walkers_host"])
    sampler._accepted_walkers_host = (
        awh.astype(np.int64) if awh.shape[0] else None)
    sampler._reset_step_base = int(meta["reset_step_base"])
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
