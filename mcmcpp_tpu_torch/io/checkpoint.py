"""Checkpoint / resume for the ensemble sampler.

Counterpart of ``mcmcpp_tpu/io/checkpoint.py`` (the reference has no
checkpointing, SURVEY.md §5), ensemble kind only. A checkpoint is one
``.npz`` archive holding the device state (walker positions, log-probs,
counters), the state of the sampler's three random generators and the host
chain: enough to resume sampling bitwise-identically to an uninterrupted run
on the same kind of device.

Format: flat name → array dict plus a JSON meta blob; no pickling, so
checkpoints are portable and safe to load from untrusted storage. Array
names are the JAX package's where they mean the same. Where that package
saves one threefry key, this one saves the three ``torch.Generator`` states
(step and auxiliary on the ensemble's device, host on the CPU) as ``uint8``
arrays, and the meta records the device type: a CUDA and a CPU generator
draw different streams, so a checkpoint loads only into a sampler on the
kind of device that wrote it. A chain whose rows are held as raw bits
(bfloat16, 8-bit floats) is saved as those bits beside the dtype's name.
The meta carries ``"port": "torch"`` and a format tag of its own, so
neither package takes the other's file for its own; a file of the JAX
package is read with :func:`mcmcpp_tpu_torch.convert.sampler_from_jax_checkpoint`.
"""

import json
import os
from pathlib import Path

import numpy as np
import torch

from mcmcpp_tpu_torch.chain import from_held

_FORMAT_VERSION = "torch-1"
_PORT = "torch"

# checkpoint kinds of the JAX package whose engines are not ported, with the
# ROADMAP item each waits for
_UNPORTED_KINDS = {
    "gradient": "A8", "sgmcmc": "A8", "mclmc": "A8", "mams": "A8",
    "pt": "A9", "smc": "A9", "nested": "A9", "elliptical": "A9",
    "pcn": "A9", "gibbs": "A9", "neutra": "A9", "advi": "A9",
    "pmmh": "A11", "ibis": "A11", "smc2": "A11",
}

_GENERATORS = ("step", "aux", "host")


def _npz_path(path):
    path = Path(path)
    if path.suffix != ".npz":
        # np.savez appends .npz itself; normalize so the returned path is
        # the file that actually exists
        path = path.with_name(path.name + ".npz")
    return path


def save_checkpoint(sampler, path):
    """Write ``sampler``'s full resumable state to ``path`` (.npz)."""
    from mcmcpp_tpu_torch.sampler import EnsembleSampler

    if not isinstance(sampler, EnsembleSampler):
        raise TypeError(f"unsupported sampler type {type(sampler).__name__}")
    if sampler.state is None:
        raise RuntimeError("cannot checkpoint an uninitialized sampler")
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    chain = sampler.chain
    meta = {
        "format": _FORMAT_VERSION,
        "port": _PORT,
        "class": type(sampler).__name__,
        "kind": "ensemble",
        "n_params": sampler.n_params,
        "n_walkers": sampler.n_walkers,
        "reset_step_base": sampler._reset_step_base,
        "device": sampler.device.type,
        "chain_dtype": chain.dtype.name,
        "chain_logp_dtype": getattr(chain, "logp_dtype", chain.dtype).name,
    }
    s = sampler.state

    def host(t):
        return t.cpu().numpy()

    arrays = dict(
        red=host(s.red), black=host(s.black),
        logp_red=host(s.logp_red), logp_black=host(s.logp_black),
        accepted_red=host(s.accepted_red),
        accepted_black=host(s.accepted_black),
        step=np.asarray(s.step, np.int64),
        accepted_walkers_host=(
            sampler._accepted_walkers_host
            if sampler._accepted_walkers_host is not None
            else np.zeros((0,), np.int64)
        ),
        chain_samples=chain.get(held=True),
        chain_logp=chain.get_logp(held=True),
    )
    for name in _GENERATORS:
        gen = getattr(sampler, f"_{name}_gen")
        arrays[f"rng_{name}"] = gen.get_state().numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    # atomic replace: a crash mid-save must not destroy the previous good
    # checkpoint (the whole point of checkpointing)
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(sampler, path):
    """Restore state saved by :func:`save_checkpoint` into ``sampler``.

    ``sampler`` must be constructed with the same target, shape and device
    type (validated against the stored meta). Returns the sampler.
    """
    from mcmcpp_tpu_torch.sampler import EnsembleSampler, EnsembleState

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
    if kind in _UNPORTED_KINDS:
        raise NotImplementedError(
            f"checkpoint kind {kind!r}: its engine is not ported yet "
            f"(ROADMAP {_UNPORTED_KINDS[kind]})"
        )
    if kind != "ensemble":
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    if not isinstance(sampler, EnsembleSampler):
        raise TypeError("checkpoint is for an EnsembleSampler")
    if meta["n_params"] != sampler.n_params:
        raise ValueError(
            f"checkpoint has n_params={meta['n_params']}, "
            f"sampler has {sampler.n_params}"
        )
    if meta["n_walkers"] != sampler.n_walkers:
        raise ValueError("walker count mismatch")
    if meta["device"] != sampler.device.type:
        raise ValueError(
            f"checkpoint was written on a {meta['device']} sampler and this "
            f"one is on {sampler.device.type}: their generators draw "
            "different streams, so the run would not resume"
        )

    def dev(name):
        return torch.from_numpy(arrays[name]).to(sampler.device)

    sampler.state = EnsembleState(
        red=dev("red"), black=dev("black"),
        logp_red=dev("logp_red"), logp_black=dev("logp_black"),
        accepted_red=dev("accepted_red"),
        accepted_black=dev("accepted_black"),
        step=int(arrays["step"]),
    )
    for name in _GENERATORS:
        getattr(sampler, f"_{name}_gen").set_state(
            torch.from_numpy(arrays[f"rng_{name}"]))
    awh = arrays["accepted_walkers_host"]
    sampler._accepted_walkers_host = (
        awh.astype(np.int64) if awh.shape[0] else None
    )
    sampler._reset_step_base = int(meta["reset_step_base"])
    sampler.chain.clear()
    if arrays["chain_samples"].shape[0]:
        sampler.chain.append(
            from_held(arrays["chain_samples"], meta["chain_dtype"]),
            from_held(arrays["chain_logp"], meta["chain_logp_dtype"]),
        )
    return sampler
