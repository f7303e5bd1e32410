"""Carry a target and a sampler state across from the JAX package.

The caller takes numpy arrays from the JAX objects (``np.asarray`` of a
``mcmcpp_tpu`` state's fields, or the ``prec_chol`` a target closes over);
this module builds the port's objects from them. It imports nothing of JAX.
"""

import numpy as np
import torch

from mcmcpp_tpu_torch.models.targets import GaussianTarget
from mcmcpp_tpu_torch.sampler import EnsembleState

__all__ = ["GaussianTarget", "state_from_numpy"]


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
