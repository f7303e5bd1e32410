"""Adam as optax computes it, over a list of tensors.

The JAX package trains its flows (``neutra.py``, ``smc.py``'s flow mutation)
and ADVI (``vi.py``) with ``optax.adam(learning_rate)``. This is the same
update, functional, with optax's state: ``count`` (a host int here, an int32
scalar in optax), the first moments ``mu`` and the second moments ``nu``, one
tensor per parameter, with b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0:

    mu ← (1 − b1)·g + b1·mu,  nu ← (1 − b2)·g² + b2·nu,  count ← count + 1
    update = −lr · (mu / (1 − b1^count)) / (√(nu / (1 − b2^count) + eps_root) + eps)

The bias corrections ``1 − b^count`` are computed at the parameters' dtype,
as optax computes them at JAX's default float (float32, or float64 under
x64). A checkpoint stores the state as optax's leaves in their order,
``ScaleByAdamState(count, mu, nu)`` then the empty state of the learning-rate
scale: ``[count, *mu, *nu]`` (:func:`adam_leaves`, :func:`adam_from_leaves`).
"""

from typing import NamedTuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8  # and eps_root = 0


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: ``count`` steps taken (a host int),
    ``mu`` and ``nu`` lists of tensors shaped like the parameters."""

    count: int
    mu: list
    nu: list


def adam_init(params):
    """A fresh state for the tensors ``params``."""
    def zeros():
        return [torch.zeros_like(p).detach() for p in params]

    return AdamState(0, zeros(), zeros())


def _bias_correction(decay, count, dtype):
    """``1 − decay^count`` at ``dtype`` (float32 or float64), as a Python
    float holding that dtype's value."""
    at = torch.float64 if dtype == torch.float64 else torch.float32
    return float(1.0 - torch.tensor(decay, dtype=at) ** count)


@torch.no_grad()
def adam_step(params, grads, state, learning_rate):
    """One Adam step applied in place to the tensors ``params``; returns the
    new state. The arithmetic is the per-tensor form above, run as
    ``torch._foreach_*`` ops: a handful of launches for all the parameters at
    once on CUDA (a flow's dozens of tensors would otherwise cost ~15
    launches each)."""
    count = state.count + 1
    grads = list(grads)
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1),
                            torch._foreach_mul(state.mu, B1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2),
        torch._foreach_mul(state.nu, B2))
    dtype = grads[0].dtype
    m_hat = torch._foreach_div(mu, _bias_correction(B1, count, dtype))
    v_hat = torch._foreach_div(nu, _bias_correction(B2, count, dtype))
    # eps_root = 0: √(v̂ + 0) is √v̂
    denom = torch._foreach_add(torch._foreach_sqrt(v_hat), EPS)
    updates = torch._foreach_mul(torch._foreach_div(m_hat, denom),
                                 -float(learning_rate))
    torch._foreach_add_(list(params), updates)  # optax.apply_updates: p + u
    return AdamState(count, mu, nu)


def adam_leaves(state):
    """optax's leaf order of the state: ``[count, *mu, *nu]``, as numpy (the
    count an int32 scalar)."""
    return ([np.asarray(state.count, np.int32)]
            + [m.detach().cpu().numpy() for m in state.mu]
            + [v.detach().cpu().numpy() for v in state.nu])


def adam_from_leaves(leaves, params):
    """A state from optax's leaves ``[count, *mu, *nu]`` (numpy arrays), on
    the device and at the dtype of ``params``, whose shapes they must
    match."""
    n = len(params)
    if len(leaves) != 2 * n + 1:
        raise ValueError(f"an Adam state over {n} parameters has {2 * n + 1} "
                         f"leaves, got {len(leaves)}")

    def tensor(arr, p):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"Adam leaf of shape {arr.shape} for a "
                             f"parameter of shape {tuple(p.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=p.device,
                                                  dtype=p.dtype)

    return AdamState(int(np.asarray(leaves[0])),
                     [tensor(a, p) for a, p in zip(leaves[1:n + 1], params)],
                     [tensor(a, p) for a, p in zip(leaves[n + 1:], params)])
