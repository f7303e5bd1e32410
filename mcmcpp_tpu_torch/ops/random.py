"""Generator construction and the per-half-step draws.

Replaces ``mcmcpp_tpu/ops/random.py::split_for_step``: where the JAX package
folds the step counter into a threefry key, the port carries explicit
``torch.Generator`` objects on the sampler's device and draws from them in a
fixed order. Streams are domain-separated by seeding each generator from
``SeedSequence([seed, stream])``. All draws stay on the device, except those
of ``HOST_STREAM``: a CPU generator for the draws that pick host-side control
flow (the mixture mover's branch, which JAX drew on the device and ran with
``lax.switch``), so that no half-step waits on the device to branch.
"""

import numpy as np
import torch

STEP_STREAM = 0
AUX_STREAM = 1
HOST_STREAM = 2

# smallest uniform the fused half-step draws: ≙ _bits_to_unit's floor
# (mcmcpp_tpu/ops/pallas_stretch.py:39-48), so log(u) is always finite
UNIT_FLOOR = 2.0 ** -25


def make_generator(seed, stream, device):
    """A generator on ``device`` for stream ``stream`` of ``seed``."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def uniform(gen, n, dtype, device):
    """(n,) uniforms in [0, 1); ``n`` may also be a shape tuple."""
    shape = n if isinstance(n, tuple) else (n,)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def normal(gen, shape, dtype, device):
    """Standard normals of ``shape``."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def unit_uniform(gen, n, dtype, device):
    """(n,) uniforms in [2^-25, 1)."""
    return uniform(gen, n, dtype, device).clamp_(min=UNIT_FLOOR)


def exponential(gen, n, dtype, device):
    """(n,) draws of Exp(1)."""
    e = torch.empty((n,), dtype=dtype, device=device)
    return e.exponential_(generator=gen)


def neg_exponential(gen, n, dtype, device):
    """(n,) draws of −Exp(1): the log of a uniform, never −inf's log(0)."""
    return exponential(gen, n, dtype, device).neg_()

