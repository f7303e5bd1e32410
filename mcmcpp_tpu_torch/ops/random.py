"""Generator construction and the per-half-step draws.

Replaces ``mcmcpp_tpu/ops/random.py::split_for_step``: where the JAX package
folds the step counter into a threefry key, the port carries explicit
``torch.Generator`` objects on the sampler's device and draws from them in a
fixed order. Streams are domain-separated by seeding each generator from
``SeedSequence([seed, stream])``. All draws stay on the device, except those
of ``HOST_STREAM``: a CPU generator for the draws that pick host-side control
flow (the mixture mover's branch, which JAX drew on the device and ran with
``lax.switch``), so that no half-step waits on the device to branch, and for
the fused stretch move's Philox key.

The fused stretch half-step's uniforms are not drawn from a generator at all:
they are a pure function of a 64-bit key and the walker's index,
Philox4x32-10 on counter ``(i_lo, i_hi, 0, 0)``, word 0 giving u and word 1
ue. The CUDA kernels compute them in registers
(``csrc/stretch_common.cuh``), as the Pallas kernel drew its uniforms from
the TPU's generator inside its body; :func:`philox_unit_uniforms` is their
plain twin in torch integer ops, bit for bit, and is what the CPU path and
the kernel-against-plain comparisons use.
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


def exponential(gen, n, dtype, device):
    """(n,) draws of Exp(1); ``n`` may also be a shape tuple."""
    shape = n if isinstance(n, tuple) else (n,)
    e = torch.empty(shape, dtype=dtype, device=device)
    return e.exponential_(generator=gen)


def neg_exponential(gen, n, dtype, device):
    """(n,) (or shape ``n``) draws of −Exp(1): the log of a uniform, never
    −inf's log(0)."""
    return exponential(gen, n, dtype, device).neg_()


def gumbel(gen, shape, dtype, device):
    """Standard Gumbel draws of ``shape``, −log(−log u): out of place, so a
    hook under ``torch.func.vmap(randomness="different")`` may call it
    (the in-place ``exponential_`` may not draw into an unbatched tensor
    there)."""
    u = torch.rand(tuple(shape), generator=gen, dtype=dtype, device=device)
    return -torch.log(-torch.log(u))


def bernoulli(gen, shape, device, p=0.5):
    """Booleans of ``shape``, True with probability ``p``."""
    return torch.rand(shape, generator=gen, device=device) < p


def randint(gen, low, high, shape, device):
    """int64 draws of ``shape``, uniform on [low, high)."""
    return torch.randint(low, high, shape, generator=gen, device=device)


# Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11; the Random123 constants)
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def philox4x32(counter, key):
    """Philox4x32-10 in int64 tensor ops: ``counter`` is four int64 tensors
    of one shape and ``key`` two Python ints, all holding 32-bit words;
    returns the four output words as int64 tensors.

    A 32×32-bit product can pass 2^63 and wraps in int64, but its low 64
    bits are still the product's, so the high word is
    ``(prod >> 32) & 0xFFFFFFFF`` whatever the sign.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0, p1 = _PHILOX_M0 * c0, _PHILOX_M1 * c2
        c0, c1, c2, c3 = (((p1 >> 32) & _MASK32) ^ c1 ^ k0, p1 & _MASK32,
                          ((p0 >> 32) & _MASK32) ^ c3 ^ k1, p0 & _MASK32)
        k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def bits_to_unit(bits):
    """32 random bits (int64 tensor) -> float32 uniforms in [2^-25, 1): the
    top 24 bits times 2^-24, exact in float32, floored so that the log is
    finite (≙ ``_bits_to_unit``, ``mcmcpp_tpu/ops/pallas_stretch.py:39-48``)."""
    unit = (bits >> 8).to(torch.float32) * 2.0 ** -24
    return unit.clamp_(min=UNIT_FLOOR)


def philox_unit_uniforms(key, n, device, row0=0):
    """(u, ue), two (n,) float32 planes: the uniforms that the stretch
    kernels draw for walkers row0…row0+n−1 of a half-step with the 64-bit
    ``key`` (a Python int), bit for bit (the counters of a launch over a
    row shard, ``csrc/stretch_common.cuh``)."""
    key = int(key)
    if not 0 <= key < 1 << 64:
        raise ValueError(f"a Philox key is a 64-bit unsigned int, got {key}")
    i = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(i)
    w0, w1, _, _ = philox4x32((i & _MASK32, i >> 32, zero, zero),
                              (key & _MASK32, key >> 32))
    return bits_to_unit(w0), bits_to_unit(w1)


def draw_key(host_gen):
    """A 64-bit Philox key as a Python int, from a CPU generator: two
    32-bit words in one draw, with no device involved."""
    lo, hi = torch.randint(0, 1 << 32, (2,), generator=host_gen,
                           dtype=torch.int64).tolist()
    return (hi << 32) | lo
