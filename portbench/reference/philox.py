"""Philox4x32-10 and the stretch move's uniforms, in int64 tensor ops.

Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1, 2,
3" (SC'11), with the Random123 constants. Walker i of a half-step with the
64-bit key k draws counter (i_lo, i_hi, 0, 0): word 0 gives u (the stretch
factor), word 1 gives ue (the accept test), each as its top 24 bits times
2^-24, floored at 2^-25 so that its log is finite.
"""

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
UNIT_FLOOR = 2.0 ** -25


def philox4x32(counter, key):
    """Ten rounds on four int64 tensors of 32-bit words and a key of two
    Python ints; a 32×32-bit product may wrap in int64, but its low 64 bits
    stay exact, so its high word is ``(prod >> 32) & MASK32``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0, p1 = M0 * c0, M1 * c2
        c0, c1, c2, c3 = (((p1 >> 32) & MASK32) ^ c1 ^ k0, p1 & MASK32,
                          ((p0 >> 32) & MASK32) ^ c3 ^ k1, p0 & MASK32)
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def unit(bits):
    """32 random bits (int64) -> float32 in [2^-25, 1)."""
    return ((bits >> 8).to(torch.float32) * 2.0 ** -24).clamp_(min=UNIT_FLOOR)


def uniforms(key, row0, n, device):
    """(u, ue), float32 (n,), of rows row0…row0+n−1 under ``key``."""
    key = int(key)
    i = torch.arange(row0, row0 + n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(i)
    w0, w1, _, _ = philox4x32((i & MASK32, i >> 32, zero, zero),
                              (key & MASK32, key >> 32))
    return unit(w0), unit(w1)
