"""What a chain of reduced-precision rows must hold: each stored element is
its float32 value rounded to the nearest representable value, ties to even
(torch's cast), compared as raw bits."""

import torch

BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


def held_bits(x, dtype):
    """``x`` rounded to ``dtype``, as its raw bits."""
    return x.to(dtype).view(BITS[dtype])


def mismatches(stored_bits, x, dtype):
    """Elements of ``stored_bits`` (raw bits of ``dtype``) that are not
    ``x`` rounded to ``dtype``."""
    want = held_bits(x, dtype)
    return int((stored_bits.to(want.device).view(want.dtype) != want).sum())
