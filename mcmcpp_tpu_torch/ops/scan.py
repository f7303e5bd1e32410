"""A parallel prefix scan over a leading time axis.

torch has no public associative scan, and ``torch._higher_order_ops.
associative_scan`` is private. This is the recursion of JAX's
``lax.associative_scan`` (Blelloch 1990), so that, with the same tree of
combinations, the port's float results match the JAX package's up to each
combine's own arithmetic:

1. combine adjacent pairs ``(e[0], e[1]), (e[2], e[3]), …``;
2. scan those ⌊T/2⌋ pair results recursively: they are the odd prefixes;
3. combine each odd prefix with the next even element: the even prefixes;
4. interleave, with ``e[0]`` first.

So a scan is O(log T) levels of one batched ``fn`` call on a (≈T/2^k, …)
slice each, and nothing branches on a tensor's value: no host sync.
"""

import torch

__all__ = ["associative_scan"]


def _interleave(even, odd):
    """(even[0], odd[0], even[1], odd[1], …) on the leading axis, where
    ``even`` has as many rows as ``odd`` or one more."""
    n = even.shape[0] + odd.shape[0]
    out = even.new_empty((n,) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def _scan(fn, elems):
    num = elems[0].shape[0]
    if num < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = _scan(fn, tuple(reduced))
    if num % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(tuple(odd), tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r], 0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def associative_scan(fn, elems, reverse=False):
    """Inclusive scan of ``elems`` along their leading (time) axis with the
    associative ``fn``: ``[e0, fn(e0, e1), fn(fn(e0, e1), e2), …]``.

    ``elems`` is a tensor or a tuple (or list) of tensors with one leading
    length T; ``fn(a, b)`` takes and returns a tuple of the same structure,
    batched over the leading axis (≙ ``jax.lax.associative_scan``'s
    contract). ``reverse=True`` scans from the end: ``[…, fn(fn(z, y), x),
    fn(z, y), z]``. Returns the structure of ``elems``."""
    single = isinstance(elems, torch.Tensor)
    parts = (elems,) if single else tuple(elems)
    if len({int(e.shape[0]) for e in parts}) != 1:
        raise ValueError("associative_scan: the elements' leading axes "
                         f"differ: {[tuple(e.shape) for e in parts]}")
    call = ((lambda a, b: (fn(a[0], b[0]),)) if single
            else (lambda a, b: tuple(fn(a, b))))
    if reverse:
        parts = tuple(torch.flip(e, (0,)) for e in parts)
    out = _scan(call, parts)
    if reverse:
        out = tuple(torch.flip(e, (0,)) for e in out)
    if single:
        return out[0]
    return type(elems)(out) if isinstance(elems, list) else out
