"""Complementary-walker selection: shared-shift (roll), per-block (block)
and per-walker (gather) modes.

PyTorch counterpart of ``mcmcpp_tpu/ops/partner.py``, whose docstring has the
validity argument (the pairing is drawn independently of the chain state) and
the TPU measurements that chose each mode. As with the movers, each JAX
function that draws and selects is split in two:

    noise = draw_partner_noise(gen, n, m, k, mode, device)   # the draws
    select_partners(other, n, noise, mode) -> (k, n, P)       # the gather

The draws per mode:

- ``roll``: k distinct shifts r_j; walker i pairs with ``other[(i + r_j) % m]``.
- ``block``: on the fast path (``n == m``, ``m % 128 == 0``, ``m // 128 >= k``),
  one shift r (1,) and per-128-walker-block offsets q (m/128, k), distinct
  per block; walker i pairs with ``other[(i + r + 128·q[i // 128, j]) % m]``.
  Otherwise the per-walker fallback: distinct shifts s (ceil(n/128), k) in
  [0, m) per block; walker i pairs with ``other[(i + s[i // 128, j]) % m]``.
- ``gather``: (n, k) indices in [0, m), distinct per walker.

Distinct draws use sorted insertion, as the JAX module does. Every draw is a
device tensor and every selection an index gather in int64, so no half-step
waits on the host.

Row offset (a rank's shard of a sharded ensemble, ``parallel/sharded.py``):
the draws are always those of the whole half (n walkers against m), and
``select_partners(other, n_local, noise, mode, row0)`` selects for the n_local
active rows that are global rows row0…row0+n_local−1, against the whole
gathered ``other``: walker i above is global row row0 + i, so roll and block
index ``other`` at that row, and :func:`partner_rows` cuts gather mode's
per-walker draws to the shard's rows. No shard boundary changes which draw a
row gets.
"""

import torch

BLOCK = 128  # walkers per independent-shift group in "block" mode
MODES = ("roll", "block", "gather")


def check_mode(mode):
    """``mode`` if it is a partner mode, else ValueError."""
    if mode not in MODES:
        raise ValueError(f"unknown partner mode {mode!r}")
    return mode


def sorted_insertion(raw):
    """(rows, k) values distinct per row from k raw draws, the t-th in
    [0, bound − t): each is bumped past the row's earlier values in
    increasing order, which is exact uniform sampling without replacement."""
    cols = []
    for d in raw:
        if cols:
            prev = torch.sort(torch.stack(cols, dim=-1), dim=-1).values
            for s in range(len(cols)):
                d = d + (d >= prev[:, s]).to(d.dtype)
        cols.append(d)
    return torch.stack(cols, dim=-1)


def distinct_batch(gen, n_rows, bound, k, device, dtype=torch.int64):
    """(n_rows, k) draws in [0, bound), without replacement per row (the
    batched form of :func:`distinct_shifts`)."""
    if k > bound:
        raise ValueError(f"need {k} distinct draws from only {bound} values")
    return sorted_insertion([
        torch.randint(0, bound - t, (n_rows,), generator=gen, device=device,
                      dtype=dtype)
        for t in range(k)
    ])


def distinct_shifts(gen, m, k, device):
    """k distinct uniform shifts in [0, m) as a (k,) int32 device tensor."""
    if k > m:
        raise ValueError(f"need {k} distinct shifts from only {m} values")
    return distinct_batch(gen, 1, m, k, device, torch.int32)[0]


def block_fast_path(n, m, k, block=BLOCK):
    """The JAX module's condition for block mode's block-granular path."""
    return n == m and m % block == 0 and m // block >= k


def draw_partner_noise(gen, n, m, k, mode, device, block=BLOCK):
    """Every random draw of ``select_partners(other, n, ·, mode)`` for k
    partners of n active walkers among m (``block``: walkers per shift
    group in block mode)."""
    check_mode(mode)
    if mode == "roll":
        if n != m:
            raise ValueError(
                f"roll mode requires equal halves (n={n}, m={m})"
            )
        return distinct_shifts(gen, m, k, device)
    if mode == "block":
        if block_fast_path(n, m, k, block):
            r = torch.randint(0, m, (1,), generator=gen, device=device)
            return r, distinct_batch(gen, m // block, m // block, k, device)
        return (distinct_batch(gen, -(-n // block), m, k, device),)
    return distinct_batch(gen, n, m, k, device)


def partner_rows(noise, mode, row0, n):
    """The partner draws of rows row0…row0+n−1 from the draws of a whole
    half: gather mode's (n_half, k) rows; roll's shifts and block's per-group
    draws, which the selection indexes by global row, as they are."""
    return noise[row0:row0 + n] if mode == "gather" else noise


def _global_rows(other, n, row0):
    m = other.shape[0]
    if not 0 <= row0 <= m - n:
        raise ValueError(f"active rows {row0}…{row0 + n - 1} do not lie in "
                         f"the other half's {m} rows")
    return torch.arange(row0, row0 + n, device=other.device,
                        dtype=torch.int64)


def rolled_partners(other, shifts, n=None, row0=0):
    """(k, n, P) stack: row j pairs walker i (global row row0 + i) with
    ``other[(row0 + i + shifts[j]) % m]``; n defaults to m."""
    m = other.shape[0]
    i = _global_rows(other, m if n is None else n, row0)
    idx = (i[None, :] + shifts.to(torch.int64)[:, None]) % m
    return other[idx]


def block_partners(other, n, noise, block=BLOCK, row0=0):
    """(k, n, P) partners with one shift per ``block``-walker group (see
    the module docstring for the two paths), for global rows row0…"""
    m = other.shape[0]
    i = _global_rows(other, n, row0)
    if len(noise) == 2:  # fast path: (r, q)
        r, q = noise
        if not block_fast_path(m, m, q.shape[1], block):
            raise ValueError("block fast-path draws need n == m, "
                             f"m % {block} == 0 and m // {block} >= k")
        offset = block * q.to(torch.int64)[i // block].T       # (k, n)
        idx = (i[None, :] + r.to(torch.int64) + offset) % m
    else:  # per-walker fallback: (s,)
        (s,) = noise
        # an int repeat count: a tensor of counts would sync to size the
        # output
        per_walker = s.to(torch.int64).T.repeat_interleave(block, dim=1)
        idx = (i[None, :] + per_walker[:, row0:row0 + n]) % m
    return other[idx]


def select_partners(other, n, noise, mode="roll", row0=0):
    """(k, n, P) partners for n active walkers, global rows row0…, from the
    draws of :func:`draw_partner_noise` (gather mode's cut to these rows by
    :func:`partner_rows`)."""
    check_mode(mode)
    if mode == "roll":
        # the draw refused unequal halves; here the rows must lie in other
        return rolled_partners(other, noise, n, row0)
    if mode == "block":
        return block_partners(other, n, noise, row0=row0)
    return other[noise.to(torch.int64).T]
