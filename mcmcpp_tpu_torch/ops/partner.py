"""Complementary-walker selection, shared-shift ("roll") mode.

PyTorch counterpart of ``mcmcpp_tpu/ops/partner.py``: one uniform shift r in
[0, m) per half-step pairs walker i with ``other[(i + r) % m]``, i.e.
``roll(other, -r)``. The shift stays a device tensor and the roll is an index
gather, so no half-step waits on the host. The validity argument (the pairing
is independent of the chain state) is in the JAX module's docstring.

Only "roll" is ported; "block" and "gather" raise ``NotImplementedError``.
"""

import torch


def distinct_shifts(gen, m, k, device):
    """k distinct uniform shifts in [0, m) as a (k,) int32 device tensor.

    Sorted-insertion sampling, as in the JAX module: draw d_t in [0, m−t)
    and bump it past each already-chosen value in increasing order.
    """
    if k > m:
        raise ValueError(f"need {k} distinct shifts from only {m} values")
    chosen = []
    for t in range(k):
        d = torch.randint(0, m - t, (1,), generator=gen, device=device,
                          dtype=torch.int32)
        if chosen:
            prev = torch.sort(torch.cat(chosen)).values
            for idx in range(t):
                d = d + (d >= prev[idx]).to(d.dtype)
        chosen.append(d)
    return torch.cat(chosen)


def rolled_partners(other, shifts):
    """(k, m, P) stack: row j pairs walker i with ``other[(i + shifts[j]) % m]``."""
    m = other.shape[0]
    base = torch.arange(m, device=other.device, dtype=torch.int64)
    idx = (base[None, :] + shifts.to(torch.int64)[:, None]) % m
    return other[idx]


def select_partners(other, n, shifts, mode="roll"):
    """(k, n, P) partners for n active walkers, k = len(shifts)."""
    if mode == "roll":
        if other.shape[0] != n:
            raise ValueError(
                f"roll mode requires equal halves (n={n}, m={other.shape[0]})"
            )
        return rolled_partners(other, shifts)
    if mode in ("block", "gather"):
        raise NotImplementedError(
            f"partner mode {mode!r} is not ported yet; use 'roll'"
        )
    raise ValueError(f"unknown partner mode {mode!r}")
