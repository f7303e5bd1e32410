"""The Goodman–Weare stretch half-step (Goodman and Weare 2010; emcee's
stretch move), in any float dtype.

Walker i of the active half (global row row0 + i) pairs with
``other[(row0 + i + shift) % m]``, draws z = ((√a − 1/√a)·u + 1/√a)², whose
density is ∝ 1/√z on [1/a, a], proposes y = partner + z·(x − partner) and
accepts iff log(ue) < (P − 1)·log z + logp(y) − logp(x).
"""

import math

import torch

from . import gaussian, philox

ROWS = 1 << 18


def half_step(active, other, shift, key, prec_chol, a=2.0, row0=0,
              dtype=torch.float64):
    """The half-step of ``active`` (n, P) against ``other`` (m, P),
    computed in ``dtype`` in blocks of rows. Returns a dict of tensors in
    ``dtype``: ``proposal`` (n, P), ``lp_proposal``, ``lp_active``,
    ``log_ratio`` ((P − 1)·log z + lp_proposal − lp_active), ``log_ue``,
    ``accept`` (bool) and ``scale`` (the rounding scale of the log ratio:
    ``gaussian.rounding_scale`` of the proposal plus that of the active
    row), each (n,)."""
    n, p = active.shape
    m = other.shape[0]
    dev = active.device
    span = math.sqrt(a) - 1.0 / math.sqrt(a)
    lo = 1.0 / math.sqrt(a)
    lc = prec_chol.to(dtype)
    out = {
        "proposal": torch.empty((n, p), dtype=dtype, device=dev),
        "lp_proposal": torch.empty((n,), dtype=dtype, device=dev),
        "lp_active": torch.empty((n,), dtype=dtype, device=dev),
        "log_ratio": torch.empty((n,), dtype=dtype, device=dev),
        "log_ue": torch.empty((n,), dtype=dtype, device=dev),
        "scale": torch.empty((n,), dtype=dtype, device=dev),
    }
    for r in range(0, n, ROWS):
        k = min(ROWS, n - r)
        u, ue = philox.uniforms(key, row0 + r, k, dev)
        rows = torch.arange(row0 + r, row0 + r + k, device=dev)
        partner = other[(rows + int(shift)) % m].to(dtype)
        x = active[r:r + k].to(dtype)
        z = torch.square(span * u.to(dtype) + lo)
        y = partner + z[:, None] * (x - partner)
        lp_y = gaussian.logp(y, lc, dtype)
        lp_x = gaussian.logp(x, lc, dtype)
        out["proposal"][r:r + k] = y
        out["lp_proposal"][r:r + k] = lp_y
        out["lp_active"][r:r + k] = lp_x
        out["log_ratio"][r:r + k] = (p - 1) * torch.log(z) + lp_y - lp_x
        out["log_ue"][r:r + k] = torch.log(ue.to(dtype))
        out["scale"][r:r + k] = (gaussian.rounding_scale(y, lc, dtype)
                                 + gaussian.rounding_scale(x, lc, dtype))
    out["accept"] = out["log_ue"] < out["log_ratio"]
    return out


def outputs(step, active):
    """The half-step's result as a sampler holds it: (rows, logp, accepted
    as int32), the proposal where accepted, else the active row."""
    acc = step["accept"]
    rows = torch.where(acc[:, None], step["proposal"],
                       active.to(step["proposal"].dtype))
    lp = torch.where(acc, step["lp_proposal"], step["lp_active"])
    return rows, lp, acc.to(torch.int32)
