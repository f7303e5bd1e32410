"""Zero-mean Gaussian targets in the form logp(x) = −½‖x L‖², with L the
lower Cholesky factor of the precision matrix."""

import torch

ROWS = 1 << 18


def logp(x, prec_chol, dtype=torch.float64):
    """−½‖x L‖² of the rows of ``x``, computed in ``dtype`` in blocks of
    rows; returned in ``dtype``."""
    lc = prec_chol.to(dtype)
    out = torch.empty((x.shape[0],), dtype=dtype, device=x.device)
    for r in range(0, x.shape[0], ROWS):
        y = x[r:r + ROWS].to(dtype) @ lc
        out[r:r + ROWS] = -0.5 * (y * y).sum(dim=-1)
    return out


def rounding_scale(x, prec_chol, dtype=torch.float64):
    """Σ_k |(x L)_k|·(|x| |L|)_k of the rows of ``x``, in ``dtype``: the
    first-order size of the rounding error that any evaluation of −½‖x L‖²
    in a lower precision makes, per unit roundoff (each y_k = Σ_j x_j L_jk
    carries up to ~ε·Σ_j |x_j L_jk|, and −½ y_k² that times |y_k|). It is
    |logp| for a well-conditioned target and far more where the sum cancels,
    as for an ill-conditioned precision."""
    lc = prec_chol.to(dtype)
    la = lc.abs()
    out = torch.empty((x.shape[0],), dtype=dtype, device=x.device)
    for r in range(0, x.shape[0], ROWS):
        xb = x[r:r + ROWS].to(dtype)
        out[r:r + ROWS] = ((xb @ lc).abs() * (xb.abs() @ la)).sum(dim=-1)
    return out


def draws(gen, n, inv_chol_t):
    """n exact float32 draws of the target: z @ L⁻¹ for standard normal z,
    since (z L⁻¹) L = z. ``inv_chol_t`` is L⁻¹ as a float32 tensor on the
    generator's device."""
    z = torch.randn((n, inv_chol_t.shape[0]), generator=gen,
                    dtype=torch.float32, device=inv_chol_t.device)
    return z @ inv_chol_t
