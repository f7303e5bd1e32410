"""Σ = ρ·11ᵀ + (1 − ρ)·I in ``dim`` dimensions, L = chol(Σ⁻¹) in float64
(the same for every seed)."""

import numpy as np


def prec_chol(spec, seed):
    del seed
    dim, rho = int(spec["dim"]), float(spec["rho"])
    cov = rho * np.ones((dim, dim)) + (1.0 - rho) * np.eye(dim)
    return np.linalg.cholesky(np.linalg.inv(cov))
