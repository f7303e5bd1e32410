"""A precision matrix A drawn from a Wishart distribution with identity
scale and ``df`` degrees of freedom, A = G Gᵀ with G a (dim, df) matrix of
standard normals, drawn in float64 from the seed; L = chol(A)."""

import numpy as np

#: the seed's stream for G, apart from the sampler's and the start's
STREAM = 101


def prec_chol(spec, seed):
    dim, df = int(spec["dim"]), int(spec["df"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), STREAM]))
    g = rng.standard_normal((dim, df))
    return np.linalg.cholesky(g @ g.T)
