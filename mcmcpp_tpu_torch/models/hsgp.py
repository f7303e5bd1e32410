"""Hilbert-space (reduced-rank) Gaussian processes: GP priors as matmuls.

PyTorch counterpart of ``mcmcpp_tpu/models/hsgp.py`` (Solin & Särkkä 2020,
with the recipe of Riutort-Mayol et al. 2023). On a box ``[-L, L]^D`` the
stationary covariance is approximated by the Dirichlet-Laplacian
eigenbasis, ``k(x, x') ≈ Σ_j S(√λ_j) φ_j(x) φ_j(x')``, so a GP function value
is a linear map of ``m`` iid-normal weights, ``f = Φ (√S(θ) ⊙ β)``. The basis
``Φ`` depends on the data alone and is built once; each log-density or
gradient is one (N, m) product plus the spectral weights, with
hyperparameter gradients flowing through ``S(θ)``.

DSL usage (the prior is m iid normals + one deterministic)::

    basis = HSGP(x, m=64, c=1.5, kernel="matern52", device="cuda")
    model.param("ell",   LogNormal(0.0, 0.5))
    model.param("sigma", HalfNormal(1.0))
    model.param("beta",  Normal(0, 1), shape=(basis.num_basis,))
    model.deterministic(
        "f", lambda p: basis(p["ell"], p["sigma"], p["beta"]))
    model.observe("y", lambda p: Normal(p["f"], noise), y)

Kernels: "rbf", "matern12", "matern32", "matern52"; inputs ``(N,)`` or ARD
``(N, D)`` (tensor-product eigenbasis, per-dim ``m``/``L``). The basis is
float32 on ``device`` by default, as the JAX package keeps it; ``dtype=``
takes float64. Products never run in TF32.
"""

import math

import numpy as np
import torch

from mcmcpp_tpu_torch.models.gp import matmul

__all__ = [
    "HSGP",
    "hsgp_log_marginal",
    "hsgp_predict",
    "spectral_density",
]

_MATERN_NU = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


def spectral_density(kernel, omega, lengthscale, variance=1.0):
    """Power spectral density S(ω) of a stationary kernel at frequency
    vectors ``omega`` (..., D) (non-unitary convention: ``k(r) = (2π)^{-D} ∫
    S(ω) e^{iω·r} dω``). ``lengthscale`` is scalar or per-dimension (D,)
    (ARD): R&W 2006 eq. 4.15 (Matérn) and the Gaussian Fourier pair (RBF),
    with ``∏ℓ_d`` pulled out and ``ω_d → ℓ_d ω_d``."""
    omega = (omega if isinstance(omega, torch.Tensor)
             else torch.as_tensor(np.asarray(omega, np.float64)))
    d = omega.shape[-1]
    ell = (lengthscale.to(omega.dtype) if isinstance(lengthscale, torch.Tensor)
           else torch.as_tensor(np.asarray(lengthscale, np.float64),
                                device=omega.device).to(omega.dtype))
    ell = ell.expand(d)
    prod_ell = torch.prod(ell)
    s2 = torch.sum((ell * omega) ** 2, dim=-1)  # Σ ℓ_d² ω_d²
    if kernel == "rbf":
        return (variance * (2.0 * math.pi) ** (d / 2.0) * prod_ell
                * torch.exp(-0.5 * s2))
    try:
        nu = _MATERN_NU[kernel]
    except KeyError:
        raise ValueError(
            f"unknown kernel {kernel!r}; expected rbf/matern12/"
            f"matern32/matern52"
        ) from None
    coef = (variance * prod_ell
            * 2.0 ** d * math.pi ** (d / 2.0)
            * math.gamma(nu + d / 2.0) * (2.0 * nu) ** nu
            / math.gamma(nu))
    return coef * (2.0 * nu + s2) ** (-(nu + d / 2.0))


def _as_2d(x):
    x = (x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x, np.float64))
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"inputs must be (N,) or (N, D); got {x.shape}")
    return x


class HSGP:
    """Reduced-rank GP basis over fixed inputs.

    x : (N,) or (N, D) training inputs (the basis is built once from them).
    m : eigenfunctions per input dimension (int or per-dim tuple); the basis
        size is ``prod(m)``.
    c : box-expansion factor, ``L_d = c · max|x_d − center_d|``.
    kernel : "rbf" | "matern12" | "matern32" | "matern52".
    L : explicit half-widths (overrides ``c``), scalar or per-dim.
    dtype, device : of ``phi`` (N, M) and ``sqrt_lam`` (M, D); the device
        defaults to "cuda" (CUDA without a GPU raises).

    Everything that depends on the hyperparameters happens in
    :meth:`spectral` / :meth:`__call__`, in torch ops.
    """

    def __init__(self, x, m=32, c=1.5, kernel="rbf", L=None,
                 dtype=torch.float32, device="cuda"):
        # (imported here: the sampler imports the models package)
        from mcmcpp_tpu_torch.sampler import resolve_device

        x2 = _as_2d(x)
        n, d = x2.shape
        if kernel not in ("rbf",) + tuple(_MATERN_NU):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel
        self.ndim = d
        self.dtype = dtype
        self.device = resolve_device(device)
        ms = (m,) * d if np.isscalar(m) else tuple(int(v) for v in m)
        if len(ms) != d:
            raise ValueError(f"m has {len(ms)} entries for D={d} inputs")
        self._m_per_dim = ms
        self.center = 0.5 * (x2.max(axis=0) + x2.min(axis=0))
        if L is None:
            half = np.abs(x2 - self.center).max(axis=0)
            half = np.where(half > 0, half, 1.0)
            self.L = float(c) * half
        else:
            self.L = np.broadcast_to(np.asarray(L, np.float64), (d,)).copy()
            if np.any(self.L <= np.abs(x2 - self.center).max(axis=0)):
                raise ValueError(
                    "L must strictly contain the (centered) inputs"
                )
        # multi-index grid over per-dim eigenfunction counts
        grids = np.meshgrid(*[np.arange(1, mi + 1) for mi in ms],
                            indexing="ij")
        idx = np.stack([g.reshape(-1) for g in grids], axis=-1)  # (M, D)
        # √λ per dim: j π / (2 L_d) (Dirichlet Laplacian on [-L, L])
        self.sqrt_lam = self._tensor(idx * np.pi / (2.0 * self.L))  # (M, D)
        self.num_basis = idx.shape[0]
        self.phi = self.basis_at(x2)  # (N, M)

    def _tensor(self, a):
        """float64 numpy -> a tensor of the basis's dtype (cast after the
        float64 arithmetic, as JAX casts its float64 numpy to float32)."""
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.device).to(self.dtype)

    def basis_at(self, x):
        """Eigenfunction matrix Φ at arbitrary inputs: (N2, M).
        φ_j(x) = ∏_d L_d^{-1/2} sin(√λ_{j,d} (x_d + L_d)), exactly zero
        outside the box; keep prediction points inside ``[center − L,
        center + L]``."""
        x2 = self._tensor(_as_2d(x))
        xc = x2 - self._tensor(self.center)
        ld = self._tensor(self.L)
        args = self.sqrt_lam[None, :, :] * (xc[:, None, :] + ld)
        vals = torch.sin(args) / torch.sqrt(ld)
        return torch.prod(vals, dim=-1)

    def spectral(self, lengthscale, variance=1.0):
        """(M,) spectral weights S(√λ_j) for live hyperparameters."""
        return spectral_density(self.kernel, self.sqrt_lam, lengthscale,
                                variance)

    def __call__(self, lengthscale, variance, beta, x=None):
        """Function values ``f = Φ (√S ⊙ β)`` with ``β ~ N(0, I_m)``, so
        ``f ~ N(0, Φ S Φᵀ) ≈ GP(0, k)``. ``beta`` may carry leading batch
        axes (..., M); ``x=None`` uses the training basis (one (N, M)
        product: the sampler's hot path)."""
        phi = self.phi if x is None else self.basis_at(x)
        w = torch.sqrt(self.spectral(lengthscale, variance)) * beta
        dtype = torch.promote_types(w.dtype, phi.dtype)  # JAX's promotion
        return matmul(w.to(dtype), phi.T.to(dtype))

    def gram(self, lengthscale, variance=1.0, x=None):
        """Approximate Gram Φ diag(S) Φᵀ (testing / direct use)."""
        phi = self.phi if x is None else self.basis_at(x)
        return matmul(phi * self.spectral(lengthscale, variance), phi.T)


def _weight_space(basis, lengthscale, variance, y, noise, jitter):
    """The shared weight-space algebra: the Cholesky of A = σ_n² S⁻¹ + ΦᵀΦ
    (M × M), the one decomposition either the marginal likelihood or the
    predictive needs. O(N M² + M³)."""
    y = (y if isinstance(y, torch.Tensor)
         else torch.as_tensor(np.asarray(y), device=basis.phi.device))
    # the products in the promoted dtype of the basis and the data, as JAX
    # promotes (a float32 basis with float64 data works in float64)
    dtype = torch.promote_types(basis.phi.dtype, y.dtype)
    phi, y = basis.phi.to(dtype), y.to(dtype)
    s = (basis.spectral(lengthscale, variance) + jitter).to(dtype)
    sn2 = noise ** 2 + jitter
    a = sn2 * torch.diag(1.0 / s) + matmul(phi.T, phi)
    chol = torch.linalg.cholesky(a)
    phi_y = matmul(phi.T, y[:, None])[:, 0]
    w = torch.cholesky_solve(phi_y[:, None], chol, upper=False)[:, 0]
    return phi, s, sn2, chol, y, phi_y, w


def hsgp_log_marginal(basis, lengthscale, variance, y, noise, jitter=1e-6):
    """Reduced-rank GP log marginal likelihood ``log N(y; 0, Φ S Φᵀ + σ_n²
    I)`` by the matrix-determinant and Woodbury identities in weight space:
    O(N m² + m³) instead of the exact path's O(N³)
    (:func:`mcmcpp_tpu_torch.models.gp.gp_log_marginal`)."""
    phi, s, sn2, chol, y, phi_y, w = _weight_space(
        basis, lengthscale, variance, y, noise, jitter
    )
    n = y.shape[0]
    m = basis.num_basis
    quad = (torch.sum(y * y) - torch.sum(phi_y * w)) / sn2
    logdet = (2.0 * torch.sum(torch.log(torch.diagonal(chol)))
              + torch.sum(torch.log(s))
              + (n - m) * (torch.log(sn2) if isinstance(sn2, torch.Tensor)
                           else math.log(sn2)))
    return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def hsgp_predict(basis, lengthscale, variance, y, noise, x_new,
                 jitter=1e-6):
    """Posterior mean and variance of the latent f at ``x_new`` under the
    reduced-rank prior: the weight posterior N(A⁻¹Φᵀy, σ_n² A⁻¹) pushed
    through φ(x*). Matches ``gp_predict`` as m → ∞ inside the box."""
    _, s, sn2, chol, _, _, w = _weight_space(
        basis, lengthscale, variance, y, noise, jitter
    )
    phi_new = basis.basis_at(x_new).to(w.dtype)  # (N2, M)
    mean = matmul(phi_new, w[:, None])[:, 0]
    half = torch.linalg.solve_triangular(chol, phi_new.T, upper=False)
    var = sn2 * torch.sum(half * half, dim=0)
    return mean, torch.clamp(var, min=0.0)
