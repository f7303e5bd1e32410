"""Target distributions as batched ``nn.Module``s.

Every Gaussian target the JAX package benchmarks (``mcmcpp_tpu/models/
targets.py:29-64`` and the flagship of ``bench.py:63-73``) evaluates
logp(x) = −½‖x @ L‖² with L the lower-triangular Cholesky factor of the
precision matrix. :class:`GaussianTarget` is that form as a batched module;
it is also the one target the fused CUDA half-step evaluates in its own body
(``ops/fused_stretch.py``).

The non-Gaussian targets of ``mcmcpp_tpu/models/targets.py:67-190`` are
:class:`Target` modules: each maps (n, P) -> (n,) and (P,) -> a scalar, and
carries the JAX ``Target``'s truth as numpy attributes (``mean``, ``cov``,
``extras``, ``name``, ``dim``). The regression targets make their data from
``seed`` with numpy exactly as the JAX package does, so both packages hold
the same data.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class GaussianTarget(nn.Module):
    """Zero-mean Gaussian, logp(x) = −½‖x @ L‖², for x of shape (n, P)
    (or (P,)); ``prec_chol`` is L, lower-triangular, (P, P)."""

    def __init__(self, prec_chol, device="cuda", dtype=torch.float32):
        super().__init__()
        prec_chol = torch.as_tensor(prec_chol, dtype=dtype, device=device)
        if prec_chol.ndim != 2 or prec_chol.shape[0] != prec_chol.shape[1]:
            raise ValueError(f"prec_chol must be (P, P), got {prec_chol.shape}")
        self.register_buffer("prec_chol", prec_chol.contiguous())

    @classmethod
    def from_numpy(cls, prec_chol, device="cuda"):
        """Build from the numpy L that the JAX package's target closes over."""
        return cls(np.asarray(prec_chol, np.float32), device=device)

    @classmethod
    def from_cov(cls, cov, device="cuda"):
        """L = cholesky(inv(cov)), computed in float64."""
        cov = np.asarray(cov, np.float64)
        return cls(np.linalg.cholesky(np.linalg.inv(cov)), device=device)

    @property
    def dim(self):
        return self.prec_chol.shape[0]

    def forward(self, x):
        y = x @ self.prec_chol
        return -0.5 * torch.sum(y * y, dim=-1)


def skewed_gaussian(eps=0.13, device="cuda"):
    """The reference's flagship test target
    (``test/sequential/SkewedGaussian/Common/SkewedGaussian.h:52-57``):
    logp = −½[(x/2 − y)²/eps + (x/2 + y)²], true covariance
    [[1+eps, (1−eps)/2], [(1−eps)/2, (1+eps)/4]]."""
    cov = np.array([[1 + eps, (1 - eps) / 2], [(1 - eps) / 2, (1 + eps) / 4]])
    return GaussianTarget.from_cov(cov, device=device)


def correlated_gaussian(dim=10, rho=0.5, device="cuda"):
    """AR(1)-correlated standardized Gaussian: Σ_ij = rho^|i−j|."""
    idx = np.arange(dim)
    return GaussianTarget.from_cov(
        rho ** np.abs(idx[:, None] - idx[None, :]), device=device
    )


def equicorrelated_gaussian(dim=10, rho=0.5, device="cuda"):
    """Σ = rho·11ᵀ + (1−rho)·I: the flagship benchmark target
    (``bench.py:63-73``, 10-D at rho = 0.5)."""
    return GaussianTarget.from_cov(
        rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim), device=device
    )


class Target(nn.Module):
    """A batched logp with the JAX ``Target``'s truth (any may be None)."""

    def __init__(self, name, dim, mean=None, cov=None, extras=None):
        super().__init__()
        self.name = name
        self.dim = int(dim)
        self.mean = None if mean is None else np.asarray(mean)
        self.cov = None if cov is None else np.asarray(cov)
        self.extras = dict(extras or {})


class Rosenbrock(Target):
    """2-D Rosenbrock "banana": logp = −[(a−x)² + b(y−x²)²]/scale
    (BASELINE.json config #3). The x-marginal is exactly N(a, scale/2)."""

    def __init__(self, a=1.0, b=100.0, scale=20.0):
        var_x = scale / 2.0
        super().__init__("rosenbrock", 2, np.array([a, a * a + var_x]), None,
                         {"a": a, "b": b, "scale": scale, "var_x": var_x})
        self.a, self.b, self.scale = float(a), float(b), float(scale)

    def forward(self, t):
        x, y = t[..., 0], t[..., 1]
        return -((self.a - x) ** 2 + self.b * (y - x * x) ** 2) / self.scale


class GaussianMixture(Target):
    """Isotropic Gaussian mixture (BASELINE.json config #4): ``means``
    (K, P), ``weights`` (K,) normalised here, ``scales`` (K,) std devs;
    logp = logsumexp_k(log w_k − ½‖(x − μ_k)/s_k‖² − P·log s_k)."""

    def __init__(self, means, weights=None, scales=None, device="cuda"):
        means = np.atleast_2d(np.asarray(means, np.float64))
        k, p = means.shape
        weights = (np.full(k, 1.0 / k) if weights is None
                   else np.asarray(weights, np.float64))
        weights = weights / weights.sum()
        scales = (np.ones(k) if scales is None
                  else np.asarray(scales, np.float64))
        mean = weights @ means
        cov = np.zeros((p, p))
        for j in range(k):
            dm = (means[j] - mean)[:, None]
            cov += weights[j] * (scales[j] ** 2 * np.eye(p) + dm @ dm.T)
        super().__init__("gaussian_mixture", p, mean, cov,
                         {"weights": weights, "scales": scales,
                          "means": means})

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        self.register_buffer("means_t", f32(means))
        self.register_buffer("log_weights", f32(np.log(weights)))
        self.register_buffer("scales_t", f32(scales))

    def forward(self, t):
        d = (t[..., None, :] - self.means_t) / self.scales_t[:, None]
        comp = (self.log_weights - 0.5 * torch.sum(d * d, dim=-1)
                - self.dim * torch.log(self.scales_t))
        return torch.logsumexp(comp, dim=-1)


class NealFunnel(Target):
    """Neal's funnel: v ~ N(0, σᵥ²), xᵢ | v ~ N(0, eᵛ); θ = (v, x₁..x_{P−1}).
    E[θ] = 0, Var[v] = σᵥ², Var[xᵢ] = exp(σᵥ²/2)."""

    def __init__(self, dim=10, sigma_v=3.0):
        var = np.full(dim, np.exp(sigma_v ** 2 / 2.0))
        var[0] = sigma_v ** 2
        super().__init__("neal_funnel", dim, np.zeros(dim), np.diag(var),
                         {"sigma_v": sigma_v})
        self.sigma_v = float(sigma_v)

    def forward(self, t):
        v, x = t[..., 0], t[..., 1:]
        lp_v = -0.5 * (v / self.sigma_v) ** 2
        lp_x = (-0.5 * torch.sum(x * x, dim=-1) * torch.exp(-v)
                - 0.5 * (self.dim - 1) * v)
        return lp_v + lp_x


class BayesianLinearRegression(Target):
    """y = X w + ε, ε ~ N(0, noise²), prior w ~ N(0, prior_scale² I); the
    posterior is exactly N(mean, cov) (computed here in float64)."""

    def __init__(self, x, y, noise=0.5, prior_scale=10.0, w_true=None,
                 device="cuda"):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        prec_n = x.T @ x / noise ** 2 + np.eye(x.shape[1]) / prior_scale ** 2
        cov_n = np.linalg.inv(prec_n)
        mu_n = cov_n @ (x.T @ y) / noise ** 2
        super().__init__("bayesian_linear_regression", x.shape[1], mu_n,
                         cov_n, {"w_true": w_true, "X": x, "y": y,
                                 "noise": noise})
        self.noise, self.prior_scale = float(noise), float(prior_scale)
        self.register_buffer(
            "x_t", torch.as_tensor(x.astype(np.float32), device=device))
        self.register_buffer(
            "y_t", torch.as_tensor(y.astype(np.float32), device=device))

    def forward(self, t):
        r = self.y_t - t @ self.x_t.T
        return (-0.5 * torch.sum(r * r, dim=-1) / self.noise ** 2
                - 0.5 * torch.sum(t * t, dim=-1) / self.prior_scale ** 2)


class LogisticRegression(Target):
    """Bayesian logistic regression, prior w ~ N(0, prior_scale² I); labels
    y in {0, 1}. No closed-form posterior (``mean``/``cov`` are None)."""

    def __init__(self, x, y, prior_scale=2.5, w_true=None, device="cuda"):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        super().__init__("logistic_regression", x.shape[1], None, None,
                         {"w_true": w_true, "X": x, "y": y,
                          "prior_scale": prior_scale})
        self.prior_scale = float(prior_scale)
        self.register_buffer(
            "x_t", torch.as_tensor(x.astype(np.float32), device=device))
        # labels in {-1, +1}
        self.register_buffer("sign_t", torch.as_tensor(
            (2.0 * y - 1.0).astype(np.float32), device=device))

    def forward(self, t):
        logits = self.sign_t * (t @ self.x_t.T)
        return (torch.sum(F.logsigmoid(logits), dim=-1)
                - 0.5 * torch.sum(t * t, dim=-1) / self.prior_scale ** 2)


def rosenbrock(a=1.0, b=100.0, scale=20.0):
    """The Rosenbrock banana of ``mcmcpp_tpu.models.rosenbrock``."""
    return Rosenbrock(a, b, scale)


def gaussian_mixture(means, weights=None, scales=None, device="cuda"):
    """The mixture of ``mcmcpp_tpu.models.gaussian_mixture``."""
    return GaussianMixture(means, weights, scales, device=device)


def neal_funnel(dim=10, sigma_v=3.0):
    """Neal's funnel of ``mcmcpp_tpu.models.neal_funnel``."""
    return NealFunnel(dim, sigma_v)


def bayesian_linear_regression(n_data=200, dim=5, noise=0.5,
                               prior_scale=10.0, seed=0, device="cuda"):
    """The data of ``mcmcpp_tpu.models.bayesian_linear_regression``, made
    from ``seed`` with numpy in the same order."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_data, dim))
    w_true = rng.normal(size=dim)
    y = x @ w_true + noise * rng.normal(size=n_data)
    return BayesianLinearRegression(x, y, noise, prior_scale, w_true,
                                    device=device)


def logistic_regression(n_data=300, dim=4, prior_scale=2.5, seed=0,
                        device="cuda"):
    """The data of ``mcmcpp_tpu.models.logistic_regression``, made from
    ``seed`` with numpy in the same order."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_data, dim))
    w_true = rng.normal(size=dim)
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n_data) < p).astype(np.float64)
    return LogisticRegression(x, y, prior_scale, w_true, device=device)
