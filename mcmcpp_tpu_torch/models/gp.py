"""Gaussian-process kernel library: composable covariance functions.

PyTorch counterpart of ``mcmcpp_tpu/models/gp.py``. Kernels are callables
``k(x1, x2) -> (N1, N2)`` over coordinates of shape ``(N,)`` or ``(N, D)``
(numpy or tensors); they compose with ``+`` and ``*`` and are torch ops end
to end, so hyperparameters can be live tensors whose gradients flow through
:func:`gram_cholesky` and :func:`gp_log_marginal`::

    k = RBF(lengthscale=l, variance=a) + WhiteNoise(1e-4)
    L = gram_cholesky(k, xs)            # chol(K + jitter I)
    logml = gp_log_marginal(k, xs, y, noise=0.1)

Products run in the inputs' precision: float32 stays float32 (never TF32,
whose 10-bit mantissa the Cholesky of a near-singular Gram cannot take),
float64 stays float64. Coordinates given as numpy become tensors of the
hyperparameters' dtype (float32 unless a hyperparameter is a float64 tensor)
on the device of the first tensor among the hyperparameters and the
coordinates; with no tensor there, on the kernel's ``device`` (default
"cuda", as the JAX package puts numpy on its accelerator; CUDA without a GPU
raises). A sum or product takes the first ``device`` its terms name.
"""

import math

import numpy as np
import torch


def matmul(a, b):
    """``a @ b`` that never runs in TF32: if a caller has switched
    ``torch.backends.cuda.matmul.allow_tf32`` on, the product is taken in
    float64 (as ``gradient/metric.py`` does); no global setting changes."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        return (a.double() @ b.double()).to(a.dtype)
    return a @ b


def _hyper_ref(*vals):
    """(dtype, device) from the tensors among ``vals``: float64 if any is,
    else float32; the first tensor's device, else None."""
    ts = [v for v in vals if isinstance(v, torch.Tensor)]
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in ts)
             else torch.float32)
    return dtype, (ts[0].device if ts else None)


def _coords(x, dtype=None, device=None):
    """(N,) or (N, D) coordinates -> (N, D) tensor (a tensor keeps its dtype
    and device unless they are given)."""
    if isinstance(x, torch.Tensor):
        t = x if dtype is None else x.to(dtype)
        t = t if device is None else t.to(device)
    else:
        t = torch.as_tensor(np.asarray(x, np.float64), device=device).to(
            dtype or torch.float32)
    return t[:, None] if t.ndim == 1 else t


class Kernel:
    """Base: ``__call__(x1, x2) -> (N1, N2)`` (CROSS covariance; white
    noise is zero there), ``gram(x)`` (the training Gram, where white noise
    lives on the diagonal) and ``diag(x)`` (prior variances without an (M,
    M) matrix). Composes with ``+`` and ``*``. ``device``: where numpy
    coordinates go when no tensor is among the inputs (None: "cuda")."""

    device = None

    def __call__(self, x1, x2):
        raise NotImplementedError

    def _hyper(self):
        return tuple(v for v in vars(self).values()
                     if isinstance(v, (torch.Tensor, float, int)))

    def _xs(self, *xs):
        ref = [x for x in xs if isinstance(x, torch.Tensor)]
        dtype, device = _hyper_ref(*self._hyper(), *ref)
        if device is None:
            from mcmcpp_tpu_torch.sampler import resolve_device

            device = resolve_device(
                "cuda" if self.device is None else self.device)
        return [_coords(x, dtype, device) for x in xs]

    def gram(self, x):
        return self(x, x)

    def diag(self, x):
        (x,) = self._xs(x)
        return torch.as_tensor(self.variance, dtype=x.dtype,
                               device=x.device).expand(x.shape[0])

    def __add__(self, other):
        return _Sum(self, other)

    def __mul__(self, other):
        return _Product(self, other)


def _sqdist(x1, x2):
    d = x1[:, None, :] - x2[None, :, :]
    return torch.sum(d * d, dim=-1)


class _Composite(Kernel):
    """Sum or product: the coordinates become tensors once, with the dtype
    and device of every hyperparameter of the tree."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    @property
    def device(self):
        return self.a.device if self.a.device is not None else self.b.device

    def _hyper(self):
        return self.a._hyper() + self.b._hyper()

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        return self._op(self.a(x1, x2), self.b(x1, x2))

    def gram(self, x):
        (x,) = self._xs(x)
        return self._op(self.a.gram(x), self.b.gram(x))

    def diag(self, x):
        (x,) = self._xs(x)
        return self._op(self.a.diag(x), self.b.diag(x))


class _Sum(_Composite):
    @staticmethod
    def _op(u, v):
        return u + v


class _Product(_Composite):
    @staticmethod
    def _op(u, v):
        return u * v


class RBF(Kernel):
    """Squared-exponential: variance · exp(−r²/(2ℓ²))."""

    def __init__(self, lengthscale=1.0, variance=1.0, device=None):
        self.lengthscale, self.variance = lengthscale, variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        r2 = _sqdist(x1, x2)
        return self.variance * torch.exp(-0.5 * r2 / self.lengthscale ** 2)


class Matern12(Kernel):
    """Exponential (Ornstein-Uhlenbeck): variance · exp(−r/ℓ)."""

    def __init__(self, lengthscale=1.0, variance=1.0, device=None):
        self.lengthscale, self.variance = lengthscale, variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        r = torch.sqrt(_sqdist(x1, x2) + 1e-36)
        return self.variance * torch.exp(-r / self.lengthscale)


class Matern32(Kernel):
    """Matérn ν=3/2 (once-differentiable sample paths)."""

    def __init__(self, lengthscale=1.0, variance=1.0, device=None):
        self.lengthscale, self.variance = lengthscale, variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        r = torch.sqrt(_sqdist(x1, x2) + 1e-36)
        z = math.sqrt(3.0) * r / self.lengthscale
        return self.variance * (1.0 + z) * torch.exp(-z)


class Matern52(Kernel):
    """Matérn ν=5/2 (twice-differentiable sample paths)."""

    def __init__(self, lengthscale=1.0, variance=1.0, device=None):
        self.lengthscale, self.variance = lengthscale, variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        r = torch.sqrt(_sqdist(x1, x2) + 1e-36)
        z = math.sqrt(5.0) * r / self.lengthscale
        return self.variance * (1.0 + z + z * z / 3.0) * torch.exp(-z)


class Periodic(Kernel):
    """Exp-sine-squared: variance · exp(−2 sin²(π r / period) / ℓ²)."""

    def __init__(self, period=1.0, lengthscale=1.0, variance=1.0,
                 device=None):
        self.period = period
        self.lengthscale, self.variance = lengthscale, variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        r = torch.sqrt(_sqdist(x1, x2) + 1e-36)
        s = torch.sin(math.pi * r / self.period)
        return self.variance * torch.exp(-2.0 * s * s / self.lengthscale ** 2)


class Linear(Kernel):
    """Dot-product kernel: variance · ⟨x1, x2⟩ (Bayesian linear maps)."""

    def __init__(self, variance=1.0, device=None):
        self.variance = variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        return self.variance * matmul(x1, x2.T)

    def diag(self, x):
        (x,) = self._xs(x)
        return self.variance * torch.sum(x * x, dim=-1)


class WhiteNoise(Kernel):
    """iid noise: variance · I on the GRAM diagonal (the same observation),
    ZERO cross-covariance, also between distinct observations that share a
    coordinate and between training and prediction points."""

    def __init__(self, variance=1e-6, device=None):
        self.variance = variance
        self.device = device

    def __call__(self, x1, x2):
        x1, x2 = self._xs(x1, x2)
        return torch.zeros((x1.shape[0], x2.shape[0]), dtype=x1.dtype,
                           device=x1.device)

    def gram(self, x):
        (x,) = self._xs(x)
        return self.variance * torch.eye(x.shape[0], dtype=x.dtype,
                                         device=x.device)


def jitter_level(k, jitter=1e-6, max_tries=5):
    """The number of ×10 escalations of ``jitter`` that the Cholesky of
    ``k + jitter·10^i·I`` needs (0 to ``max_tries``), as a 0-d int64 tensor
    on k's device: every level is factorized at once in one batched
    ``torch.linalg.cholesky_ex`` (no host sync), and the first whose factor
    succeeded and holds no NaN is picked (``max_tries`` when none does, as
    JAX's loop ends there)."""
    k = k.detach()
    n = k.shape[-1]
    levels = jitter * 10.0 ** torch.arange(max_tries + 1, dtype=k.dtype,
                                           device=k.device)
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    chol, info = torch.linalg.cholesky_ex(k + levels[:, None, None] * eye)
    ok = (info == 0) & ~torch.isnan(chol).flatten(1).any(dim=1)
    idx = torch.arange(max_tries + 1, device=k.device)
    return torch.min(torch.where(ok, idx, max_tries))


def gram_cholesky(kernel, xs, jitter=1e-6, max_tries=5):
    """Lower Cholesky of gram(xs) + jitter·I, escalated ×10 while the
    factorization fails, up to ``max_tries`` times (the GPML safeguard) —
    the ``prior_chol`` input of the elliptical-slice and interweave
    kernels.

    JAX's version escalates in a ``while_loop`` while the factor has NaNs;
    ``torch.linalg.cholesky`` raises instead, so the level is picked by
    :func:`jitter_level` (``cholesky_ex``'s ``info`` for all levels at once,
    on a detached copy), then ONE differentiable factorization runs at that
    level, as in JAX: the level is a locally constant choice, so gradients
    through the factor are exact almost everywhere.
    """
    k = kernel.gram(xs)
    n = k.shape[0]
    tries = jitter_level(k, jitter, max_tries)
    j = jitter * 10.0 ** tries.to(k.dtype)
    chol, _ = torch.linalg.cholesky_ex(
        k + j * torch.eye(n, dtype=k.dtype, device=k.device))
    return chol


def _noisy_gram(kernel, xs, noise, jitter):
    k = kernel.gram(xs)
    n = k.shape[0]
    return k + (noise ** 2 + jitter) * torch.eye(n, dtype=k.dtype,
                                                 device=k.device)


def _y(y, like):
    if isinstance(y, torch.Tensor):
        return y.to(like.dtype)
    return torch.as_tensor(np.asarray(y, np.float64), device=like.device).to(
        like.dtype)


def gp_log_marginal(kernel, xs, y, noise, jitter=1e-6):
    """Exact GP log marginal likelihood log N(y; 0, K + noise² I), the
    hyperparameter objective (Rasmussen & Williams 2006 eq 2.30)."""
    k = _noisy_gram(kernel, xs, noise, jitter)
    y = _y(y, k)
    n = y.shape[0]
    chol = torch.linalg.cholesky(k)
    w = torch.linalg.solve_triangular(chol, y[:, None], upper=False)[:, 0]
    return (-0.5 * torch.sum(w * w)
            - torch.sum(torch.log(torch.diagonal(chol)))
            - n / 2 * math.log(2.0 * math.pi))


def gp_predict(kernel, xs, y, x_new, noise, jitter=1e-6):
    """Exact GP posterior mean and variance at ``x_new`` given ``(xs, y)``
    with iid noise (R&W 2006 eqs 2.25-2.26): cross-covariances from the
    noise-free ``kernel(xs, x_new)``, prior variances from ``kernel.diag``
    (no (M, M) matrix)."""
    k = _noisy_gram(kernel, xs, noise, jitter)
    y = _y(y, k)
    chol = torch.linalg.cholesky(k)
    k_star = kernel(xs, x_new)  # (N, M)
    alpha = torch.cholesky_solve(y[:, None], chol, upper=False)[:, 0]
    mean = matmul(k_star.T, alpha[:, None])[:, 0]
    v = torch.linalg.solve_triangular(chol, k_star, upper=False)
    var = kernel.diag(x_new) - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=0.0)
