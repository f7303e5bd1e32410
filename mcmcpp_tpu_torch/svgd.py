"""Stein variational gradient descent (SVGD).

PyTorch counterpart of ``mcmcpp_tpu/svgd.py`` (Liu & Wang 2016). N particles
move along the Stein variational direction

    φ(x_i) = (1/N) Σ_j [ k(x_j, x_i) ∇log p(x_j) + ∇_{x_j} k(x_j, x_i) ]

with the RBF kernel exp(−‖x − y‖²/h) and AdaGrad steps. An update is a few
(N, N)/(N, P) products: the squared distances from one Gram product, the
score consensus K @ scores and the closed-form repulsion
(2/h)((Σ_j K_ij) x_i − K @ x).

The median heuristic h = med²/log N takes the median as ``jnp.median`` does,
the mean of the two middle order statistics when N² is even (``torch.median``
returns the lower one, and ``torch.quantile`` refuses inputs past 2^24
elements), read from one sort of the (N²,) distances.
``mesh=`` is not ported.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
from mcmcpp_tpu_torch.ops.random import AUX_STREAM, make_generator
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["SVGD", "SVGDResult"]


class SVGDResult(NamedTuple):
    particles: torch.Tensor  # (N, P) final particle cloud
    grad_norm_history: torch.Tensor  # (steps,) mean |phi| per step


def median(x):
    """The median of all of ``x`` as ``jnp.median`` takes it: the middle
    order statistic, or the mean of the two middle ones for an even count.
    One sort (CUDA's ``kthvalue`` selects within one thread block, slow on
    the 2^26 distances of 8192 particles)."""
    flat = torch.sort(x.reshape(-1)).values
    s = flat.shape[0]
    if s % 2:
        return flat[s // 2]
    return (flat[s // 2 - 1] + flat[s // 2]) * 0.5


class SVGD:
    """Stein variational gradient descent over a torch log density (≙
    ``mcmcpp_tpu/svgd.py::SVGD``).

    logp_fn : (P,) -> scalar, or with ``batched=True`` (N, P) -> (N,).
    bandwidth : the RBF lengthscale ℓ (kernel exp(−‖x−y‖²/ℓ²)) or
        ``"median"`` (default): h = med²/log N recomputed every step.
    step_size : AdaGrad step size.
    device : default "cuda" (CUDA without a GPU raises).
    """

    def __init__(self, logp_fn, n_particles, n_params, step_size=0.1,
                 bandwidth="median", seed=0, dtype=torch.float32,
                 batched=False, device="cuda"):
        self.device = resolve_device(device)
        self.logp_fn = logp_fn
        self._logp = logp_fn if batched else torch.func.vmap(logp_fn)
        self.n = int(n_particles)
        self.n_params = int(n_params)
        self.step_size = float(step_size)
        if bandwidth != "median":
            bandwidth = float(bandwidth)
            if bandwidth <= 0:
                raise ValueError("bandwidth must be positive or 'median'")
        self.bandwidth = bandwidth
        self.dtype = dtype
        self._aux_gen = make_generator(seed, AUX_STREAM, self.device)
        self.particles = None

    def init(self, positions=None, scale=1.0, seed=None):
        """Start from ``positions`` (N, P) or a N(0, scale²) ball."""
        if positions is None:
            gen = (self._aux_gen if seed is None
                   else make_generator(seed, AUX_STREAM, self.device))
            positions = scale * torch.randn((self.n, self.n_params),
                                            generator=gen, dtype=self.dtype,
                                            device=self.device)
        positions = torch.as_tensor(
            np.asarray(positions) if not isinstance(positions, torch.Tensor)
            else positions).to(self.device, self.dtype)
        if tuple(positions.shape) != (self.n, self.n_params):
            raise ValueError(f"positions must be ({self.n}, {self.n_params})")
        self.particles = positions
        return self

    def _phi(self, x):
        """The Stein variational direction of the whole (N, P) cloud."""
        n = self.n
        scores = logp_and_grad(self._logp, x)[1]
        sq = torch.sum(x * x, 1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T),
                         min=0.0)
        if self.bandwidth == "median":
            h = torch.clamp(median(d2), min=1e-12) / np.log(max(n, 2))
        else:
            h = self.bandwidth ** 2
        k_mat = torch.exp(-d2 / h)
        drift = k_mat.T @ scores
        repulse = (2.0 / h) * (torch.sum(k_mat, 0)[:, None] * x
                               - k_mat.T @ x)
        return (drift + repulse) / n

    @torch.no_grad()
    def fit(self, n_steps=500, adagrad_eps=1e-6):
        """``n_steps`` SVGD updates (no host read); returns
        :class:`SVGDResult`, and the cloud stays on ``particles`` so ``fit``
        continues where it stopped."""
        if self.particles is None:
            self.init()
        x = self.particles
        acc = torch.zeros_like(x)
        hist = torch.empty(int(n_steps), dtype=x.dtype, device=x.device)
        for i in range(int(n_steps)):
            phi = self._phi(x)
            acc = acc + phi * phi
            x = x + self.step_size * phi / torch.sqrt(acc + adagrad_eps)
            hist[i] = torch.mean(torch.linalg.vector_norm(phi, dim=-1))
        self.particles = x
        return SVGDResult(x, hist)

    def get_samples(self):
        """(N, P) current particle cloud (numpy)."""
        if self.particles is None:
            raise RuntimeError("call init()/fit() first")
        return self.particles.cpu().numpy()
