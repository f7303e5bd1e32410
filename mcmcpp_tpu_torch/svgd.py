"""Stein variational gradient descent (SVGD).

PyTorch counterpart of ``mcmcpp_tpu/svgd.py`` (Liu & Wang 2016). N particles
move along the Stein variational direction

    φ(x_i) = (1/N) Σ_j [ k(x_j, x_i) ∇log p(x_j) + ∇_{x_j} k(x_j, x_i) ]

with the RBF kernel exp(−‖x − y‖²/h) and AdaGrad steps. An update is a few
(N, N)/(N, P) products: the squared distances from one Gram product, then
one product Kᵀ [scores, x, 1] for the score consensus Kᵀ scores and the
closed-form repulsion (2/h)((Σ_j K_ji) x_i − Kᵀ x).

The median heuristic h = med²/log N takes the median as ``jnp.median`` does,
the mean of the two middle order statistics when N² is even (``torch.median``
returns the lower one, and ``torch.quantile`` refuses inputs past 2^24
elements), read from one sort of the (N²,) distances.

Sharded (``mesh=``, a ``WalkerLayout``), the particles split over the ranks:
each rank holds its rows of the cloud and of the AdaGrad accumulator and
scores its rows; one all-gather a step brings every rank the whole cloud
with its scores (and the previous step's |φ| rows, for the trace), the
distances and their median are taken on the whole as unsharded, and a rank
computes φ for its rows from its (N, n_local) block of kernel columns. The
initial cloud is drawn whole (every rank the same draws) and cut, so a
sharded run equals the unsharded one bit for bit on any number of ranks
where a matmul's rows do not depend on the block's height (the port's CPU
tests check this). ``fit`` returns, and ``get_samples`` reads, the rank's
rows; the |φ| trace is the whole cloud's. No hook draws noise here.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
from mcmcpp_tpu_torch.ops.random import AUX_STREAM, make_generator
from mcmcpp_tpu_torch.parallel.mesh import _engine_device, gathered, \
    own_rows

__all__ = ["SVGD", "SVGDResult"]


class SVGDResult(NamedTuple):
    particles: torch.Tensor  # (N, P) final particle cloud (the rank's rows)
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
    mesh : a ``WalkerLayout`` splitting the particles over the ranks of a
        process group, on the layout's device.
    """

    def __init__(self, logp_fn, n_particles, n_params, step_size=0.1,
                 bandwidth="median", seed=0, dtype=torch.float32,
                 batched=False, mesh=None, device=None):
        self.logp_fn = logp_fn
        self._logp = logp_fn if batched else torch.func.vmap(logp_fn)
        self.n = int(n_particles)
        self.mesh = mesh
        self._rows = own_rows(mesh, self.n, "n_particles")
        self.device = _engine_device(mesh, device)
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
        """Start from ``positions`` (N, P) or a N(0, scale²) ball (every
        particle's; a sharded SVGD keeps its rows)."""
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
        self.particles = positions[self._rows]
        return self

    def _phi(self, x, norm=None):
        """The Stein variational direction of the rank's rows ``x`` of the
        (N, P) cloud (the whole cloud unsharded), and the whole cloud's
        rows of ``norm`` (a previous step's |φ|, gathered with the cloud;
        None when not asked)."""
        n, rows = self.n, self._rows
        scores = logp_and_grad(self._logp, x)[1]
        x_rows = x
        if self.mesh is not None:
            parts = gathered(self.mesh, x, scores,
                             *(() if norm is None else (norm,)))
            x, scores = parts[:2]
            norm = parts[2] if norm is not None else None
        sq = torch.sum(x * x, 1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T),
                         min=0.0)
        if self.bandwidth == "median":
            h = torch.clamp(median(d2), min=1e-12) / np.log(max(n, 2))
        else:
            h = self.bandwidth ** 2
        # the kernel's columns of the rank's particles (all of it
        # unsharded), and in one product Kᵀ scores, Kᵀ x and the column sums
        # (a product's rows do not depend on the block's height, where the
        # CPU's column-sum reduction of a narrow block takes another order)
        k_mat = torch.exp(-d2[:, rows] / h)
        p = x.shape[1]
        prods = k_mat.T @ torch.cat(
            [scores, x, torch.ones_like(x[:, :1])], 1)
        drift, k_x, k_sum = prods[:, :p], prods[:, p:2 * p], prods[:, 2 * p:]
        repulse = (2.0 / h) * (k_sum * x_rows - k_x)
        return (drift + repulse) / n, norm

    @torch.no_grad()
    def fit(self, n_steps=500, adagrad_eps=1e-6):
        """``n_steps`` SVGD updates (no host read); returns
        :class:`SVGDResult`, and the cloud stays on ``particles`` so ``fit``
        continues where it stopped. Sharded, a step's |φ| rows travel with
        the next step's gather (the last step's alone, after the loop)."""
        if self.particles is None:
            self.init()
        x = self.particles
        acc = torch.zeros_like(x)
        hist = torch.empty(int(n_steps), dtype=x.dtype, device=x.device)
        norm = None
        for i in range(int(n_steps)):
            phi, prev = self._phi(x, norm)
            if prev is not None:
                hist[i - 1] = torch.mean(prev)
            acc = acc + phi * phi
            x = x + self.step_size * phi / torch.sqrt(acc + adagrad_eps)
            norm = torch.linalg.vector_norm(phi, dim=-1)
            if self.mesh is None:
                hist[i] = torch.mean(norm)
        if self.mesh is not None and int(n_steps):
            hist[-1] = torch.mean(self.mesh.gather(norm))
        self.particles = x
        return SVGDResult(x, hist)

    def get_samples(self):
        """(N, P) current particle cloud (numpy; the rank's rows when
        sharded)."""
        if self.particles is None:
            raise RuntimeError("call init()/fit() first")
        return self.particles.cpu().numpy()
