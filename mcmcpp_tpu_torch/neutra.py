"""NeuTra: normalizing-flow-preconditioned gradient sampling.

PyTorch counterpart of ``mcmcpp_tpu/neutra.py`` (Hoffman et al. 2019,
"NeuTra-lizing Bad Geometry in HMC Using Neural Transport"): fit a flow f to
the target by reverse KL (ELBO ascent), then sample the pulled-back target

    logp_z(z) = logp(f(z)) + log|det df/dz|

with any gradient sampler of the port; pushing the draws through f returns
posterior draws (the flow only preconditions).

The flows are ``nn.Module``s written for a (B, P) batch: ``forward(z) ->
(x, logdet (B,))`` and ``inverse(x) -> (z, logdet of dz/dx)``. Their
parameters keep the JAX package's layout, an MLP layer's weight as ``(in,
out)`` with ``x @ w + b``, as plain ``nn.Parameter``s in one
``nn.ParameterList`` in the order of ``jax.tree_util.tree_leaves`` of the
JAX flow's params, so ``convert.flow_params_from_numpy`` copies them over
one for one with no transpose. ``init(gen)`` draws them as ``_mlp_init``
does (He-scaled normals, the last layer zero: every flow starts as the
identity). IAF's sequential direction (its ``inverse``) is a Python loop over
the P coordinates.

Training is the functional Adam of :mod:`mcmcpp_tpu_torch.optim` (optax's
numbers and state). Each step's base draws come from the NeuTra's generator,
or from ``noise=`` (a (n_steps, batch, P) tensor), which is how a test hands
the port the JAX package's draws.

Sharded (``mesh=``, a ``WalkerLayout``), the training batch splits over the
ranks and the flow's parameters and Adam state stay replicated: every rank
draws the whole batch's base draws (or ``refit_forward_kl``'s row indices)
and keeps its rows, takes the gradient of its rows' share of the mean, and
one all-reduce a step (:meth:`~mcmcpp_tpu_torch.parallel.mesh.WalkerLayout.
sum`) sums the flat gradient with the objective's value beside it, so every
rank takes the same Adam step. In a group of one the sum does no arithmetic
and the fit equals the unsharded one bit for bit; over more ranks the
partial sums round otherwise (within the JAX package's 2e-3,
``tests/test_neutra.py:363``). :meth:`NeuTra.make_sampler` passes the layout
on to the gradient sampler (unless ``mesh=`` is given) and draws every
chain's start, of which each rank keeps its rows. No hook draws noise here.
"""

import copy
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from mcmcpp_tpu_torch.optim import adam_init, adam_step
from mcmcpp_tpu_torch.ops.random import STEP_STREAM, make_generator
from mcmcpp_tpu_torch.parallel.mesh import (
    _engine_device,
    own_rows,
    summed_grad,
)

__all__ = ["FitResult", "IAF", "NeuTra", "RealNVP", "SplineCoupling"]


# -- tiny MLP ----------------------------------------------------------------


def _mlp_sizes(sizes):
    """Parameter shapes of an MLP: (w (a, b), b (b,)) per layer."""
    shapes = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        shapes += [(a, b), (b,)]
    return shapes


def _mlp_init(gen, params, dtype):
    """He-scaled normal weights, zero biases, a zero last layer (the flow
    starts as the identity), written into ``params`` [w, b, w, b, ...]."""
    n_layers = len(params) // 2
    for i in range(n_layers):
        w, b = params[2 * i], params[2 * i + 1]
        if i == n_layers - 1:
            w.zero_()
        else:
            z = torch.randn(w.shape, generator=gen, dtype=dtype,
                            device=gen.device)
            w.copy_(z * math.sqrt(2.0 / w.shape[0]))
        b.zero_()


def _mlp_apply(params, x):
    """``params`` [w, b, ...]: tanh hidden layers, a linear last layer."""
    n_layers = len(params) // 2
    for i in range(n_layers - 1):
        x = torch.tanh(x @ params[2 * i] + params[2 * i + 1])
    return x @ params[-2] + params[-1]


class _Flow(nn.Module):
    """Shared plumbing: the parameters as one ParameterList in the JAX leaf
    order, allocated zero at ``dtype`` on the CPU (``.to(device)`` moves
    them)."""

    def _make_params(self, shapes, dtype):
        self.leaves = nn.ParameterList(
            [nn.Parameter(torch.zeros(s, dtype=dtype)) for s in shapes])

    def param_list(self):
        """The parameters in ``jax.tree_util.tree_leaves`` order of the JAX
        flow's params."""
        return list(self.leaves)

    def forward(self, z):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def _make_masks(self):
        """Coupling masks (layer l keeps ``idx % 2 == l % 2``): per layer
        the kept indices, the transformed ones and the permutation that
        puts [a, b] back, as buffers (``.to(device)`` moves them)."""
        idx = np.arange(self.dim)
        self._masks = []
        for layer in range(self.n_layers):
            mask = (idx % 2) == (layer % 2)
            ia, ib = np.nonzero(mask)[0], np.nonzero(~mask)[0]
            inv = np.argsort(np.concatenate([ia, ib]))
            for name, v in (("ia", ia), ("ib", ib), ("inv", inv)):
                self.register_buffer(f"_{name}{layer}", torch.as_tensor(v))
            self._masks.append(mask)

    def _split(self, x, layer):
        return (x[:, getattr(self, f"_ia{layer}")],
                x[:, getattr(self, f"_ib{layer}")])

    def _join(self, a, b, layer):
        return torch.cat([a, b], -1)[:, getattr(self, f"_inv{layer}")]


# -- RealNVP -----------------------------------------------------------------


class RealNVP(_Flow):
    """Stack of affine coupling layers with alternating even/odd masks
    (≙ ``mcmcpp_tpu/neutra.py::RealNVP``): one hidden-layer MLP per coupling
    gives (shift, log_scale), log_scale tanh-bounded to ±``scale_cap``."""

    def __init__(self, dim, n_layers=6, hidden=64, scale_cap=4.0,
                 dtype=torch.float32):
        super().__init__()
        if dim < 2:
            raise ValueError("RealNVP needs dim >= 2 (use ADVI for 1-D)")
        self.dim = int(dim)
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.scale_cap = float(scale_cap)
        self.dtype = dtype
        self._make_masks()
        shapes = []
        for mask in self._masks:
            n_in, n_out = int(mask.sum()), int((~mask).sum())
            shapes += _mlp_sizes((n_in, self.hidden, 2 * n_out))
        self._make_params(shapes, dtype)

    @torch.no_grad()
    def init(self, gen):
        """Draw the parameters from ``gen``; returns :meth:`param_list`."""
        for layer in range(self.n_layers):
            _mlp_init(gen, self.param_list()[4 * layer:4 * layer + 4],
                      self.dtype)
        return self.param_list()

    def _shift_scale(self, layer, a, n_out):
        out = _mlp_apply(self.param_list()[4 * layer:4 * layer + 4], a)
        shift, raw = out[..., :n_out], out[..., n_out:]
        return shift, self.scale_cap * torch.tanh(raw / self.scale_cap)

    def _couple(self, x, inverse):
        logdet = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
        layers = range(self.n_layers)
        for layer in (reversed(layers) if inverse else layers):
            a, b = self._split(x, layer)
            shift, ls = self._shift_scale(layer, a, b.shape[-1])
            if inverse:
                b = (b - shift) * torch.exp(-ls)
                logdet = logdet - torch.sum(ls, -1)
            else:
                b = b * torch.exp(ls) + shift
                logdet = logdet + torch.sum(ls, -1)
            x = self._join(a, b, layer)
        return x, logdet

    def forward(self, z):
        """(B, P) base draws -> (x, logdet (B,))."""
        return self._couple(z, inverse=False)

    def inverse(self, x):
        """(B, P) target points -> (z, logdet of dz/dx)."""
        return self._couple(x, inverse=True)


# -- IAF ---------------------------------------------------------------------


class IAF(_Flow):
    """Inverse autoregressive flow with MADE masking (≙
    ``mcmcpp_tpu/neutra.py::IAF``): the sampling direction is one masked
    matmul pass per layer; ``inverse`` is sequential in the dimension (a
    Python loop over the P coordinates per layer). Layers are separated by
    a reversal of the coordinates."""

    def __init__(self, dim, n_layers=4, hidden=64, scale_cap=4.0,
                 dtype=torch.float32):
        super().__init__()
        if dim < 2:
            raise ValueError("IAF needs dim >= 2 (use ADVI for 1-D)")
        self.dim = int(dim)
        self.n_layers = int(n_layers)
        self.hidden = max(int(hidden), self.dim)
        self.scale_cap = float(scale_cap)
        self.dtype = dtype
        d_in = np.arange(1, self.dim + 1)
        d_hid = (np.arange(self.hidden) % max(self.dim - 1, 1)) + 1
        out_deg = np.concatenate([d_in, d_in])
        # (D, H): hidden k sees input i iff m_k >= d_i; (H, 2D): output j
        # sees hidden k iff d_j > m_k
        self.register_buffer("_mask_in", torch.as_tensor(
            (d_hid[None, :] >= d_in[:, None]).astype(np.float32)).to(dtype))
        self.register_buffer("_mask_out", torch.as_tensor(
            (out_deg[None, :] > d_hid[:, None]).astype(np.float32)).to(dtype))
        shapes = []
        for _ in range(self.n_layers):
            shapes += [(self.dim, self.hidden), (self.hidden,),
                       (self.hidden, 2 * self.dim), (2 * self.dim,)]
        self._make_params(shapes, dtype)

    @torch.no_grad()
    def init(self, gen):
        """Draw the parameters from ``gen``; returns :meth:`param_list`."""
        params = self.param_list()
        for layer in range(self.n_layers):
            w1, b1, w2, b2 = params[4 * layer:4 * layer + 4]
            z = torch.randn(w1.shape, generator=gen, dtype=self.dtype,
                            device=gen.device)
            w1.copy_(z * math.sqrt(2.0 / self.dim))
            b1.zero_()
            w2.zero_()
            b2.zero_()
        return params

    def _shift_ls(self, layer, z):
        w1, b1, w2, b2 = self.param_list()[4 * layer:4 * layer + 4]
        h = torch.tanh(z @ (w1 * self._mask_in) + b1)
        out = h @ (w2 * self._mask_out) + b2
        shift, raw = out[..., :self.dim], out[..., self.dim:]
        return shift, self.scale_cap * torch.tanh(raw / self.scale_cap)

    def forward(self, z):
        """(B, P) base draws -> (x, logdet (B,)); one pass per layer."""
        x = z
        logdet = torch.zeros(z.shape[:1], dtype=z.dtype, device=z.device)
        for layer in range(self.n_layers):
            shift, ls = self._shift_ls(layer, x)
            x = x * torch.exp(ls) + shift
            logdet = logdet + torch.sum(ls, -1)
            x = torch.flip(x, (-1,))
        return x, logdet

    def inverse(self, x):
        """(B, P) target points -> (z, logdet of dz/dx); sequential in P."""
        z = x
        logdet = torch.zeros(x.shape[:1], dtype=x.dtype, device=x.device)
        for layer in reversed(range(self.n_layers)):
            z = torch.flip(z, (-1,))
            zi = torch.zeros_like(z)
            for i in range(self.dim):
                # z_i depends on z_{<i} only: ascending order solves the
                # layer in one sweep
                shift, ls = self._shift_ls(layer, zi)
                val = (z[:, i] - shift[:, i]) * torch.exp(-ls[:, i])
                zi = torch.cat([zi[:, :i], val[:, None], zi[:, i + 1:]], -1)
            _, ls = self._shift_ls(layer, zi)
            logdet = logdet - torch.sum(ls, -1)
            z = zi
        return z, logdet


# -- rational-quadratic spline coupling (neural spline flow) -----------------


def _rq_spline(x, widths, heights, derivs, inverse=False):
    """Monotone rational-quadratic spline (≙ ``mcmcpp_tpu/neutra.py::
    _rq_spline``), elementwise over (..., D) with (..., D, K) bins: the
    identity outside [-B, B]. A point on a knot belongs to the bin that
    starts there (``x >= knot``), as in the JAX package. Returns
    ``(y, log|dy/dx|)``."""
    xk = torch.cumsum(widths, -1)
    bound = xk[..., -1:] / 2.0
    xk = torch.cat([torch.zeros_like(xk[..., :1]), xk], -1) - bound
    yk = torch.cumsum(heights, -1)
    yk = torch.cat([torch.zeros_like(yk[..., :1]), yk], -1) - bound

    b = bound[..., 0]
    inside = (x > -b) & (x < b)
    lim = b * (1 - 1e-6)
    xs = torch.minimum(torch.maximum(x, -lim), lim)

    knots = yk if inverse else xk
    k = torch.sum(xs[..., None] >= knots[..., :-1], -1) - 1
    k = torch.clamp(k, 0, widths.shape[-1] - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, k)[..., 0]

    x0, w = take(xk), take(widths)
    y0, h = take(yk), take(heights)
    d0, d1 = take(derivs[..., :-1]), take(derivs[..., 1:])
    s = h / w

    if not inverse:
        xi = (xs - x0) / w
        omx = 1.0 - xi
        denom = s + (d1 + d0 - 2.0 * s) * xi * omx
        y = y0 + h * (s * xi * xi + d0 * xi * omx) / denom
        deriv = (s * s * (d1 * xi * xi + 2.0 * s * xi * omx
                          + d0 * omx * omx)) / (denom * denom)
        return (torch.where(inside, y, x),
                torch.where(inside, torch.log(deriv), 0.0))

    dy = xs - y0
    a_ = h * (s - d0) + dy * (d1 + d0 - 2.0 * s)
    b_ = h * d0 - dy * (d1 + d0 - 2.0 * s)
    c_ = -s * dy
    disc = torch.clamp(b_ * b_ - 4.0 * a_ * c_, min=0.0)
    xi = 2.0 * c_ / (-b_ - torch.sqrt(disc))
    xi = torch.clamp(xi, 0.0, 1.0)
    omx = 1.0 - xi
    denom = s + (d1 + d0 - 2.0 * s) * xi * omx
    deriv = (s * s * (d1 * xi * xi + 2.0 * s * xi * omx
                      + d0 * omx * omx)) / (denom * denom)
    return (torch.where(inside, x0 + xi * w, x),
            torch.where(inside, -torch.log(deriv), 0.0))


class SplineCoupling(_Flow):
    """Neural spline flow (≙ ``mcmcpp_tpu/neutra.py::SplineCoupling``):
    coupling layers whose transform is a K-bin rational-quadratic spline on
    [-B, B], then a learnable per-dimension affine head (shift, log_scale).
    Both directions are one parallel pass."""

    def __init__(self, dim, n_layers=4, hidden=64, n_bins=8, bound=5.0,
                 dtype=torch.float32):
        super().__init__()
        if dim < 2:
            raise ValueError("SplineCoupling needs dim >= 2 (use ADVI "
                             "for 1-D)")
        self.dim = int(dim)
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.n_bins = int(n_bins)
        self.bound = float(bound)
        self.dtype = dtype
        self._make_masks()
        # eps + softplus(c0) == 1: zero raw parameters give unit derivatives
        self._deriv_eps = 1e-3
        self._c0 = float(np.log(np.expm1(1.0 - self._deriv_eps)))
        per = 3 * self.n_bins - 1
        shapes = []
        for mask in self._masks:
            n_in, n_out = int(mask.sum()), int((~mask).sum())
            shapes += _mlp_sizes((n_in, self.hidden, per * n_out))
        shapes += [(self.dim,), (self.dim,)]  # affine head: shift, log_scale
        self._make_params(shapes, dtype)

    @torch.no_grad()
    def init(self, gen):
        """Draw the parameters from ``gen``; returns :meth:`param_list`."""
        params = self.param_list()
        for layer in range(self.n_layers):
            _mlp_init(gen, params[4 * layer:4 * layer + 4], self.dtype)
        params[-2].zero_()
        params[-1].zero_()
        return params

    def _spline_params(self, layer, a, n_out):
        k = self.n_bins
        theta = _mlp_apply(self.param_list()[4 * layer:4 * layer + 4], a)
        theta = theta.reshape(a.shape[:-1] + (n_out, 3 * k - 1))
        eps = 1e-3
        widths = torch.softmax(theta[..., :k], -1)
        widths = (eps + (1.0 - eps * k) * widths) * (2.0 * self.bound)
        heights = torch.softmax(theta[..., k:2 * k], -1)
        heights = (eps + (1.0 - eps * k) * heights) * (2.0 * self.bound)
        # softplus as log(1 + e^x) everywhere, as jax.nn.softplus (torch's
        # returns x itself past 20)
        raw = theta[..., 2 * k:] + self._c0
        inner = torch.logaddexp(raw, torch.zeros_like(raw)) + self._deriv_eps
        ones = torch.ones_like(inner[..., :1])
        return widths, heights, torch.cat([ones, inner, ones], -1)

    def _transform(self, v, inverse):
        shift, ls = self.param_list()[-2:]
        logdet = torch.zeros(v.shape[:1], dtype=v.dtype, device=v.device)
        layers = range(self.n_layers)
        if inverse:
            layers = reversed(layers)
            v = (v - shift) * torch.exp(-ls)
            logdet = logdet - torch.sum(ls)
        for layer in layers:
            a, b = self._split(v, layer)
            w, h, d = self._spline_params(layer, a, b.shape[-1])
            b, ld = _rq_spline(b, w, h, d, inverse=inverse)
            v = self._join(a, b, layer)
            logdet = logdet + torch.sum(ld, -1)
        if not inverse:
            v = v * torch.exp(ls) + shift
            logdet = logdet + torch.sum(ls)
        return v, logdet

    def forward(self, z):
        """(B, P) base draws -> (x, logdet (B,))."""
        return self._transform(z, inverse=False)

    def inverse(self, x):
        """(B, P) target points -> (z, logdet of dz/dx); one parallel pass
        (the quadratic formula inverts each bin)."""
        return self._transform(x, inverse=True)


# -- NeuTra ------------------------------------------------------------------


class FitResult(NamedTuple):
    elbo_history: np.ndarray
    final_elbo: float


def gaussian_logq(flow, x, dim):
    """log q(x) = log N(f⁻¹(x); 0, I) + log|det df⁻¹/dx| for (B, P) rows:
    the flow's density, as the forward-KL fits maximize it."""
    z, ld = flow.inverse(x)
    const = -0.5 * dim * np.log(2.0 * np.pi)
    return const - 0.5 * torch.sum(z * z, -1) + ld


class NeuTra:
    """Fit a flow to ``logp_fn`` and expose the warped target and the
    transport (≙ ``mcmcpp_tpu/neutra.py::NeuTra``)::

        nt = NeuTra(logp, dim).fit(2000)
        s = nt.make_sampler(NUTSSampler, n_chains=32)
        s.warmup(500); s.run(2000)
        x = nt.transform(s.get_samples(flat=True))

    ``logp_fn``: (P,) -> scalar, or with ``batched=True`` (B, P) -> (B,).
    ``flow``: a :class:`RealNVP` (default), :class:`IAF` or
    :class:`SplineCoupling`; it is moved to ``device`` and initialized from
    the NeuTra's generator. ``device`` defaults to "cuda" (CUDA without a
    GPU raises). ``mesh``: a ``WalkerLayout`` splitting the training batch
    over the ranks of a process group, on the layout's device (the batch
    must divide by the ranks).
    """

    def __init__(self, logp_fn, dim, flow=None, seed=0, dtype=torch.float32,
                 batched=False, mesh=None, device=None):
        self.mesh = mesh
        self.device = _engine_device(mesh, device)
        self.logp_fn = logp_fn
        self._logp = logp_fn if batched else torch.func.vmap(logp_fn)
        self.dim = int(dim)
        self.dtype = dtype
        self.flow = flow if flow is not None else RealNVP(self.dim,
                                                          dtype=dtype)
        self.flow.to(self.device)
        self._step_gen = make_generator(seed, STEP_STREAM, self.device)
        self.flow.init(self._step_gen)
        # the optimizer state of the last fit / refit_forward_kl: a
        # checkpoint (kind "neutra") keeps it, so a fit resumes warm
        self._opt_state = None
        self.fit_result = None
        self.refit_result = None

    @property
    def n_params(self):
        return self.dim

    @property
    def params(self):
        """The flow's parameters, in the JAX package's leaf order."""
        return self.flow.param_list()

    def _draw(self, noise, i, shape):
        if noise is not None:
            return noise[i].to(device=self.device, dtype=self.dtype)
        return torch.randn(shape, generator=self._step_gen, dtype=self.dtype,
                           device=self.device)

    def elbo(self, z):
        """Mean of logp(f(z)) + log|det| over the (B, P) base draws ``z``
        (the base entropy, constant in the parameters, is dropped)."""
        x, logdet = self.flow(z)
        return torch.mean(self._logp(x) + logdet)

    def _summed(self, obj, params, rows, batch):
        """(gradient of ``obj`` in ``params``, ``obj``) of the whole batch:
        unsharded ``obj`` is the batch's mean; sharded, the mean over the
        rank's ``rows`` of ``batch``, weighted by its share and summed over
        the ranks with its gradient in one all-reduce."""
        if self.mesh is None:
            return torch.autograd.grad(obj, params), obj.detach()
        if self.mesh.world_size > 1:
            obj = obj * ((rows.stop - rows.start) / batch)
        return summed_grad(self.mesh, obj, params)

    def fit(self, n_steps=2000, batch=128, learning_rate=1e-3, resume=False,
            noise=None):
        """Adam ascent on the ELBO. Returns self; the trace is in
        ``fit_result``. ``resume=True`` continues from the kept optimizer
        state, so ``fit(k); fit(k, resume=True)`` equals ``fit(2k)`` with a
        save and load between. ``noise``: optional (n_steps, batch, P)
        base draws in place of the generator's (every row's, when sharded).
        The ELBO trace stays on the device until the end (one host read)."""
        params = self.params
        state = (self._opt_state if resume and self._opt_state is not None
                 else adam_init(params))
        elbos = torch.empty(int(n_steps), dtype=self.dtype,
                            device=self.device)
        rows = own_rows(self.mesh, int(batch), "batch")
        for i in range(int(n_steps)):
            z = self._draw(noise, i, (int(batch), self.dim))[rows]
            grads, loss = self._summed(-self.elbo(z), params, rows,
                                       int(batch))
            state = adam_step(params, grads, state, learning_rate)
            elbos[i] = -loss
        self._opt_state = state
        hist = elbos.cpu().numpy()
        self.fit_result = FitResult(hist, float(hist[-100:].mean()))
        return self

    def refit_forward_kl(self, samples, n_steps=1000, batch=256,
                         learning_rate=1e-3, noise=None):
        """Refine the flow by maximum likelihood on posterior draws (forward
        KL), from a fresh Adam state. ``noise``: optional (n_steps, batch)
        row indices in place of the generator's. Returns self; the trace
        (mean log q) is in ``refit_result``. Samplers built before keep the
        parameters they were built with. Sharded, every rank passes the
        same ``samples`` and fits on its rows of each step's batch."""
        x = torch.as_tensor(np.asarray(samples) if not isinstance(
            samples, torch.Tensor) else samples).to(self.device, self.dtype)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"samples must be (N, {self.dim}), got "
                             f"{tuple(x.shape)}")
        n = x.shape[0]
        batch = int(min(batch, n))
        params = self.params
        state = adam_init(params)
        hist = torch.empty(int(n_steps), dtype=self.dtype,
                           device=self.device)
        rows = own_rows(self.mesh, batch, "batch")
        for i in range(int(n_steps)):
            idx = (noise[i].to(self.device) if noise is not None
                   else torch.randint(0, n, (batch,),
                                      generator=self._step_gen,
                                      device=self.device))[rows]
            grads, obj = self._summed(torch.mean(gaussian_logq(
                self.flow, x[idx], self.dim)), params, rows, batch)
            state = adam_step(params, [-g for g in grads], state,
                              learning_rate)
            hist[i] = obj
        self._opt_state = state
        hist = hist.cpu().numpy()
        self.refit_result = FitResult(hist, float(hist[-100:].mean()))
        return self

    # -- the warped target ---------------------------------------------------

    def warped_logp(self):
        """The z-space logp as a batched function (C, P) -> (C,), over a copy
        of the parameters as they are now (a later fit does not move it; a
        refit needs a new one) without gradient."""
        flow, logp = copy.deepcopy(self.flow).requires_grad_(False), self._logp

        def logp_z(z):
            x, logdet = flow(z)
            return logp(x) + logdet

        return logp_z

    def make_sampler(self, sampler_cls, n_chains, seed=1, **kw):
        """``sampler_cls`` (a gradient sampler of the port) on the warped
        target, started from base noise; sharded over the NeuTra's layout
        unless ``mesh=`` is given (every chain's start is drawn, and each
        rank keeps its rows)."""
        if self.mesh is not None:
            kw.setdefault("mesh", self.mesh)
        kw.setdefault("device", self.device)
        kw.setdefault("dtype", self.dtype)
        s = sampler_cls(self.warped_logp(), n_chains=n_chains,
                        n_params=self.dim, seed=seed, **kw)
        z0 = torch.randn((int(n_chains), self.dim), generator=self._step_gen,
                         dtype=self.dtype, device=self.device)
        s.init(z0)
        return s

    @torch.no_grad()
    def transform(self, z_draws):
        """(N, P) z-space draws -> (N, P) posterior draws (numpy)."""
        z = torch.as_tensor(np.asarray(z_draws) if not isinstance(
            z_draws, torch.Tensor) else z_draws)
        z = torch.atleast_2d(z.to(self.device, self.dtype))
        return self.flow(z)[0].cpu().numpy()

    def sample_approximate(self, gen, n):
        """(n, P) draws from the flow itself (VI quality, no MCMC); ``gen``
        a generator on the NeuTra's device, or None for its own."""
        gen = self._step_gen if gen is None else gen
        z = torch.randn((int(n), self.dim), generator=gen, dtype=self.dtype,
                        device=self.device)
        return self.transform(z)
