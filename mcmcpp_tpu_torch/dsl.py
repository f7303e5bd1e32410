"""Log-probability DSL: declarative models over the raw logp interface.

PyTorch counterpart of ``mcmcpp_tpu/dsl.py``. Named parameters with priors
and unconstraining transforms, composed with observed data and a likelihood,
compile to a flat per-θ ``logp`` that every engine of the port takes::

    model = (Model()
             .param("mu", Normal(0.0, 10.0))
             .param("sigma", HalfNormal(1.0))
             .observe("y", lambda p: Normal(p["mu"], p["sigma"]), data))
    logp, dim, constrain = model.build()
    s = NUTSSampler(torch.func.vmap(logp), n_chains=32, n_params=dim)
    ...
    posterior = constrain(s.get_samples(flat=True))  # dict of named draws

``logp`` maps a (D,) tensor to a scalar with torch ops alone: no ``.item()``,
no Python branch on a tensor's value, masked observes by the double
``where``; so ``torch.func.vmap(logp)`` is the batched logp the samplers
vmap or take, and autograd differentiates it. Sampling runs in unconstrained
space (exp/sigmoid transforms with their Jacobians).

Conventions of the port:

- numbers stay Python floats inside the density (torch treats them as
  scalars: no copy to the device, no dtype promotion); numpy arrays given as
  parameters or data become tensors of the logp's dtype on its device the
  first time they are met there, and are kept (``_const``), so a logp on the
  card copies nothing to it after its first call (and, like a traced JAX
  logp with the constants it was traced with, does not see an array that is
  changed in place afterwards; ``observe`` copies its data, as JAX's does);
- ``sample(gen, shape)`` takes a ``torch.Generator`` where JAX takes a key
  and draws on the generator's device (float32 unless a parameter is a
  float64 tensor); the streams differ from JAX's;
- the special functions torch lacks come from :mod:`.ops.special`
  (``betainc``, ``gammainc``/``gammaincc`` with a gradient in the shape,
  ``log_ndtr`` with a vmap rule); the incomplete beta's and gammas' term
  loops test the host every 16 terms and end once the whole batch has
  converged, the one host sync a DSL logp makes;
- the predictives and a hierarchical prior's draws are vmapped over the
  draws (``randomness="different"``), each site drawn once for all of them.
"""

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F

from mcmcpp_tpu_torch.ops import special

# the elliptical slice's and the nested slice's rhythm: a rejection loop tests
# the host for unfinished draws every few rounds
CHECK_EVERY = 4
# under torch.func.vmap no value may steer Python, so a rejection loop runs a
# fixed number of rounds there: Best & Fisher's von Mises sampler accepts with
# probability above 0.65 a round, so a draw is left unaccepted after 64 rounds
# with probability below 1e-29
VMAP_ROUNDS = 64
_LOG_2PI = math.log(2.0 * math.pi)

# -- constants on the logp's device --------------------------------------------

# a process-wide table (the distributions that read it are built inside the
# user's lambdas, a logp at a time, and hold no model to keep it in): bounded,
# keyed by the array's identity, and holding the array so the key stays valid
_CONSTS = {}
_CONSTS_MAX = 512


def _is_num(v):
    return isinstance(v, (bool, int, float, np.integer, np.floating))


def _const(v, ref):
    """``v`` (a numpy array, list or CPU tensor) as a tensor of ``ref``'s
    floating dtype on ``ref``'s device. numpy arrays are converted once per
    (array, device, dtype) and kept while the array lives in the table."""
    dtype, device = ref.dtype, ref.device
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    if isinstance(v, np.ndarray):
        key = (id(v), str(device), dtype)
        hit = _CONSTS.get(key)
        if hit is not None and hit[0] is v:
            return hit[1]
        t = torch.as_tensor(np.array(v, np.float64), device=device).to(dtype)
        if len(_CONSTS) >= _CONSTS_MAX:
            _CONSTS.clear()
        _CONSTS[key] = (v, t)
        return t
    return torch.as_tensor(np.array(v, np.float64), device=device).to(dtype)


def _mask(v, ref):
    """A boolean mask on ``ref``'s device (kept like :func:`_const`)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=ref.device, dtype=torch.bool)
    key = (id(v), str(ref.device), torch.bool)
    hit = _CONSTS.get(key)
    if hit is not None and hit[0] is v:
        return hit[1]
    t = torch.as_tensor(np.array(v, bool), device=ref.device)
    if len(_CONSTS) >= _CONSTS_MAX:
        _CONSTS.clear()
    _CONSTS[key] = (v, t)
    return t


def _bool_array(v):
    return v.bool() if isinstance(v, torch.Tensor) else np.asarray(v, bool)


def _p(v, ref):
    """A distribution parameter beside the tensor ``ref``: numbers become
    Python floats, tensors pass, anything else becomes a tensor on ref's
    device (:func:`_const`)."""
    if _is_num(v):
        return float(v)
    if isinstance(v, torch.Tensor):
        return v
    return _const(v, ref)


def _t(v, ref):
    """A parameter as a tensor of ref's dtype on ref's device (a number is
    filled in there, with no copy)."""
    v = _p(v, ref)
    if isinstance(v, float):
        return torch.full((), v, dtype=ref.dtype, device=ref.device)
    return v


def _x(x):
    """A point of a density: tensors pass, anything else becomes a CPU
    tensor of its numpy dtype (float64 for numbers)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.array(x, np.float64))


def _fn(tfn, mfn):
    def f(v):
        return tfn(v) if isinstance(v, torch.Tensor) else mfn(v)
    return f


_log = _fn(torch.log, math.log)
_log1p = _fn(torch.log1p, math.log1p)
_exp = _fn(torch.exp, math.exp)
_sqrt = _fn(torch.sqrt, math.sqrt)
_lgamma = _fn(torch.lgamma, math.lgamma)


def _log_sigmoid(v):
    if isinstance(v, torch.Tensor):
        return F.logsigmoid(v)
    return -math.log1p(math.exp(-v)) if v >= 0 else v - math.log1p(math.exp(v))


def _sigmoid(v):
    return torch.sigmoid(v) if isinstance(v, torch.Tensor) else (
        1.0 / (1.0 + math.exp(-v)))


def _norm_logpdf(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - _log(scale) - 0.5 * _LOG_2PI


def _t_logpdf(x, df, loc, scale):
    z = (x - loc) / scale
    return (_lgamma((df + 1.0) / 2.0) - _lgamma(df / 2.0)
            - 0.5 * _log(df * math.pi) - _log(scale)
            - (df + 1.0) / 2.0 * torch.log1p(z * z / df))


def _cauchy_logpdf(x, loc, scale):
    z = (x - loc) / scale
    return -math.log(math.pi) - _log(scale) - torch.log1p(z * z)


# -- sampling helpers (a torch.Generator in place of a JAX key) ----------------


def _sdtype(*params):
    """float64 when a parameter is a float64 tensor, else float32."""
    return (torch.float64 if any(isinstance(v, torch.Tensor)
                                 and v.dtype == torch.float64 for v in params)
            else torch.float32)


def _sref(gen, *params):
    """A 0-d reference tensor on the generator's device with the draws'
    dtype (for :func:`_p`)."""
    return torch.empty((), dtype=_sdtype(*params), device=gen.device)


def _normal(gen, shape, ref):
    return torch.randn(tuple(shape), generator=gen, dtype=ref.dtype,
                       device=ref.device)


def _uniform(gen, shape, ref, lo=0.0, hi=1.0):
    u = torch.rand(tuple(shape), generator=gen, dtype=ref.dtype,
                   device=ref.device)
    return lo + (hi - lo) * u if (lo, hi) != (0.0, 1.0) else u


def _exponential(gen, shape, ref):
    # out of place (an in-place draw cannot differ across a vmapped batch)
    return -torch.log1p(-_uniform(gen, shape, ref))


def _cauchy(gen, shape, ref):
    return torch.tan(math.pi * (_uniform(gen, shape, ref) - 0.5))


def _gamma(gen, conc, shape, ref):
    a = _t(conc, ref).expand(tuple(shape)).contiguous()
    return torch._standard_gamma(a, generator=gen)


def _beta(gen, a, b, shape, ref):
    x = _gamma(gen, a, shape, ref)
    y = _gamma(gen, b, shape, ref)
    return x / (x + y)


def _student_t(gen, df, shape, ref):
    z = _normal(gen, shape, ref)
    chi2 = 2.0 * _gamma(gen, _p(df, ref) / 2.0, shape, ref)
    return z / torch.sqrt(chi2 / _p(df, ref))


def _categorical(gen, logits, shape, ref):
    """Gumbel-max draws of indices over the last axis of ``logits``."""
    logits = _t(logits, ref)
    g = -torch.log(_exponential(gen, tuple(shape) + logits.shape[-1:], ref))
    return torch.argmax(logits + g, dim=-1)


# -- transforms (unconstrained u -> constrained x, with log|dx/du|) ---------


class Identity:
    def forward(self, u):
        return u

    def inverse(self, x):
        return _x(x)

    def log_det(self, u):
        return torch.zeros_like(u)


class Exp:
    """u -> exp(u): positive support."""

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(_x(x))

    def log_det(self, u):
        return u


class Sigmoid:
    """u -> a + (b-a)·σ(u): interval support."""

    def __init__(self, a, b):
        self.a, self.b = float(a), float(b)

    def forward(self, u):
        return self.a + (self.b - self.a) * torch.sigmoid(u)

    def inverse(self, x):
        p = (_x(x) - self.a) / (self.b - self.a)
        return torch.log(p) - torch.log1p(-p)

    def log_det(self, u):
        return math.log(self.b - self.a) + F.logsigmoid(u) + F.logsigmoid(-u)


class LowerBound:
    """u -> lo + exp(u): support (lo, inf)."""

    def __init__(self, lo):
        self.lo = float(lo)

    def forward(self, u):
        return self.lo + torch.exp(u)

    def inverse(self, x):
        return torch.log(_x(x) - self.lo)

    def log_det(self, u):
        return u


class UpperBound:
    """u -> hi - exp(u): support (-inf, hi)."""

    def __init__(self, hi):
        self.hi = float(hi)

    def forward(self, u):
        return self.hi - torch.exp(u)

    def inverse(self, x):
        return torch.log(self.hi - _x(x))

    def log_det(self, u):
        return u


class Ordered:
    """u -> strictly increasing vector over the LAST axis:
    ``x_1 = u_1, x_k = x_{k-1} + exp(u_k)`` (Stan's ordered type). The prior
    is the declared iid prior restricted to the ordered region; ``log_norm``
    is its normalizer log K!, and ``inverse_sample`` draws from it exactly
    by sorting iid base draws."""

    def forward(self, u):
        inc = torch.cat([u[..., :1], torch.exp(u[..., 1:])], dim=-1)
        return torch.cumsum(inc, dim=-1)

    def inverse(self, x):
        x = _x(x)
        return torch.cat([x[..., :1], torch.log(torch.diff(x, dim=-1))],
                         dim=-1)

    def inverse_sample(self, gen, x):
        """Unsorted iid base draws -> exact restricted-prior draws (their
        order statistics)."""
        del gen  # deterministic given the base draws
        return self.inverse(torch.sort(_x(x), dim=-1).values)

    def log_det(self, u):
        return torch.cat([torch.zeros_like(u[..., :1]), u[..., 1:]], dim=-1)

    def log_norm(self, u):
        """log K! per ordered vector (the ordered region has base measure
        1/K!)."""
        k = u.shape[-1]
        return math.lgamma(k + 1.0) * torch.ones_like(u[..., 0])

    def unconstrained_shape(self, shape):
        if not shape:
            raise ValueError(
                "ordered() requires a vector-shaped parameter "
                "(shape with at least one axis)"
            )
        return tuple(shape)


def ordered(dist):
    """Impose the :class:`Ordered` constraint on a vector-shaped continuous
    prior::

        Model().param("locs", ordered(Normal(0.0, 5.0)), shape=(K,))
    """
    d = copy.copy(dist)
    d.transform = Ordered()
    return d


class Circular:
    """u (…, 2) -> angle in (-π, π] via atan2 (Stan's unit-vector trick): no
    cut at ±π. ``log_det`` is the auxiliary radial density −‖u‖²/2, under
    which the implied marginal of θ is exactly the declared distribution."""

    def forward(self, u):
        return torch.atan2(u[..., 1], u[..., 0])

    def inverse(self, x):
        x = _x(x)
        return torch.stack([torch.cos(x), torch.sin(x)], dim=-1)

    def inverse_sample(self, gen, x):
        """A constrained draw to u-space with the auxiliary radius r ~
        Rayleigh, so u is an exact draw from the implied unconstrained
        prior."""
        x = _x(x)
        r = torch.sqrt(2.0 * _exponential(gen, x.shape, x))
        return r[..., None] * self.inverse(x)

    def log_det(self, u):
        return -0.5 * torch.sum(u * u, dim=-1)

    def unconstrained_shape(self, shape):
        return tuple(shape) + (2,)


class StickBreaking:
    """R^{K-1} -> interior of the K-simplex (Stan's stick-breaking map):
    z_i = sigmoid(u_i - log(K-1-i)), x_i = z_i · (remaining stick);
    ``log_det`` is with respect to the first K-1 coordinates."""

    def __init__(self, k):
        self.k = int(k)
        if self.k < 2:
            raise ValueError("simplex needs K >= 2")

    def unconstrained_shape(self, shape):
        if tuple(shape) != (self.k,):
            raise ValueError(
                f"StickBreaking({self.k}) requires shape ({self.k},), "
                f"got {tuple(shape)}"
            )
        return (self.k - 1,)

    def _offsets(self, ref):
        return torch.log(torch.arange(self.k - 1, 0, -1, dtype=ref.dtype,
                                      device=ref.device))

    def forward(self, u):
        z = torch.sigmoid(u - self._offsets(u))
        stick = torch.cumprod(1.0 - z, dim=-1)
        s = torch.cat([torch.ones_like(stick[..., :1]), stick[..., :-1]],
                      dim=-1)
        return torch.cat([z * s, stick[..., -1:]], dim=-1)

    def inverse(self, x):
        x = _x(x)
        head = x[..., :-1]
        csum = torch.cumsum(head, dim=-1)
        s = torch.cat([torch.ones_like(csum[..., :1]), 1.0 - csum[..., :-1]],
                      dim=-1)
        z = head / s
        return torch.log(z) - torch.log1p(-z) + self._offsets(x)

    def log_det(self, u):
        z = torch.sigmoid(u - self._offsets(u))
        stick = torch.cumprod(1.0 - z, dim=-1)
        s = torch.cat([torch.ones_like(stick[..., :1]), stick[..., :-1]],
                      dim=-1)
        return torch.sum(torch.log(z) + torch.log1p(-z) + torch.log(s),
                         dim=-1)


class CorrCholesky:
    """R^{K(K-1)/2} -> lower Cholesky factor of a correlation matrix (Stan's
    canonical partial correlations): z = tanh(u) fills the strict lower
    triangle row-wise; L[i,j] = z_ij·sqrt(1 − Σ_{k<j} L[i,k]²) and L[i,i]
    closes each row to unit norm."""

    def __init__(self, k):
        self.k = int(k)
        if self.k < 2:
            raise ValueError("correlation matrix needs K >= 2")
        # row-major strict lower triangle: (1,0), (2,0), (2,1), ...
        self._rows_np, self._cols_np = np.tril_indices(self.k, -1)

    def unconstrained_shape(self, shape):
        if tuple(shape) != (self.k, self.k):
            raise ValueError(
                f"CorrCholesky({self.k}) requires shape "
                f"({self.k}, {self.k}), got {tuple(shape)}"
            )
        return (self.k * (self.k - 1) // 2,)

    def _tril(self, ref):
        return (torch.as_tensor(self._rows_np, device=ref.device),
                torch.as_tensor(self._cols_np, device=ref.device))

    def _exclusive_mass(self, z):
        """mass[..., i, j] = Π_{k<j} (1 − z[i,k]²) (an exclusive cumprod)."""
        cp = torch.cumprod(1.0 - z * z, dim=-1)
        return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)

    def _embed(self, z_flat):
        """(…, K(K−1)/2) -> (…, K, K) strict lower triangle, as a product
        with a 0/1 matrix (no in-place write, so vmap and autograd pass)."""
        m = self.k * (self.k - 1) // 2
        e = np.zeros((m, self.k * self.k))
        e[np.arange(m), self._rows_np * self.k + self._cols_np] = 1.0
        emb = _const(e, z_flat)
        return (z_flat @ emb).reshape(z_flat.shape[:-1] + (self.k, self.k))

    def _rows(self, z_flat):
        """L from flat partial correlations; batch-aware."""
        z = self._embed(z_flat)
        mass = self._exclusive_mass(z)
        eye = torch.eye(self.k, dtype=z.dtype, device=z.device)
        return (z + eye) * torch.sqrt(mass)

    def forward(self, u):
        return self._rows(torch.tanh(u))

    def inverse(self, L):
        L = _x(L)
        rows, cols = self._tril(L)
        tri = torch.tril(L, -1)
        sq = tri * tri
        mass = 1.0 - (torch.cumsum(sq, dim=-1) - sq)
        z = L[..., rows, cols] / torch.sqrt(mass[..., rows, cols])
        return torch.atanh(z)

    def log_det(self, u):
        z_flat = torch.tanh(u)
        ld = torch.sum(torch.log1p(-z_flat * z_flat), dim=-1)
        z = self._embed(z_flat)
        rows, cols = self._tril(u)
        half_log_mass = 0.5 * torch.log(self._exclusive_mass(z))
        return ld + torch.sum(half_log_mass[..., rows, cols], dim=-1)


# -- distributions -----------------------------------------------------------


class Distribution:
    """logpdf on the CONSTRAINED space; ``transform`` maps an unconstrained
    sampler coordinate onto the support."""

    transform = Identity()

    def logpdf(self, x):
        raise NotImplementedError

    def sample(self, gen, shape=()):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        x = _x(x)
        return _norm_logpdf(x, _p(self.loc, x), _p(self.scale, x))

    def cdf(self, x):
        x = _x(x)
        return special.ndtr((x - _p(self.loc, x)) / _p(self.scale, x))

    def log_cdf(self, x):
        x = _x(x)
        return special.log_ndtr((x - _p(self.loc, x)) / _p(self.scale, x))

    def log_sf(self, x):
        # symmetry: P(X > x) = Phi(-(x - loc)/scale), exact in the tail
        x = _x(x)
        return special.log_ndtr(-(x - _p(self.loc, x)) / _p(self.scale, x))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.loc, self.scale)
        return (_p(self.loc, ref)
                + _p(self.scale, ref) * _normal(gen, shape, ref))


class Laplace(Distribution):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        x = _x(x)
        scale = _p(self.scale, x)
        return -_log(2.0 * scale) - torch.abs(x - _p(self.loc, x)) / scale

    def cdf(self, x):
        x = _x(x)
        z = (x - _p(self.loc, x)) / _p(self.scale, x)
        return torch.where(z < 0, 0.5 * torch.exp(z),
                           1.0 - 0.5 * torch.exp(-z))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.loc, self.scale)
        u = _uniform(gen, shape, ref, -1.0, 1.0)
        # inverse cdf; u = ±1 exactly is excluded by the open interval
        lap = -torch.sign(u) * torch.log1p(-torch.abs(u))
        return _p(self.loc, ref) + _p(self.scale, ref) * lap


class Cauchy(Distribution):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        x = _x(x)
        return _cauchy_logpdf(x, _p(self.loc, x), _p(self.scale, x))

    def cdf(self, x):
        x = _x(x)
        z = (x - _p(self.loc, x)) / _p(self.scale, x)
        return 0.5 + torch.atan(z) / math.pi

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.loc, self.scale)
        return (_p(self.loc, ref)
                + _p(self.scale, ref) * _cauchy(gen, shape, ref))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = df, loc, scale

    def logpdf(self, x):
        x = _x(x)
        return _t_logpdf(x, _p(self.df, x), _p(self.loc, x),
                         _p(self.scale, x))

    def cdf(self, x):
        x = _x(x)
        df = _p(self.df, x)
        z = (x - _p(self.loc, x)) / _p(self.scale, x)
        w = df / (df + z * z)
        tail = 0.5 * special.betainc(_t(df, x) / 2.0, 0.5, w)
        return torch.where(z > 0, 1.0 - tail, tail)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.df, self.loc, self.scale)
        return (_p(self.loc, ref)
                + _p(self.scale, ref) * _student_t(gen, self.df, shape, ref))


class HalfNormal(Distribution):
    transform = Exp()

    def __init__(self, scale=1.0):
        self.scale = scale

    def logpdf(self, x):
        x = _x(x)
        return math.log(2.0) + _norm_logpdf(x, 0.0, _p(self.scale, x))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.scale)
        return torch.abs(_p(self.scale, ref) * _normal(gen, shape, ref))


class HalfCauchy(Distribution):
    """Half-Cauchy on (0, inf): the weakly-informative scale prior."""

    transform = Exp()

    def __init__(self, scale=1.0):
        self.scale = scale

    def logpdf(self, x):
        x = _x(x)
        return math.log(2.0) + _cauchy_logpdf(x, 0.0, _p(self.scale, x))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.scale)
        return torch.abs(_p(self.scale, ref) * _cauchy(gen, shape, ref))


class LogNormal(Distribution):
    transform = Exp()

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        x = _x(x)
        lx = torch.log(x)
        return _norm_logpdf(lx, _p(self.loc, x), _p(self.scale, x)) - lx

    def cdf(self, x):
        x = _x(x)
        z = ((torch.log(torch.clamp(x, min=1e-38)) - _p(self.loc, x))
             / _p(self.scale, x))
        return special.ndtr(z)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.loc, self.scale)
        return torch.exp(_p(self.loc, ref)
                         + _p(self.scale, ref) * _normal(gen, shape, ref))


class Exponential(Distribution):
    transform = Exp()

    def __init__(self, rate=1.0):
        self.rate = rate

    def logpdf(self, x):
        x = _x(x)
        rate = _p(self.rate, x)
        return _log(rate) - rate * x

    def cdf(self, x):
        x = _x(x)
        return -torch.expm1(-_p(self.rate, x) * torch.clamp(x, min=0.0))

    def log_sf(self, x):
        x = _x(x)
        return -_p(self.rate, x) * torch.clamp(x, min=0.0)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.rate)
        return _exponential(gen, shape, ref) / _p(self.rate, ref)


class Gamma(Distribution):
    transform = Exp()

    def __init__(self, concentration, rate=1.0):
        self.concentration, self.rate = concentration, rate

    def logpdf(self, x):
        x = _x(x)
        a, rate = _p(self.concentration, x), _p(self.rate, x)
        y = x * rate
        lp = torch.xlogy(_t(a, x) - 1.0, y) - y - _lgamma(a) + _log(rate)
        return torch.where(x < 0, -math.inf, lp)

    def cdf(self, x):
        x = _x(x)
        return special.gammainc(
            _t(self.concentration, x),
            _p(self.rate, x) * torch.clamp(x, min=0.0))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.concentration, self.rate)
        return (_gamma(gen, self.concentration, shape, ref)
                / _p(self.rate, ref))


class Beta(Distribution):
    transform = Sigmoid(0.0, 1.0)

    def __init__(self, a, b):
        self.a, self.b = a, b

    def logpdf(self, x):
        x = _x(x)
        a, b = _p(self.a, x), _p(self.b, x)
        lp = (torch.xlogy(_t(a, x) - 1.0, x)
              + torch.special.xlog1py(_t(b, x) - 1.0, -x)
              - (_lgamma(a) + _lgamma(b) - _lgamma(a + b)))
        return torch.where((x < 0) | (x > 1), -math.inf, lp)

    def cdf(self, x):
        x = _x(x)
        return special.betainc(_t(self.a, x), _t(self.b, x),
                               torch.clamp(x, 0.0, 1.0))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.a, self.b)
        return _beta(gen, self.a, self.b, shape, ref)


class Uniform(Distribution):
    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = float(low), float(high)
        self.transform = Sigmoid(self.low, self.high)

    def logpdf(self, x):
        x = _x(x)
        in_support = (x >= self.low) & (x <= self.high)
        lp = torch.full_like(x, -math.log(self.high - self.low))
        return torch.where(in_support, lp, -math.inf)

    def cdf(self, x):
        x = _x(x)
        return torch.clamp((x - self.low) / (self.high - self.low), 0.0, 1.0)

    def sample(self, gen, shape=()):
        return _uniform(gen, shape, _sref(gen), self.low, self.high)


class Truncated(Distribution):
    """Continuous base distribution truncated to [low, high].

    ``logpdf`` renormalizes by log(F(high) − F(low)) with the base's ``cdf``
    and is −inf outside the bounds; the sampler ``transform`` maps onto the
    truncated support (Sigmoid two-sided, an exp shift one-sided);
    ``sample`` inverts the cdf by 60 bisection steps. Usable as a prior and
    at observe sites.
    """

    def __init__(self, base, low=None, high=None):
        if low is None and high is None:
            raise ValueError("pass at least one of low=/high=")
        if not hasattr(base, "cdf"):
            raise ValueError(
                f"{type(base).__name__} has no cdf(); truncation needs one"
            )
        if isinstance(base.transform, (StickBreaking, CorrCholesky)):
            raise ValueError("cannot truncate a multivariate-support prior")
        self.base = base
        self.low = None if low is None else float(low)
        self.high = None if high is None else float(high)
        if self.low is not None and self.high is not None:
            if not self.low < self.high:
                raise ValueError("need low < high")
            self.transform = Sigmoid(self.low, self.high)
        elif self.low is not None:
            self.transform = LowerBound(self.low)
        else:
            self.transform = UpperBound(self.high)

    def _log_z(self, ref):
        f_lo = (0.0 if self.low is None
                else self.base.cdf(_t(self.low, ref)))
        f_hi = (1.0 if self.high is None
                else self.base.cdf(_t(self.high, ref)))
        mass = f_hi - f_lo
        mass = (torch.clamp(mass, min=1e-38) if isinstance(mass, torch.Tensor)
                else max(mass, 1e-38))
        return _log(mass), f_lo, f_hi

    def logpdf(self, x):
        x = _x(x)
        log_z, _, _ = self._log_z(x)
        lp = self.base.logpdf(x) - log_z
        if self.low is not None:
            lp = torch.where(x >= self.low, lp, -math.inf)
        if self.high is not None:
            lp = torch.where(x <= self.high, lp, -math.inf)
        return lp

    def cdf(self, x):
        x = _x(x)
        _, f_lo, f_hi = self._log_z(x)
        c = (self.base.cdf(x) - f_lo) / torch.clamp(_t(f_hi - f_lo, x),
                                                    min=1e-38)
        return torch.clamp(c, 0.0, 1.0)

    def _bracket(self, ref):
        """Finite search bracket covering the truncated support: a missing
        bound is replaced by an extreme base quantile (60 doubling steps)."""
        lo = None if self.low is None else _t(self.low, ref)
        hi = None if self.high is None else _t(self.high, ref)
        anchor = lo if lo is not None else hi
        if lo is None:
            lo = anchor - 1.0
            for _ in range(60):
                lo = torch.where(self.base.cdf(lo) > 1e-9,
                                 anchor - 2.0 * (anchor - lo), lo)
        if hi is None:
            hi = anchor + 1.0
            for _ in range(60):
                hi = torch.where(self.base.cdf(hi) < 1.0 - 1e-9,
                                 anchor + 2.0 * (hi - anchor), hi)
        return lo, hi

    def sample(self, gen, shape=()):
        ref = _sref(gen)
        _, f_lo, f_hi = self._log_z(ref)
        u = _uniform(gen, shape, ref, 1e-7, 1.0 - 1e-7)
        target = f_lo + u * (f_hi - f_lo)
        lo, hi = self._bracket(ref)
        lo = lo.expand(tuple(shape))
        hi = hi.expand(tuple(shape))
        for _ in range(60):  # bisection to float32 resolution
            mid = 0.5 * (lo + hi)
            below = self.base.cdf(mid) < target
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return 0.5 * (lo + hi)


class MvNormal(Distribution):
    """Multivariate normal with full covariance (or its Cholesky). Declare
    with ``shape=(K,)``; ``sample(gen, shape)`` takes the full output shape
    including the trailing event dim K."""

    def __init__(self, loc, cov=None, chol=None):
        if (cov is None) == (chol is None):
            raise ValueError("pass exactly one of cov= or chol=")
        self.loc = loc
        if chol is None:
            chol = (torch.linalg.cholesky(cov) if isinstance(cov, torch.Tensor)
                    else np.linalg.cholesky(np.asarray(cov, np.float64)))
        self.chol = chol
        self.k = int(chol.shape[-1])

    def logpdf(self, x):
        x = _x(x)
        chol = _t(self.chol, x)
        d = x - _p(self.loc, x)
        y = torch.linalg.solve_triangular(chol, d[..., None],
                                          upper=False)[..., 0]
        half_logdet = torch.sum(torch.log(torch.diagonal(chol, 0, -2, -1)),
                                dim=-1)
        return (-0.5 * torch.sum(y * y, dim=-1) - half_logdet
                - 0.5 * self.k * _LOG_2PI)

    def sample(self, gen, shape=()):
        if not shape or shape[-1] != self.k:
            raise ValueError(f"output shape must end in event dim {self.k}")
        ref = _sref(gen, self.loc, self.chol)
        z = _normal(gen, shape, ref)
        return _p(self.loc, ref) + z @ _t(self.chol, ref).T


class GaussianRandomWalk(Distribution):
    """Gaussian random walk over a ``shape=(T,)`` site: ``x_1 ~ N(drift,
    init_scale)``, ``x_t = x_{t-1} + drift + eps_t``, eps_t ~ N(0, scale)."""

    def __init__(self, scale=1.0, init_scale=None, drift=0.0):
        self.scale = scale
        self.init_scale = scale if init_scale is None else init_scale
        self.drift = drift

    def logpdf(self, x):
        x = _x(x)
        drift = _p(self.drift, x)
        lp0 = _norm_logpdf(x[..., 0], drift, _p(self.init_scale, x))
        steps = x[..., 1:] - x[..., :-1]
        return lp0 + torch.sum(_norm_logpdf(steps, drift, _p(self.scale, x)),
                               dim=-1)

    def sample(self, gen, shape=()):
        if not shape:
            raise ValueError("GaussianRandomWalk needs shape=(..., T)")
        ref = _sref(gen, self.scale, self.init_scale, self.drift)
        z = _normal(gen, shape, ref)
        scales = torch.cat([
            _t(self.init_scale, ref).reshape(1),
            _t(self.scale, ref).expand(shape[-1] - 1),
        ])
        return torch.cumsum(z * scales + _p(self.drift, ref), dim=-1)


class AR1(Distribution):
    """Stationary AR(1) over a ``shape=(T,)`` site: ``x_t = mu + phi
    (x_{t-1} - mu) + sigma eps_t`` with the stationary initial law
    ``x_1 ~ N(mu, sigma^2 / (1 - phi^2))``; |phi| < 1 is the caller's
    contract."""

    def __init__(self, phi, sigma=1.0, mu=0.0):
        self.phi, self.sigma, self.mu = phi, sigma, mu

    def _init_scale(self, ref):
        phi = _p(self.phi, ref)
        return _p(self.sigma, ref) / _sqrt(1.0 - phi * phi)

    def logpdf(self, x):
        x = _x(x)
        c = x - _p(self.mu, x)
        lp0 = _norm_logpdf(c[..., 0], 0.0, self._init_scale(x))
        resid = c[..., 1:] - _p(self.phi, x) * c[..., :-1]
        return lp0 + torch.sum(_norm_logpdf(resid, 0.0, _p(self.sigma, x)),
                               dim=-1)

    def sample(self, gen, shape=()):
        if not shape:
            raise ValueError("AR1 needs shape=(..., T)")
        ref = _sref(gen, self.phi, self.sigma, self.mu)
        z = _normal(gen, shape, ref)
        phi, sigma = _p(self.phi, ref), _p(self.sigma, ref)
        # JAX's lax.scan over T, as a loop over T
        devs = [z[..., 0] * self._init_scale(ref)]
        for t in range(1, shape[-1]):
            devs.append(phi * devs[-1] + sigma * z[..., t])
        return _p(self.mu, ref) + torch.stack(devs, dim=-1)


class Dirichlet(Distribution):
    """Dirichlet over the K-simplex; declare with ``shape=(K,)`` (sampled in
    K-1 stick-breaking coordinates)."""

    def __init__(self, concentration):
        self.concentration = concentration
        shape = tuple(np.shape(concentration))
        if len(shape) != 1 or shape[0] < 2:
            raise ValueError("concentration must be a (K>=2,) vector")
        self.transform = StickBreaking(shape[0])

    def logpdf(self, x):
        x = _x(x)
        a = _t(self.concentration, x)
        norm = torch.sum(torch.lgamma(a)) - torch.lgamma(torch.sum(a))
        return torch.sum((a - 1.0) * torch.log(x), dim=-1) - norm

    def sample(self, gen, shape=()):
        k = self.transform.k
        if not shape or shape[-1] != k:
            raise ValueError(f"output shape must end in event dim {k}")
        ref = _sref(gen, self.concentration)
        a = _t(self.concentration, ref).expand(tuple(shape)).contiguous()
        return torch._sample_dirichlet(a, generator=gen)


class GEM(Distribution):
    """Truncated stick-breaking (GEM) weights for Dirichlet-process mixtures;
    declare with ``shape=(K,)``. Sticks v_i ~ Beta(1, alpha), i < K; the
    density on the simplex telescopes to
    (K−1)·log α + (α−1)·log w_K − Σ_{i<K} log rem_i."""

    def __init__(self, alpha, k):
        self.alpha = alpha
        self.k = int(k)
        if self.k < 2:
            raise ValueError("GEM needs K >= 2")
        self.transform = StickBreaking(self.k)

    def logpdf(self, x):
        x = _x(x)
        a = _p(self.alpha, x)
        head = x[..., :-1]
        csum = torch.cumsum(head, dim=-1)
        rem = torch.cat([torch.ones_like(csum[..., :1]), 1.0 - csum[..., :-1]],
                        dim=-1)
        return ((self.k - 1) * _log(a) + (a - 1.0) * torch.log(x[..., -1])
                - torch.sum(torch.log(rem), dim=-1))

    def sample(self, gen, shape=()):
        if not shape or shape[-1] != self.k:
            raise ValueError(f"output shape must end in event dim {self.k}")
        ref = _sref(gen, self.alpha)
        u = _uniform(gen, tuple(shape[:-1]) + (self.k - 1,), ref)
        v = 1.0 - u ** (1.0 / _p(self.alpha, ref))  # Beta(1, alpha)
        stick = torch.cumprod(1.0 - v, dim=-1)
        s = torch.cat([torch.ones_like(stick[..., :1]), stick[..., :-1]],
                      dim=-1)
        return torch.cat([v * s, stick[..., -1:]], dim=-1)


def _logits_of(probs, logits, ref):
    if logits is not None:
        return _p(logits, ref)
    p = _p(probs, ref)
    return _log(p) - _log1p(-p)


class Bernoulli(Distribution):
    """Bernoulli over {0, 1}; exactly one of probs/logits. Discrete: for
    ``observe`` sites and predictives, not as a ``param``."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs= or logits=")
        self.probs, self._logits = probs, logits

    def logpdf(self, x):
        x = _x(x)
        lg = _logits_of(self.probs, self._logits, x)
        return x * _log_sigmoid(lg) + (1.0 - x) * _log_sigmoid(-lg)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.probs, self._logits)
        p = _sigmoid(_logits_of(self.probs, self._logits, ref))
        u = _uniform(gen, shape, ref)
        return (u < p).to(torch.float32)


class Poisson(Distribution):
    """Poisson counts; ``rate`` > 0. Discrete: for ``observe`` sites."""

    def __init__(self, rate):
        self.rate = rate

    def logpdf(self, x):
        x = _x(x)
        rate = _p(self.rate, x)
        return x * _log(rate) - rate - torch.lgamma(x + 1.0)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.rate)
        rate = _t(self.rate, ref).expand(tuple(shape)).contiguous()
        return torch.poisson(rate, generator=gen).to(torch.float32)


class Binomial(Distribution):
    """Binomial(n, p); exactly one of probs/logits. Discrete: for
    ``observe`` sites."""

    def __init__(self, n, probs=None, logits=None):
        self.n = n
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs= or logits=")
        self.probs, self._logits = probs, logits

    def logpdf(self, x):
        x = _x(x)
        n = _p(self.n, x)
        lg = _logits_of(self.probs, self._logits, x)
        comb = (_lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                - torch.lgamma(n - x + 1.0))
        return comb + x * _log_sigmoid(lg) + (n - x) * _log_sigmoid(-lg)

    def sample(self, gen, shape=()):
        if np.ndim(self.n) != 0:
            raise ValueError("sampling requires a scalar static n")
        n = int(self.n)
        ref = _sref(gen, self.probs, self._logits)
        p = _sigmoid(_logits_of(self.probs, self._logits, ref))
        if n <= 256:
            # exact: a sum of n Bernoulli draws
            u = _uniform(gen, (n,) + tuple(shape), ref)
            return torch.sum(u < p, dim=0).to(torch.float32)
        # large n: 60-step bisection on the exact cdf,
        # P(X <= k) = I_{1-p}(n-k, k+1), in O(|shape|) memory
        u = _uniform(gen, shape, ref, 1e-7, 1.0 - 1e-7)
        lo = torch.full(tuple(shape), -1.0, dtype=ref.dtype,
                        device=ref.device)
        hi = torch.full(tuple(shape), float(n), dtype=ref.dtype,
                        device=ref.device)
        q = 1.0 - _t(p, ref)
        for _ in range(60):
            mid = torch.floor(0.5 * (lo + hi + 1.0))
            cdf = special.betainc(torch.clamp(n - mid, min=1e-6), mid + 1.0, q)
            below = cdf < u
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        return hi.to(torch.float32)


class Mixture(Distribution):
    """Finite mixture of same-support components: ``logpdf`` is the
    log-sum-exp marginal, ``sample`` draws a component index per element;
    as a prior, the first component's transform is the sampler's."""

    def __init__(self, components, weights=None, logits=None):
        if len(components) < 2:
            raise ValueError("need >= 2 mixture components")
        if (weights is None) == (logits is None):
            raise ValueError("pass exactly one of weights= or logits=")

        def sig(c):
            # type AND bound parameters: two LowerBound transforms with
            # different cutoffs are different supports
            t = c.transform
            params = tuple(sorted(
                (k, float(v)) for k, v in vars(t).items()
                if isinstance(v, (int, float))))
            return (type(t).__name__, params)

        s0 = sig(components[0])
        if any(sig(c) != s0 for c in components[1:]):
            raise ValueError(
                "mixture components must share support (their sampler "
                "transforms differ: "
                f"{[sig(c) for c in components]})"
            )
        self.components = list(components)
        self.weights, self.logits = weights, logits
        self.transform = components[0].transform

    def _log_weights(self, ref):
        raw = (_t(self.logits, ref) if self.logits is not None
               else torch.log(_t(self.weights, ref)))
        return torch.log_softmax(raw, dim=-1)

    def logpdf(self, x):
        x = _x(x)
        parts = torch.stack([c.logpdf(x) for c in self.components], dim=-1)
        return torch.logsumexp(parts + self._log_weights(x), dim=-1)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.weights, self.logits)
        idx = _categorical(gen, self._log_weights(ref), shape, ref)
        draws = torch.stack([c.sample(gen, shape) for c in self.components],
                            dim=0)
        return torch.gather(draws, 0, idx[None].to(draws.device))[0]


class Categorical(Distribution):
    """Categorical over {0, ..., K-1}; exactly one of probs/logits (last axis
    = categories). Discrete: for ``observe`` sites and predictives."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs= or logits=")
        self.probs, self.logits = probs, logits

    def _lp(self, ref):
        raw = (_t(self.logits, ref) if self.logits is not None
               else torch.log(_t(self.probs, ref)))
        return torch.log_softmax(raw, dim=-1)

    def logpdf(self, x):
        x = _x(x)
        lp = self._lp(x)
        lp = lp.expand(x.shape + lp.shape[-1:])
        idx = x.to(torch.int64)[..., None]
        return torch.gather(lp, -1, idx)[..., 0]

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.probs, self.logits)
        lp = self._lp(ref)
        if lp.ndim != 1:
            raise ValueError("sampling requires 1-D (K,) logits")
        return _categorical(gen, lp, shape, ref).to(torch.float32)


class NegativeBinomial(Distribution):
    """NegativeBinomial(r, p): failures before the r-th success
    (overdispersed counts, mean r(1-p)/p). Discrete: for ``observe`` sites;
    sampled as the Gamma-Poisson mixture."""

    def __init__(self, total_count, probs=None, logits=None):
        self.r = total_count
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs= or logits=")
        self.probs, self._logits = probs, logits

    def logpdf(self, x):
        x = _x(x)
        r = _p(self.r, x)
        lg = _logits_of(self.probs, self._logits, x)
        comb = (torch.lgamma(x + r) - _lgamma(r) - torch.lgamma(x + 1.0))
        return comb + r * _log_sigmoid(lg) + x * _log_sigmoid(-lg)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.r, self.probs, self._logits)
        p = _sigmoid(_logits_of(self.probs, self._logits, ref))
        lam = _gamma(gen, self.r, shape, ref) * ((1.0 - p) / p)
        return torch.poisson(lam, generator=gen).to(torch.float32)


class LKJCholesky(Distribution):
    """LKJ prior on correlation Cholesky factors; declare with ``shape=(K,
    K)``. log density (up to a constant) Σ_{i=1..K-1} (K − 1 − i + 2η − 2)
    log L[i,i]; sampled by the C-vine (partial correlations 2·Beta(b_j,
    b_j) − 1, b_j = η + (K − 2 − j)/2)."""

    def __init__(self, k, eta=1.0):
        self.k = int(k)
        self.eta = float(eta)
        self.transform = CorrCholesky(self.k)

    def logpdf(self, L):
        L = _x(L)
        i = np.arange(1, self.k)
        diag = torch.diagonal(L, 0, -2, -1)[..., 1:]
        expo = _const((self.k - 1 - i) + 2.0 * self.eta - 2.0, L)
        return torch.sum(expo * torch.log(diag), dim=-1)

    def sample(self, gen, shape=()):
        k = self.k
        if tuple(shape[-2:]) != (k, k):
            raise ValueError(f"output shape must end in ({k}, {k})")
        batch = tuple(shape[:-2])
        ref = _sref(gen)
        _, cols = np.tril_indices(k, -1)
        b = _const(self.eta + (k - 2 - cols) / 2.0, ref)
        beta = _beta(gen, b, b, batch + (cols.size,), ref)
        return self.transform._rows(2.0 * beta - 1.0)


class InverseGamma(Distribution):
    """InverseGamma(concentration a, scale b) on (0, inf): the conjugate
    variance prior, mean b/(a-1) for a > 1."""

    transform = Exp()

    def __init__(self, concentration, scale=1.0):
        self.concentration, self.scale = concentration, scale

    def logpdf(self, x):
        x = _x(x)
        a, b = _p(self.concentration, x), _p(self.scale, x)
        xs = torch.clamp(x, min=1e-38)
        lp = a * _log(b) - _lgamma(a) - (a + 1.0) * torch.log(xs) - b / xs
        return torch.where(x > 0, lp, -math.inf)

    def cdf(self, x):
        x = _x(x)
        return special.gammaincc(
            _t(self.concentration, x),
            _p(self.scale, x) / torch.clamp(x, min=1e-38))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.concentration, self.scale)
        return _p(self.scale, ref) / _gamma(gen, self.concentration, shape,
                                            ref)


class Weibull(Distribution):
    """Weibull(concentration k, scale λ) on (0, inf)."""

    transform = Exp()

    def __init__(self, concentration, scale=1.0):
        self.concentration, self.scale = concentration, scale

    def logpdf(self, x):
        x = _x(x)
        k, lam = _p(self.concentration, x), _p(self.scale, x)
        z = torch.clamp(x, min=1e-38) / lam
        lp = _log(k / lam) + (k - 1.0) * torch.log(z) - z ** k
        return torch.where(x > 0, lp, -math.inf)

    def cdf(self, x):
        x = _x(x)
        z = torch.clamp(x, min=0.0) / _p(self.scale, x)
        return -torch.expm1(-(z ** _p(self.concentration, x)))

    def log_sf(self, x):
        x = _x(x)
        z = torch.clamp(x, min=0.0) / _p(self.scale, x)
        return -(z ** _p(self.concentration, x))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.concentration, self.scale)
        e = _exponential(gen, shape, ref)
        return _p(self.scale, ref) * e ** (1.0 / _p(self.concentration, ref))


class Gumbel(Distribution):
    """Gumbel(loc, scale) max-extreme-value distribution on R."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        x = _x(x)
        scale = _p(self.scale, x)
        z = (x - _p(self.loc, x)) / scale
        return -z - torch.exp(-z) - _log(scale)

    def cdf(self, x):
        x = _x(x)
        return torch.exp(-torch.exp(-(x - _p(self.loc, x))
                                    / _p(self.scale, x)))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.loc, self.scale)
        g = -torch.log(_exponential(gen, shape, ref))
        return _p(self.loc, ref) + _p(self.scale, ref) * g


class Pareto(Distribution):
    """Pareto(scale x_m, concentration α) on (x_m, inf)."""

    def __init__(self, scale, concentration):
        self.scale = float(scale)
        self.concentration = concentration
        self.transform = LowerBound(self.scale)

    def logpdf(self, x):
        x = _x(x)
        a = _p(self.concentration, x)
        lp = (_log(a) + a * math.log(self.scale)
              - (a + 1.0) * torch.log(torch.clamp(x, min=1e-38)))
        # a mixture or observe site below x_m must see zero density
        return torch.where(x >= self.scale, lp, -math.inf)

    def cdf(self, x):
        x = _x(x)
        return -torch.expm1(
            _p(self.concentration, x)
            * (math.log(self.scale)
               - torch.log(torch.clamp(x, min=self.scale))))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.concentration)
        e = _exponential(gen, shape, ref)
        return self.scale * torch.exp(e / _p(self.concentration, ref))


class Geometric(Distribution):
    """Geometric(p): failures BEFORE the first success, support {0, 1, …}
    (mean (1-p)/p). Discrete: for ``observe`` sites."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs= or logits=")
        self.probs, self._logits = probs, logits

    def logpdf(self, x):
        x = _x(x)
        lg = _logits_of(self.probs, self._logits, x)
        return _log_sigmoid(lg) + x * _log_sigmoid(-lg)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.probs, self._logits)
        lg = _logits_of(self.probs, self._logits, ref)
        u = _uniform(gen, shape, ref)
        # failures before the first success: floor(log U / log(1 - p))
        return torch.floor(torch.log1p(-u) / _log_sigmoid(-lg)).to(
            torch.float32)


class BetaBinomial(Distribution):
    """BetaBinomial(n, a, b): Binomial with a Beta-mixed success
    probability. Discrete: for ``observe`` sites."""

    def __init__(self, n, a, b):
        self.n, self.a, self.b = n, a, b

    def logpdf(self, x):
        x = _x(x)
        n, a, b = _p(self.n, x), _p(self.a, x), _p(self.b, x)

        def betaln(p, q):
            return _lgamma(p) + _lgamma(q) - _lgamma(p + q)

        comb = (_lgamma(n + 1.0) - torch.lgamma(x + 1.0)
                - torch.lgamma(n - x + 1.0))
        return comb + betaln(x + a, n - x + b) - betaln(a, b)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.n, self.a, self.b)
        p = _beta(gen, self.a, self.b, shape, ref)
        n = _t(self.n, ref) + torch.zeros_like(p)  # batched as p is
        return torch.binomial(n, p.contiguous(), generator=gen).to(
            torch.float32)


class Multinomial(Distribution):
    """Multinomial(n, probs/logits) over K categories; observations are (…,
    K) count vectors summing to n. Discrete: for ``observe`` sites (declare
    with ``shape=(K,)``)."""

    def __init__(self, n, probs=None, logits=None):
        self.n = n
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs= or logits=")
        self.probs, self.logits = probs, logits

    def _log_p(self, ref):
        if self.logits is not None:
            return torch.log_softmax(_t(self.logits, ref), dim=-1)
        return torch.log(_t(self.probs, ref))

    def logpdf(self, x):
        x = _x(x)
        n = _p(self.n, x)
        return (_lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), -1)
                + torch.sum(x * self._log_p(x), -1))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.probs, self.logits)
        log_p = self._log_p(ref)
        k = log_p.shape[-1]
        shape = tuple(shape)
        if shape and shape[-1:] == (k,):
            shape = shape[:-1]  # batch shape; the category axis is implicit
        n = int(self.n)
        idx = _categorical(gen, log_p, shape + (n,), ref)
        return F.one_hot(idx, k).sum(dim=-2).to(torch.float32)


class Logistic(Distribution):
    """Logistic(loc, scale) on R."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def logpdf(self, x):
        x = _x(x)
        scale = _p(self.scale, x)
        z = (x - _p(self.loc, x)) / scale
        return -z - 2.0 * F.softplus(-z) - _log(scale)

    def cdf(self, x):
        x = _x(x)
        return torch.sigmoid((x - _p(self.loc, x)) / _p(self.scale, x))

    def log_cdf(self, x):
        x = _x(x)
        return F.logsigmoid((x - _p(self.loc, x)) / _p(self.scale, x))

    def log_sf(self, x):
        x = _x(x)
        return F.logsigmoid(-(x - _p(self.loc, x)) / _p(self.scale, x))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.loc, self.scale)
        u = _uniform(gen, shape, ref)
        return (_p(self.loc, ref)
                + _p(self.scale, ref) * (torch.log(u) - torch.log1p(-u)))


class SkewNormal(Distribution):
    """SkewNormal(loc, scale, alpha): Azzalini's skew-normal, pdf
    2·φ(z)·Φ(αz)/scale; alpha = 0 recovers Normal."""

    def __init__(self, loc=0.0, scale=1.0, alpha=0.0):
        self.loc, self.scale, self.alpha = loc, scale, alpha

    def logpdf(self, x):
        x = _x(x)
        scale = _p(self.scale, x)
        z = (x - _p(self.loc, x)) / scale
        return (math.log(2.0) + _norm_logpdf(z, 0.0, 1.0)
                + special.log_ndtr(_p(self.alpha, x) * z) - _log(scale))

    def sample(self, gen, shape=()):
        # Azzalini (1985): X = δ|U0| + sqrt(1-δ²) U1, δ = α/sqrt(1+α²)
        ref = _sref(gen, self.loc, self.scale, self.alpha)
        a = _p(self.alpha, ref)
        delta = a / _sqrt(1.0 + a * a)
        u0 = torch.abs(_normal(gen, shape, ref))
        u1 = _normal(gen, shape, ref)
        z = delta * u0 + _sqrt(1.0 - delta * delta) * u1
        return _p(self.loc, ref) + _p(self.scale, ref) * z


class HalfStudentT(Distribution):
    """Half-Student-t on (0, inf): the robust weakly-informative scale
    prior between HalfNormal (df→inf) and HalfCauchy (df=1)."""

    transform = Exp()

    def __init__(self, df, scale=1.0):
        self.df, self.scale = df, scale

    def logpdf(self, x):
        x = _x(x)
        return math.log(2.0) + _t_logpdf(x, _p(self.df, x), 0.0,
                                         _p(self.scale, x))

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.df, self.scale)
        return torch.abs(_p(self.scale, ref)
                         * _student_t(gen, self.df, shape, ref))


class Censored(Distribution):
    """Censored observations for ``observe`` sites: ``right``/``left`` (at
    least one) are boolean masks broadcastable to the data; True entries are
    censored at their data value. The density is the base logpdf where
    uncensored, log S(x) where right-censored and log F(x) where
    left-censored (the base's exact ``log_sf``/``log_cdf`` where it has
    them, else ``log1p(-cdf)``/``log(cdf)`` clipped). ``sample`` draws from
    the uncensored base."""

    def __init__(self, base, right=None, left=None):
        if right is None and left is None:
            raise ValueError("pass right= and/or left= censoring masks")
        name = type(base).__name__
        if right is not None and not (
            hasattr(base, "log_sf") or hasattr(base, "cdf")
        ):
            raise ValueError(
                f"{name} has no log_sf/cdf — cannot right-censor"
            )
        if left is not None and not (
            hasattr(base, "log_cdf") or hasattr(base, "cdf")
        ):
            raise ValueError(
                f"{name} has no log_cdf/cdf — cannot left-censor"
            )
        self.base = base
        self.right = None if right is None else _bool_array(right)
        self.left = None if left is None else _bool_array(left)
        self.transform = base.transform

    def _log_sf(self, x):
        if hasattr(self.base, "log_sf"):
            return self.base.log_sf(x)
        return torch.log1p(-torch.clamp(self.base.cdf(x), 0.0, 1.0 - 1e-7))

    def _log_cdf(self, x):
        if hasattr(self.base, "log_cdf"):
            return self.base.log_cdf(x)
        return torch.log(torch.clamp(self.base.cdf(x), 1e-38, 1.0))

    def logpdf(self, x):
        x = _x(x)
        lp = self.base.logpdf(x)
        if self.right is not None:
            lp = torch.where(_mask(self.right, x), self._log_sf(x), lp)
        if self.left is not None:
            lp = torch.where(_mask(self.left, x), self._log_cdf(x), lp)
        return lp

    def sample(self, gen, shape=()):
        return self.base.sample(gen, shape)


class ZeroInflatedPoisson(Distribution):
    """ZIP(gate π, rate λ): a point mass at zero mixed with a Poisson.
    Discrete: for ``observe`` sites."""

    def __init__(self, gate, rate):
        self.gate, self.rate = gate, rate

    def logpdf(self, x):
        x = _x(x)
        lam, gate = _t(self.rate, x), _p(self.gate, x)
        log_gate = _log(gate)
        log_ngate = _log1p(-gate)
        pois = x * torch.log(lam) - lam - torch.lgamma(x + 1.0)
        at_zero = torch.logaddexp(_t(log_gate, x), log_ngate - lam)
        return torch.where(x == 0, at_zero, log_ngate + pois)

    def sample(self, gen, shape=()):
        ref = _sref(gen, self.gate, self.rate)
        zero = _uniform(gen, shape, ref) < _p(self.gate, ref)
        rate = _t(self.rate, ref).expand(tuple(shape)).contiguous()
        counts = torch.poisson(rate, generator=gen)
        return torch.where(zero, torch.zeros_like(counts), counts).to(
            torch.float32)


class VonMises(Distribution):
    """VonMises(loc, concentration) on the circle (-π, π]. Sampled by Best &
    Fisher (1979) wrapped-Cauchy rejection; declared parameters use the
    cut-free unit-vector embedding (:class:`Circular`)."""

    transform = Circular()

    def __init__(self, loc=0.0, concentration=1.0):
        self.loc, self.concentration = loc, concentration

    def logpdf(self, x):
        x = _x(x)
        k = _t(self.concentration, x)
        # log I0(k) = log i0e(k) + k (stable for large k)
        log_i0 = torch.log(torch.special.i0e(k)) + k
        return (k * torch.cos(x - _p(self.loc, x)) - _LOG_2PI - log_i0)

    def sample(self, gen, shape=()):
        # Best & Fisher 1979 (Fisher 1993 §3.3.6) for every element at once:
        # JAX's per-draw while_loop becomes a masked loop over rounds, with a
        # host test for unfinished draws every CHECK_EVERY rounds (VMAP_ROUNDS
        # rounds under vmap)
        shape = tuple(shape)
        ref = _sref(gen, self.loc, self.concentration)
        k = _t(self.concentration, ref).expand(shape)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * k * k)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * k)
        r = (1.0 + rho * rho) / (2.0 * rho)
        done = torch.zeros(shape, dtype=torch.bool, device=ref.device)
        theta = torch.zeros(shape, dtype=ref.dtype, device=ref.device)
        vmapped = torch._C._functorch.maybe_current_level() is not None
        rounds = 0
        while True:
            u1 = _uniform(gen, shape, ref)
            u2 = _uniform(gen, shape, ref)
            u3 = _uniform(gen, shape, ref)
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            csd = k * (r - f)
            ok = ((csd * (2.0 - csd) - u2 > 0.0)
                  | (torch.log(csd / torch.clamp(u2, min=1e-37)) + 1.0 - csd
                     >= 0.0))
            th = torch.sign(u3 - 0.5) * torch.acos(torch.clamp(f, -1.0, 1.0))
            take = ok & ~done
            theta = torch.where(take, th, theta)
            done = done | ok
            rounds += 1
            if vmapped:
                if rounds == VMAP_ROUNDS:
                    break
            elif rounds % CHECK_EVERY == 0 and bool(done.all()):
                break
        loc = _p(self.loc, ref)
        return torch.remainder(theta + loc + math.pi, 2.0 * math.pi) - math.pi


# -- model -------------------------------------------------------------------


class _HierPrior:
    """A hierarchical prior site: ``fn(values) -> Distribution`` (values =
    constrained params declared EARLIER), with its transform declared
    explicitly (the distribution exists only when the logp runs)."""

    def __init__(self, fn, transform):
        self.fn = fn
        self.transform = transform

    def __call__(self, values):
        return self.fn(values)


def _to_u(dist, x, gen):
    """Constrained draws -> unconstrained (the exact ``inverse_sample`` hook
    where the transform has one)."""
    t = dist.transform
    inv_s = getattr(t, "inverse_sample", None)
    return inv_s(gen, x) if inv_s is not None else t.inverse(x)


def _ancestral_prior_sample(params, gen, n, dtype=torch.float32):
    """(n, D) unconstrained prior draws by ancestral sampling in declaration
    order on the generator's device. A plain site draws all n at once; a
    hierarchical site's distribution exists per draw of the earlier params'
    constrained values, so it is vmapped over the n draws, as JAX's is."""
    vals = {}
    cols = []
    for name, dist, shape, u_shape, u_size in params:
        if isinstance(dist, _HierPrior):
            def one_draw(earlier, _i, dist=dist, shape=shape, u_size=u_size):
                x = _x(dist(earlier).sample(gen, tuple(shape))).to(dtype)
                return x, _to_u(dist, x, gen).reshape(u_size)

            # the index keeps one input batched when no param comes earlier
            x, u = torch.func.vmap(one_draw, randomness="different")(
                vals, torch.arange(n, device=gen.device))
        else:
            x = _x(dist.sample(gen, (n,) + tuple(shape))).to(dtype)
            u = _to_u(dist, x, gen).reshape(n, u_size)
        vals[name] = x
        cols.append(u.to(dtype))
    return torch.cat(cols, dim=1)


def _unpacker(params, deterministics, with_logdet):
    """flat unconstrained (D,) -> ({name: constrained}, log|J|); the dict
    includes deterministics in declaration order."""

    def unpack(theta):
        out = {}
        logdet = 0.0
        i = 0
        for name, dist, shape, u_shape, u_size in params:
            u = (theta[i:i + u_size].reshape(u_shape) if u_shape
                 else theta[i])
            t = dist.transform
            out[name] = t.forward(u)
            if with_logdet:
                logdet = logdet + torch.sum(t.log_det(u))
                norm = getattr(t, "log_norm", None)
                if norm is not None:  # e.g. Ordered's log K!
                    logdet = logdet + torch.sum(norm(u))
            i += u_size
        for name, fn in deterministics:
            out[name] = fn(out)
        return out, logdet

    return unpack


def _site_logpdf(d, data, mask, fill, ref, masked_value=0.0):
    """log-density of an observe site at its data, on ref's device and
    dtype; masked entries give ``masked_value`` (double ``where``: their
    data, NaN or not, never reaches the density or its gradient)."""
    y = _const(data, ref)
    if mask is None:
        return d.logpdf(y)
    m = _mask(mask, ref)
    safe = torch.where(m, y, fill)
    return torch.where(m, d.logpdf(safe), masked_value)


def _flat_draws(flat_draws):
    """(N, D) draws as a tensor (numpy keeps its dtype, on the CPU)."""
    arr = flat_draws if isinstance(flat_draws, torch.Tensor) else (
        torch.as_tensor(np.asarray(flat_draws)))
    return torch.atleast_2d(arr)


def _numpy(out):
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class Model:
    """Named parameters with priors + a likelihood over them.

    ``param(name, dist, shape=())`` declares a parameter block;
    ``plate(name, size)`` names a broadcast axis (``param("theta", Normal(0,
    1), plate="schools")``); ``deterministic(name, fn)`` records a derived
    quantity, visible to the likelihood and returned by ``constrain``;
    ``observe(name, dist_fn, data)`` declares observed data (its density
    joins the posterior and drives the predictives); ``likelihood(fn)``
    adds a black-box ``fn(params) -> scalar`` term. ``build()`` compiles to
    ``(logp, dim, constrain)``.
    """

    def __init__(self):
        self._params = []  # (name, dist, shape, u_shape, u_size)
        self._deterministics = []  # (name, fn)
        self._observes = []  # (name, dist_fn, data, mask, fill)
        self._plates = {}  # name -> size
        self._loglike = None

    def _check_name(self, name):
        taken = (
            {n for n, *_ in self._params}
            | {n for n, _ in self._deterministics}
            | {n for n, *_ in self._observes}
        )
        if name in taken:
            raise ValueError(f"duplicate name {name!r}")

    def plate(self, name, size):
        """Register a named broadcast axis usable as ``param(..., plate=)``."""
        if name in self._plates and self._plates[name] != int(size):
            raise ValueError(
                f"plate {name!r} redeclared with size {size} "
                f"(was {self._plates[name]})"
            )
        self._plates[name] = int(size)
        return self

    def _resolve_shape(self, shape, plate):
        if plate is not None:
            if shape != ():
                raise ValueError("pass either shape= or plate=, not both")
            names = (plate,) if isinstance(plate, str) else tuple(plate)
            try:
                return tuple(self._plates[n] for n in names)
            except KeyError as e:
                raise ValueError(
                    f"unknown plate {e.args[0]!r}; declare with "
                    f".plate(name, size) first"
                ) from None
        if not isinstance(shape, (tuple, list)):
            shape = (shape,)
        return tuple(int(s) for s in shape)

    def param(self, name, dist, shape=(), plate=None, transform=None):
        """Declare a sampled site. ``dist`` is a Distribution or, for a
        HIERARCHICAL prior, a callable ``values -> Distribution`` over the
        constrained values of params declared earlier; such a site passes
        ``transform=`` to declare its support::

            .param("alpha", Gamma(2.0, 1.0))
            .param("w", lambda p: GEM(p["alpha"], K), shape=(K,),
                   transform=StickBreaking(K))
        """
        self._check_name(name)
        shape = self._resolve_shape(shape, plate)
        if callable(dist) and not isinstance(dist, Distribution):
            if transform is None:
                raise ValueError(
                    f"param {name!r}: a callable (hierarchical) prior "
                    "needs an explicit transform= declaring its support"
                )
            dist = _HierPrior(dist, transform)
        elif transform is not None:
            raise ValueError(
                f"param {name!r}: transform= is only for callable "
                "(hierarchical) priors; Distributions carry their own"
            )
        # the transform may change dimensionality (stick-breaking maps K-1
        # unconstrained dims onto the K-simplex): the flat vector holds the
        # UNCONSTRAINED size
        t = dist.transform
        u_shape = getattr(t, "unconstrained_shape", lambda sh: sh)(shape)
        u_size = int(np.prod(u_shape)) if u_shape else 1
        self._params.append((name, dist, shape, tuple(u_shape), u_size))
        return self

    def deterministic(self, name, fn):
        """Derived quantity ``fn(params) -> value``; sees every earlier param
        and deterministic, feeds later ones, the likelihood and the
        observes; returned by ``constrain``."""
        self._check_name(name)
        self._deterministics.append((name, fn))
        return self

    def observe(self, name, dist_fn, data, mask=None, fill=0.0):
        """Observed data: ``dist_fn(params) -> Distribution`` at ``data``
        joins the log-posterior; the predictives draw from it.

        ``mask`` (broadcastable to ``data``): True entries are observed,
        False entries are left out of the density (their data may be NaN);
        ``fill`` is the in-support placeholder put at masked entries before
        the density runs (the double ``where`` keeps gradients finite).
        """
        self._check_name(name)
        if not isinstance(data, torch.Tensor):
            data = np.array(data)
        if mask is not None:
            mask = (mask.bool().expand(data.shape)
                    if isinstance(mask, torch.Tensor)
                    else np.broadcast_to(np.asarray(mask, bool),
                                         data.shape).copy())
        self._observes.append((name, dist_fn, data, mask, float(fill)))
        return self

    def likelihood(self, fn):
        self._loglike = fn
        return self

    @property
    def dim(self):
        return sum(u_size for *_, u_size in self._params)

    def _snapshot(self):
        if not self._params:
            raise ValueError("model has no parameters")
        return (tuple(self._params), tuple(self._deterministics),
                tuple(self._observes), self._loglike)

    def build(self):
        """Returns ``(logp, dim, constrain)``.

        ``logp(theta)`` maps a (dim,) tensor to a scalar (vmap it for a
        batch); ``constrain(draws)`` maps (N, dim) unconstrained draws,
        numpy or a tensor, to ``{name: (N, *shape)}`` numpy arrays,
        deterministics included. The closures snapshot the model: adding
        params afterwards does not change them.
        """
        params, deterministics, observes, loglike = self._snapshot()
        dim = sum(u_size for *_, u_size in params)
        unpack = _unpacker(params, deterministics, True)

        def logp(theta):
            values, logdet = unpack(theta)
            lp = logdet
            for name, dist, *_ in params:
                d = dist(values) if isinstance(dist, _HierPrior) else dist
                lp = lp + torch.sum(d.logpdf(values[name]))
            for name, dist_fn, data, mask, fill in observes:
                lp = lp + torch.sum(_site_logpdf(dist_fn(values), data, mask,
                                                 fill, theta))
            if loglike is not None:
                lp = lp + loglike(values)
            return lp

        return logp, dim, _constrainer(params, deterministics)

    def build_split(self):
        """Prior/likelihood decomposition for the evidence engines.

        Returns ``(logprior, loglike, dim, constrain, prior_sample)`` in the
        coordinates of :meth:`build` (``logprior + loglike`` is its logp):
        ``logprior`` is the priors plus the transforms' Jacobians (a proper
        density on R^dim when every prior is proper), ``loglike`` the
        observe sites plus the ``likelihood`` term, and ``prior_sample(gen,
        n) -> (n, dim)`` exact prior draws mapped through the transforms'
        inverses, on the generator's device.
        """
        params, deterministics, observes, loglike_fn = self._snapshot()
        dim = self.dim
        unpack = _unpacker(params, deterministics, True)

        def logprior(theta):
            values, logdet = unpack(theta)
            lp = logdet
            for name, dist, *_ in params:
                d = dist(values) if isinstance(dist, _HierPrior) else dist
                lp = lp + torch.sum(d.logpdf(values[name]))
            return lp

        def loglike(theta):
            values, _ = unpack(theta)
            ll = 0.0
            for name, dist_fn, data, mask, fill in observes:
                ll = ll + torch.sum(_site_logpdf(dist_fn(values), data, mask,
                                                 fill, theta))
            if loglike_fn is not None:
                ll = ll + loglike_fn(values)
            if not isinstance(ll, torch.Tensor):  # prior-only: a tensor zero
                ll = torch.zeros((), dtype=theta.dtype, device=theta.device)
            return ll

        def prior_sample(gen, n, dtype=torch.float32):
            return _ancestral_prior_sample(params, gen, int(n), dtype)

        return (logprior, loglike, dim, _constrainer(params, deterministics),
                prior_sample)

    def prior_predictive(self, gen, n_draws, names=None):
        """Prior-predictive datasets: exact prior draws pushed through every
        ``observe`` site. Returns ``({site: (n_draws, *data.shape)}, u)``
        with ``u`` the (n_draws, dim) unconstrained prior draws (numpy)."""
        _, _, _, _, prior_sample = self.build_split()
        u = prior_sample(gen, int(n_draws))
        return self.posterior_predictive(gen, u, names=names), (
            u.cpu().numpy())

    def _sites(self, names):
        if not self._observes:
            raise ValueError("model has no observe() sites")
        sel = list(names) if names is not None else [
            n for n, *_ in self._observes
        ]
        known = {n for n, *_ in self._observes}
        for n in sel:
            if n not in known:
                raise ValueError(f"unknown observe site {n!r}")
        return [s for s in self._observes if s[0] in sel]

    def posterior_predictive(self, gen, flat_draws, names=None):
        """Replicated datasets from every ``observe`` site: ``flat_draws``
        (N, dim) unconstrained draws; returns ``{name: (N, *data.shape)}``
        numpy arrays, one dataset a draw, all drawn at once from ``gen`` on
        its device (vmapped over the draws, as JAX's). ``names`` restricts
        to a subset."""
        sites = self._sites(names)
        unpack = _unpacker(tuple(self._params), tuple(self._deterministics),
                           False)

        def one_draw(theta):
            vals, _ = unpack(theta)
            return {name: _x(dist_fn(vals).sample(gen, tuple(data.shape)))
                    for name, dist_fn, data, _mask, _fill in sites}

        arr = _flat_draws(flat_draws).to(gen.device)
        return _numpy(torch.func.vmap(one_draw, randomness="different")(arr))

    def pointwise_log_likelihood(self, flat_draws, names=None):
        """Per-observation log-likelihood matrices for WAIC / LOO:
        ``{site: (N, *data.shape)}`` numpy arrays from (N, dim)
        unconstrained draws; masked-out entries come back NaN (dropped by
        ``analysis.model_compare``)."""
        sites = self._sites(names)
        unpack = _unpacker(tuple(self._params), tuple(self._deterministics),
                           False)

        def one_draw(theta):
            values, _ = unpack(theta)
            return {name: _site_logpdf(dist_fn(values), data, mask, fill,
                                       theta, masked_value=math.nan)
                    for name, dist_fn, data, mask, fill in sites}

        return _numpy(torch.func.vmap(one_draw)(_flat_draws(flat_draws)))

    def prior_sample(self, gen, n, dtype=torch.float32):
        """(n, dim) UNCONSTRAINED prior draws on the generator's device (the
        ``inverse_sample`` hooks make transforms with auxiliary coordinates
        or restricted supports exact)."""
        return _ancestral_prior_sample(tuple(self._params), gen, int(n),
                                       dtype)


def _constrainer(params, deterministics):
    unpack = _unpacker(params, deterministics, False)

    def constrain(flat_draws):
        """(N, D) unconstrained draws -> {name: (N, *shape)} numpy arrays."""
        arr = _flat_draws(flat_draws)
        return _numpy(torch.func.vmap(lambda t: unpack(t)[0])(arr))

    return constrain
