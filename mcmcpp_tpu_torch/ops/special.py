"""Special functions the DSL needs that torch lacks or cannot differentiate.

- :func:`betainc`, the regularized incomplete beta I_x(a, b). ``torch.special``
  has none. It is the modified Lentz continued fraction of JAX's
  ``lax.betainc`` (DLMF 8.17.E23, the symmetry swap of 8.17.E4 where the
  fraction converges slowly) run up to a cap on the terms, each element
  frozen once its term ratio is within eps/2 of 1, the loop ending once all
  are frozen (a host test every 16 terms): batched and safe under
  ``torch.func.vmap``. Its gradient in x is the beta density; a gradient
  in a or b raises, as ``jax.grad`` does ("Betainc gradient with respect to a
  and b not supported").
- :func:`gammainc` and :func:`gammaincc`, the regularized incomplete gammas,
  with a gradient in a. ``torch.special.gammainc`` computes the value but its
  backward raises for a ("the derivative for 'igamma: input' is not
  implemented"). The a-derivative here is JAX's (``igamma_grad_a``): the
  power series for x ≤ max(1, a), the Legendre continued fraction beyond,
  each with its derivative carried along, up to a cap on the terms with
  converged elements frozen, ended as the incomplete beta's is. In float64
  the value is JAX's series and fraction too (torch's is off by up to 2e-9
  relative at a ≳ 20); in float32 it is torch's one kernel.
- :func:`log_ndtr`, log Φ(x). ``torch.special.log_ndtr`` has no vmap batching
  rule (vmap falls back to a Python loop over the batch), so this is
  log Φ from ``ndtr`` in the body and the asymptotic series in the far left
  tail, with a double ``where`` so neither branch poisons the gradient.

The autograd Functions save their inputs in ``setup_context`` and have a vmap
rule, so a per-θ logp that calls them can be vmapped and differentiated (the
samplers vmap a per-θ logp and take its gradient by autograd). The incomplete
beta's and gammas' rule applies the Function once to the whole batch, whose
loops then stop when every element has converged, as they do outside vmap;
``log_ndtr`` has no loop and lets torch generate its rule.
"""

import math

import torch

# caps on the terms: JAX's betainc runs at most 200 (float32) or 600
# (float64) partial fractions; the incomplete gamma's series and continued
# fraction are cut where JAX's while loops stop for shape parameters up to
# ~1e3 (each converged element is frozen, so extra terms change nothing)
BETAINC_TERMS = {torch.float32: 200, torch.float64: 600}
IGAMMA_SERIES_TERMS = {torch.float32: 400, torch.float64: 800}
IGAMMA_CF_TERMS = {torch.float32: 200, torch.float64: 400}


def _float(*xs):
    """Broadcast to one floating dtype (float32 unless a tensor is float64)
    on the first tensor's device."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    device = ts[0].device if ts else None
    dtype = torch.float64 if any(t.dtype == torch.float64 for t in ts) else (
        torch.float32)
    out = [torch.as_tensor(x, dtype=dtype, device=device) for x in xs]
    return torch.broadcast_tensors(*out)


def _eps(dtype):
    return torch.finfo(dtype).eps


def _all_done(live, term):
    """Whether a fixed-term loop may stop: every element frozen, asked of the
    device every 16 terms (one host sync each). Under a torch.func transform
    no value may steer Python and the loop runs its fixed count; the vmap
    rule below keeps vmap out of the loops. A frozen element never changes
    again, so stopping gives the same bits as running on."""
    return (term % 16 == 0
            and torch._C._functorch.maybe_current_level() is None
            and not bool(live.any()))


def _whole_batch(fn, info, in_dims, *args):
    """The vmap rule of the elementwise Functions here: move each batched
    input's batch axis to the front, expand the unbatched ones to the batch
    (the public wrappers broadcast every input to one shape first) and apply
    ``fn`` once to the physical tensors, so that its loops see plain tensors
    and stop as soon as the whole batch has converged."""
    moved = [a if not isinstance(a, torch.Tensor)
             else a.movedim(d, 0) if d is not None
             else a.expand(info.batch_size, *a.shape)
             for a, d in zip(args, in_dims)]
    return fn(*moved), 0


# -- the incomplete beta ------------------------------------------------------


def _betainc_value(a, b, x):
    """I_x(a, b) by JAX's algorithm (``regularized_incomplete_beta_impl``)."""
    dtype = x.dtype
    n_terms = BETAINC_TERMS.get(dtype, 600)
    small = _eps(dtype) / 2.0
    one = torch.ones_like(x)
    a_is_zero = (a == 0) | (b == math.inf)
    b_is_zero = (b == 0) | (a == math.inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                     | (a_is_zero & b_is_zero) | is_nan)

    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    # Lentz–Thompson–Barnett: partial denominators 0, 1, 1, ...; the first
    # partial numerator is 1
    h = torch.full_like(x, small)
    c = h
    d = torch.zeros_like(x)
    live = torch.ones_like(x, dtype=torch.bool)
    for it in range(1, n_terms):
        if it == 1:
            num = one
        else:
            m = float((it - 1) // 2)
            if it % 2 == 0:
                num = (-(a + b) * x / (a + 1.0) if m == 0 else
                       -(a + m) * (a + b + m) * x
                       / ((a + 2.0 * m) * (a + 2.0 * m + 1.0)))
            else:
                num = m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))
        c_new = 1.0 + num / c
        c_new = torch.where(c_new.abs() < small, small, c_new)
        d_new = 1.0 + num * d
        d_new = torch.where(d_new.abs() < small, small, d_new)
        d_new = 1.0 / d_new
        delta = c_new * d_new
        h = torch.where(live, h * delta, h)
        c = torch.where(live, c_new, c)
        d = torch.where(live, d_new, d)
        live = live & ((delta - 1.0).abs() >= small)
        if _all_done(live, it):
            break

    very_small = torch.finfo(dtype).tiny * 2.0
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a)
    out = h * factor
    out = torch.where(fast, out, 1.0 - out)
    out = torch.where(result_is_zero, torch.zeros_like(out), out)
    out = torch.where(result_is_one, torch.ones_like(out), out)
    return torch.where(result_is_nan, torch.full_like(out, math.nan), out)


class _Betainc(torch.autograd.Function):
    @staticmethod
    def forward(a, b, x):
        return _betainc_value(a, b, x)

    @staticmethod
    def vmap(info, in_dims, a, b, x):
        return _whole_batch(_Betainc.apply, info, in_dims, a, b, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise TypeError(
                "Betainc gradient with respect to a and b not supported "
                "(as in JAX); only x may carry a gradient")
        a, b, x = ctx.saved_tensors
        log_density = (torch.xlogy(a - 1.0, x) + torch.xlogy(b - 1.0, 1.0 - x)
                       - (torch.lgamma(a) + torch.lgamma(b)
                          - torch.lgamma(a + b)))
        return None, None, grad * torch.exp(log_density)


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b), elementwise with broadcasting
    (≙ ``jax.scipy.special.betainc``); differentiable in x only."""
    a, b, x = _float(a, b, x)
    return _Betainc.apply(a, b, x)


# -- the incomplete gamma -----------------------------------------------------


def _igamma_series(ax, x, a, enabled, derivative):
    """P(a, x), or d/da P(a, x), by the power series (JAX's
    ``_igamma_series`` in VALUE or DERIVATIVE mode)."""
    eps = _eps(x.dtype)
    r = a
    c = torch.ones_like(a)
    ans = torch.ones_like(a)
    dc_da = torch.zeros_like(a)
    dans_da = torch.zeros_like(a)
    for term in range(IGAMMA_SERIES_TERMS.get(x.dtype, 800)):
        r_n = r + 1.0
        dc_n = dc_da * (x / r_n) - (c * x) / (r_n * r_n)
        dans_n = dans_da + dc_n
        c_n = c * (x / r_n)
        ans_n = ans + c_n
        r = torch.where(enabled, r_n, r)
        c = torch.where(enabled, c_n, c)
        ans = torch.where(enabled, ans_n, ans)
        dc_da = torch.where(enabled, dc_n, dc_da)
        dans_da = torch.where(enabled, dans_n, dans_da)
        going = (dc_n / dans_n).abs() if derivative else c_n / ans_n
        enabled = enabled & (going > eps)
        if _all_done(enabled, term + 1):
            break
    if not derivative:
        return ans * ax / a
    dlogax_da = torch.log(x) - torch.digamma(a + 1.0)
    return ax * (ans * dlogax_da + dans_da) / a


def _igammac_cf(ax, x, a, enabled, derivative):
    """Q(a, x), or d/da Q(a, x), by the continued fraction (JAX's
    ``_igammac_continued_fraction`` in VALUE or DERIVATIVE mode)."""
    eps = _eps(x.dtype)
    y = 1.0 - a
    z = x + y + 1.0
    c = torch.zeros_like(x)
    pkm2 = torch.ones_like(x)
    qkm2 = x
    pkm1 = x + 1.0
    qkm1 = z * x
    ans = pkm1 / qkm1
    dpkm2 = torch.zeros_like(x)
    dqkm2 = torch.zeros_like(x)
    dpkm1 = torch.zeros_like(x)
    dqkm1 = -x
    dans = (dpkm1 - ans * dqkm1) / qkm1
    for term in range(IGAMMA_CF_TERMS.get(x.dtype, 400)):
        c = c + 1.0
        y_n = y + 1.0
        z_n = z + 2.0
        yc = y_n * c
        pk = pkm1 * z_n - pkm2 * yc
        qk = qkm1 * z_n - qkm2 * yc
        nonzero = qk != 0
        qk_safe = torch.where(nonzero, qk, torch.ones_like(qk))
        r = pk / qk_safe
        t = torch.where(nonzero, ((ans - r) / r).abs(), torch.ones_like(r))
        ans_n = torch.where(nonzero, r, ans)
        dpk = dpkm1 * z_n - pkm1 - dpkm2 * yc + pkm2 * c
        dqk = dqkm1 * z_n - qkm1 - dqkm2 * yc + qkm2 * c
        dans_n = torch.where(nonzero, (dpk - ans_n * dqk) / qk_safe, dans)
        grad_change = torch.where(nonzero, (dans_n - dans).abs(),
                                  torch.ones_like(dans))
        rescale = pk.abs() > 1.0 / eps
        scale = torch.where(rescale, eps, 1.0)
        new = (y_n, z_n, pkm1 * scale, qkm1 * scale, pk * scale, qk * scale,
               dpkm1 * scale, dqkm1 * scale, dpk * scale, dqk * scale,
               ans_n, dans_n)
        old = (y, z, pkm2, qkm2, pkm1, qkm1, dpkm2, dqkm2, dpkm1, dqkm1,
               ans, dans)
        (y, z, pkm2, qkm2, pkm1, qkm1, dpkm2, dqkm2, dpkm1, dqkm1, ans,
         dans) = (torch.where(enabled, n, o) for n, o in zip(new, old))
        enabled = enabled & ((grad_change if derivative else t) > eps)
        if _all_done(enabled, term + 1):
            break
    if not derivative:
        return ans * ax
    dlogax_da = torch.log(x) - torch.digamma(a)
    return ax * (ans * dlogax_da + dans)


def _log_ax(a, x, bad):
    """exp(a·log x − x − lgamma a) and its underflow mask, with the
    elements in ``bad`` replaced by 1 so that no branch sees a NaN."""
    xs = torch.where(bad, torch.ones_like(x), x)
    as_ = torch.where(bad, torch.ones_like(a), a)
    log_ax = as_ * torch.log(xs) - xs - torch.lgamma(as_)
    underflow = log_ax < -math.log(torch.finfo(x.dtype).max)
    return torch.exp(log_ax), underflow, xs, as_


def _igamma_value(a, x, upper):
    """P(a, x) (or Q) by JAX's ``igamma_impl`` (``igammac_impl``)."""
    is_nan = torch.isnan(a) | torch.isnan(x)
    a_is_zero = a == 0
    x_is_zero = x == 0
    x_is_inf = x == math.inf
    domain_error = (x < 0) | (a < 0) | (a_is_zero & x_is_zero) | is_nan
    ax, underflow, xs, as_ = _log_ax(
        a, x, domain_error | x_is_zero | x_is_inf | a_is_zero)
    if upper:
        use_series = (x < 1) | (x < a)
        enabled = ~(domain_error | underflow | x_is_inf | a_is_zero)
        out = torch.where(
            use_series,
            1.0 - _igamma_series(ax, xs, as_, enabled & use_series, False),
            _igammac_cf(ax, xs, as_, enabled & ~use_series, False))
        out = torch.where(x_is_inf | a_is_zero, torch.zeros_like(out), out)
    else:
        use_cf = (x >= 1) & (x > a)
        enabled = ~(x_is_zero | domain_error | underflow | x_is_inf)
        out = torch.where(
            use_cf, 1.0 - _igammac_cf(ax, xs, as_, enabled & use_cf, False),
            _igamma_series(ax, xs, as_, enabled & ~use_cf, False))
        out = torch.where(x_is_zero, torch.zeros_like(out), out)
        out = torch.where(x_is_inf, torch.ones_like(out), out)
    return torch.where(domain_error, torch.full_like(out, math.nan), out)


def _igamma_grad_a(a, x):
    """∂P(a, x)/∂a (≙ JAX's ``igamma_grad_a_impl``)."""
    is_nan = torch.isnan(a) | torch.isnan(x)
    x_is_zero = x == 0
    domain_error = (x < 0) | (a <= 0)
    use_cf = (x > 1) & (x > a)
    ax, underflow, xs, as_ = _log_ax(a, x, x_is_zero | domain_error)
    enabled = ~(x_is_zero | domain_error | underflow | is_nan)
    out = torch.where(
        use_cf,
        -_igammac_cf(ax, xs, as_, enabled & use_cf, True),
        _igamma_series(ax, xs, as_, enabled & ~use_cf, True))
    out = torch.where(x_is_zero, torch.zeros_like(out), out)
    return torch.where(domain_error | is_nan, torch.full_like(out, math.nan),
                       out)


def _igamma_grad_x(a, x):
    """∂P(a, x)/∂x = x^(a-1) e^(-x) / Γ(a)."""
    return torch.exp(torch.xlogy(a - 1.0, x) - x - torch.lgamma(a))


class _Gammainc(torch.autograd.Function):
    @staticmethod
    def forward(a, x, upper):
        if a.dtype == torch.float64:
            # torch's igamma is off by up to 2e-9 relative in float64 at
            # a ≳ 20; JAX's series and fraction are not
            return _igamma_value(a, x, upper)
        return (torch.special.gammaincc(a, x) if upper
                else torch.special.gammainc(a, x))

    @staticmethod
    def vmap(info, in_dims, a, x, upper):
        return _whole_batch(_Gammainc.apply, info, in_dims, a, x, upper)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, x, upper = inputs
        ctx.upper = upper
        ctx.save_for_backward(a, x)

    @staticmethod
    def backward(ctx, grad):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = (sign * grad * _igamma_grad_a(a, x)
              if ctx.needs_input_grad[0] else None)
        gx = (sign * grad * _igamma_grad_x(a, x)
              if ctx.needs_input_grad[1] else None)
        return ga, gx, None


def gammainc(a, x):
    """Regularized lower incomplete gamma P(a, x) (≙
    ``jax.scipy.special.gammainc``), differentiable in a and x."""
    a, x = _float(a, x)
    return _Gammainc.apply(a, x, False)


def gammaincc(a, x):
    """Regularized upper incomplete gamma Q(a, x) = 1 − P(a, x) (≙
    ``jax.scipy.special.gammaincc``), differentiable in a and x."""
    a, x = _float(a, x)
    return _Gammainc.apply(a, x, True)


# -- log Φ ----------------------------------------------------------------------

# JAX's switch points (jax/_src/scipy/special.py, log_ndtr): the asymptotic
# series below LOWER, log Φ between, −Φ(−x) above UPPER
_LOG_NDTR_BOUNDS = {torch.float32: (-10.0, 5.0), torch.float64: (-20.0, 8.0)}


def ndtr(x):
    """Φ(x) as JAX computes it: 1 + erf near 0, erfc in the tails (torch's
    ``special.ndtr`` is 1 + erf everywhere and loses the left tail)."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    z = x.abs() * half_sqrt_2
    tail = torch.special.erfc(z)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(x * half_sqrt_2),
                    torch.where(x > 0, 2.0 - tail, tail))
    return 0.5 * y


def _log_ndtr_value(x):
    lower, upper = _LOG_NDTR_BOUNDS.get(x.dtype, (-20.0, 8.0))
    low = x <= lower
    high = x > upper
    xm = x.clamp(lower, upper)
    body = torch.log(ndtr(xm))
    xh = torch.where(high, x, torch.full_like(x, upper))
    right = -ndtr(-xh)
    xl = torch.where(low, x, torch.full_like(x, lower))
    # log φ(x) − log(−x) + log(1 − 1/x² + 3/x⁴ − 15/x⁶): JAX's series_order 3
    z = 1.0 / (xl * xl)
    series = 1.0 + z * (-1.0 + z * (3.0 - 15.0 * z))
    left = (-0.5 * xl * xl - 0.5 * math.log(2.0 * math.pi) - torch.log(-xl)
            + torch.log(series))
    return torch.where(low, left, torch.where(high, right, body))


class _LogNdtr(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _log_ndtr_value(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad):
        # JAX's custom JVP: φ(x)/Φ(x) = exp(log φ(x) − log Φ(x))
        x, out = ctx.saved_tensors
        return grad * torch.exp(-0.5 * x * x
                                - 0.5 * math.log(2.0 * math.pi) - out)


def log_ndtr(x):
    """log Φ(x) elementwise by JAX's formulas (≙
    ``jax.scipy.special.log_ndtr``, its derivative φ/Φ included), with a vmap
    batching rule (plain torch ops; each branch sees its input clamped into
    its own range)."""
    (x,) = _float(x)
    return _LogNdtr.apply(x)
