"""MAP estimation and the Laplace (quadratic) posterior approximation.

PyTorch counterpart of ``mcmcpp_tpu/map_laplace.py``. The JAX package runs
``jax.scipy.optimize.minimize(method="BFGS")`` vmapped over the starts;
torch has no BFGS, so :func:`bfgs` is that algorithm written for a batch of
starts in torch ops on the device: Nocedal & Wright's Algorithm 6.1 with the
identity as the initial inverse Hessian, the strong-Wolfe line search of
Algorithm 3.5 (c1 = 1e-4, c2 = 0.9, at most 10 iterations, the first trial
step 1.01·2(f_k − f_{k−1})/φ'(0) capped at 1, doubling after) and its zoom
(Algorithm 3.6: cubic, then quadratic, then bisection, with the safeguards
0.2 and 0.1 of the interval, failing below an interval of 1e-5 in float32
or 1e-10 in float64 or after 30 steps), a step floor of 1e-8 below float64,
gtol 1e-5 on the gradient's max norm, and ``success = converged and not
failed`` — the constants and the order of the masked updates of
``jax/_src/scipy/optimize/{bfgs,line_search}.py``. Starts that have
converged or failed are held by masks while the others go on; each loop
(the iterations, the line search, the zoom) tests on the host whether any
start is still active, one read per pass.

The Laplace approximation N(θ_map, (−H)⁻¹) takes H from
``torch.func.hessian``.
"""

from typing import NamedTuple

import numpy as np
import torch

from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
from mcmcpp_tpu_torch.sampler import resolve_device

__all__ = ["LaplaceResult", "MapResult", "bfgs", "find_map", "laplace",
           "laplace_sample", "laplace_summary"]

GTOL = 1e-5
LS_MAXITER = 10
ZOOM_MAXITER = 30


class MapResult(NamedTuple):
    position: torch.Tensor  # (P,) the best mode found
    logp: torch.Tensor  # () logp at the mode
    converged: torch.Tensor  # () bool, BFGS success of the best start
    all_positions: torch.Tensor  # (n_starts, P) per-start optima
    all_logps: torch.Tensor  # (n_starts,)


class LaplaceResult(NamedTuple):
    mean: torch.Tensor  # (P,) the MAP
    covariance: torch.Tensor  # (P, P) inverse negative Hessian
    chol: torch.Tensor  # (P, P) lower Cholesky factor of the covariance
    logp_mode: torch.Tensor
    log_evidence: torch.Tensor  # Laplace marginal-likelihood estimate


class BFGSResult(NamedTuple):
    x: torch.Tensor  # (S, P)
    fun: torch.Tensor  # (S,)
    jac: torch.Tensor  # (S, P)
    hess_inv: torch.Tensor  # (S, P, P)
    success: torch.Tensor  # (S,) bool
    status: torch.Tensor  # (S,) int64
    nfev: torch.Tensor  # (S,) int64
    nit: torch.Tensor  # (S,) int64
    host_syncs: int  # the loops' host reads of "any start still active"


def _dot(a, b):
    return torch.sum(a * b, -1)


def _sel(mask, new, old):
    """``where(mask, new, old)`` with the mask broadcast over trailing
    axes."""
    while mask.ndim < new.ndim:
        mask = mask[..., None]
    return torch.where(mask, new, old)


def _merge(mask, state, new):
    """``state`` with the fields in ``new`` replaced where ``mask``."""
    return {**state, **{k: _sel(mask, v, state[k]) for k, v in new.items()}}


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    cc = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    e0, e1 = fb - fa - cc * db, fc - fa - cc * dc
    big_a = (dc ** 2 * e0 + (-db ** 2) * e1) / denom
    big_b = ((-dc ** 3) * e0 + db ** 3 * e1) / denom
    radical = big_b * big_b - 3.0 * big_a * cc
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    big_b = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * big_b)


class _Problem:
    """f = −logp on a batch of starts, and its restriction to the rays
    x_k + t·p_k."""

    def __init__(self, logp):
        self.logp = logp
        self.host_syncs = 0

    def any(self, mask):
        """Whether any start is still active: one host read."""
        self.host_syncs += 1
        return bool(mask.any())

    def value_and_grad(self, x):
        lp, g = logp_and_grad(self.logp, x)
        return -lp, -g

    def along(self, xk, pk):
        def rfg(t):
            phi, g = self.value_and_grad(xk + t[:, None] * pk)
            return phi, _dot(g, pk), g
        return rfg


def _zoom(prob, rfg, wolfe_one, wolfe_two, lo, hi, g_0, pass_through):
    """Algorithm 3.6 for each start where not ``pass_through``; ``lo`` and
    ``hi`` are (a, phi, dphi) triples."""
    a_lo, phi_lo, dphi_lo = lo
    a_hi, phi_hi, dphi_hi = hi
    dt, dev = a_lo.dtype, a_lo.device
    false = torch.zeros_like(pass_through)
    st = dict(done=false, failed=false,
              j=torch.zeros(a_lo.shape, dtype=torch.int64, device=dev),
              a_lo=a_lo, phi_lo=phi_lo, dphi_lo=dphi_lo, a_hi=a_hi,
              phi_hi=phi_hi, dphi_hi=dphi_hi, a_rec=(a_lo + a_hi) / 2.0,
              phi_rec=(phi_lo + phi_hi) / 2.0,
              a_star=torch.ones_like(a_lo), phi_star=phi_lo,
              dphi_star=dphi_lo, g_star=g_0,
              nfev=torch.zeros(a_lo.shape, dtype=torch.int64, device=dev))
    threshold = 1e-10 if dt == torch.float64 else 1e-5
    while True:
        act = ~st["done"] & ~pass_through & ~st["failed"]
        if not prob.any(act):
            return st
        s = dict(st)
        dalpha = s["a_hi"] - s["a_lo"]
        a = torch.minimum(s["a_hi"], s["a_lo"])
        b = torch.maximum(s["a_hi"], s["a_lo"])
        cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
        s["failed"] = s["failed"] | (dalpha <= threshold)
        a_cubic = _cubicmin(s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"],
                            s["phi_hi"], s["a_rec"], s["phi_rec"])
        use_cubic = (s["j"] > 0) & (a_cubic > a + cchk) & (a_cubic < b - cchk)
        a_quad = _quadmin(s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"],
                          s["phi_hi"])
        use_quad = ~use_cubic & (a_quad > a + qchk) & (a_quad < b - qchk)
        use_bisect = ~use_cubic & ~use_quad
        a_j = torch.where(use_cubic, a_cubic, s["a_rec"])
        a_j = torch.where(use_quad, a_quad, a_j)
        a_j = torch.where(use_bisect, (s["a_lo"] + s["a_hi"]) / 2.0, a_j)
        phi_j, dphi_j, g_j = rfg(a_j)
        s["nfev"] = s["nfev"] + 1
        hi_to_j = wolfe_one(a_j, phi_j) | (phi_j >= s["phi_lo"])
        star_to_j = wolfe_two(dphi_j) & ~hi_to_j
        hi_to_lo = ((dphi_j * (s["a_hi"] - s["a_lo"]) >= 0.0) & ~hi_to_j
                    & ~star_to_j)
        lo_to_j = ~hi_to_j & ~star_to_j
        s = _merge(hi_to_j, s, dict(a_hi=a_j, phi_hi=phi_j, dphi_hi=dphi_j,
                                    a_rec=s["a_hi"], phi_rec=s["phi_hi"]))
        s["done"] = star_to_j | s["done"]
        s = _merge(star_to_j, s, dict(a_star=a_j, phi_star=phi_j,
                                      dphi_star=dphi_j, g_star=g_j))
        s = _merge(hi_to_lo, s, dict(a_hi=s["a_lo"], phi_hi=s["phi_lo"],
                                     dphi_hi=s["dphi_lo"], a_rec=s["a_hi"],
                                     phi_rec=s["phi_hi"]))
        s = _merge(lo_to_j & ~hi_to_lo, s, dict(a_rec=s["a_lo"],
                                                phi_rec=s["phi_lo"]))
        s = _merge(lo_to_j, s, dict(a_lo=a_j, phi_lo=phi_j, dphi_lo=dphi_j))
        s["j"] = s["j"] + 1
        s["failed"] = s["failed"] | (s["j"] >= ZOOM_MAXITER)
        st = _merge(act, st, s)


def _line_search(prob, xk, pk, old_fval, old_old_fval, gfk, active, c1=1e-4,
                 c2=0.9, maxiter=LS_MAXITER):
    """Algorithm 3.5 (strong Wolfe) for each start where ``active``.
    Returns (failed, nfev, a_k, f_k, g_k, status)."""
    rfg = prob.along(xk, pk)
    phi_0, dphi_0 = old_fval, _dot(gfk, pk)
    candidate = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start_value = torch.where(candidate > 1, 1.0, candidate)

    def wolfe_one(a_i, phi_i):
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return torch.abs(dphi_i) <= -c2 * dphi_0

    dev = xk.device
    false = torch.zeros_like(active)
    zero = torch.zeros_like(phi_0)
    st = dict(done=false, failed=false,
              i=torch.ones(phi_0.shape, dtype=torch.int64, device=dev),
              a_i1=zero, phi_i1=phi_0, dphi_i1=dphi_0,
              nfev=torch.zeros(phi_0.shape, dtype=torch.int64, device=dev),
              a_star=zero, phi_star=phi_0, dphi_star=dphi_0, g_star=gfk)
    while True:
        act = active & ~st["done"] & (st["i"] <= maxiter) & ~st["failed"]
        if not prob.any(act):
            break
        s = dict(st)
        a_i = torch.where(s["i"] == 1, start_value, s["a_i1"] * 2.0)
        phi_i, dphi_i, g_i = rfg(a_i)
        s["nfev"] = s["nfev"] + 1
        to_zoom1 = wolfe_one(a_i, phi_i) | ((phi_i >= s["phi_i1"])
                                            & (s["i"] > 1))
        to_i = wolfe_two(dphi_i) & ~to_zoom1
        to_zoom2 = (dphi_i >= 0.0) & ~to_zoom1 & ~to_i
        # the two zooms of the JAX code exclude each other per start: one
        # zoom, its bracket ordered as the branch taken orders it
        here = (a_i, phi_i, dphi_i)
        before = (s["a_i1"], s["phi_i1"], s["dphi_i1"])
        lo = tuple(torch.where(to_zoom1, u, v) for u, v in zip(before, here))
        hi = tuple(torch.where(to_zoom1, u, v) for u, v in zip(here, before))
        zoom = _zoom(prob, rfg, wolfe_one, wolfe_two, lo, hi, gfk,
                     ~(to_zoom1 | to_zoom2) | ~act)
        s["nfev"] = s["nfev"] + zoom["nfev"]
        to_zoom = to_zoom1 | to_zoom2
        s["done"] = to_zoom | to_i | s["done"]
        s["failed"] = (to_zoom & zoom["failed"]) | s["failed"]
        s = _merge(to_zoom, s, {k: zoom[k] for k in
                                ("a_star", "phi_star", "dphi_star",
                                 "g_star")})
        s = _merge(to_i, s, dict(a_star=a_i, phi_star=phi_i,
                                 dphi_star=dphi_i, g_star=g_i))
        s.update(i=s["i"] + 1, a_i1=a_i, phi_i1=phi_i, dphi_i1=dphi_i)
        st = _merge(act, st, s)
    status = torch.where(st["failed"], 1, torch.where(st["i"] > maxiter, 3,
                                                      0))
    alpha = st["a_star"]
    if alpha.dtype != torch.float64:
        # a floor on tiny steps below float64 (they would stall the search)
        alpha = torch.where(torch.abs(alpha) < 1e-8,
                            torch.sign(alpha) * 1e-8, alpha)
    return (st["failed"] | ~st["done"], st["nfev"], alpha, st["phi_star"],
            st["g_star"], status)


def bfgs(logp, x0, maxiter=None, gtol=GTOL):
    """Minimize −logp from each row of ``x0`` (S, P) by BFGS, the starts as
    one batch; ``logp`` maps (S, P) -> (S,). Returns :class:`BFGSResult`
    (success = converged and not failed, as ``jax.scipy.optimize``)."""
    s_count, d = x0.shape
    maxiter = d * 200 if maxiter is None else int(maxiter)
    prob = _Problem(logp)
    dev, dt = x0.device, x0.dtype
    eye = torch.eye(d, dtype=dt, device=dev)
    f_0, g_0 = prob.value_and_grad(x0)
    st = dict(converged=torch.amax(torch.abs(g_0), -1) < gtol,
              failed=torch.zeros((s_count,), dtype=torch.bool, device=dev),
              k=torch.zeros((s_count,), dtype=torch.int64, device=dev),
              nfev=torch.ones((s_count,), dtype=torch.int64, device=dev),
              x_k=x0, f_k=f_0, g_k=g_0, H_k=eye.expand(s_count, d, d),
              old_old_fval=f_0 + torch.linalg.vector_norm(g_0, dim=-1) / 2,
              ls_status=torch.zeros((s_count,), dtype=torch.int64,
                                    device=dev))
    while True:
        act = ~st["converged"] & ~st["failed"] & (st["k"] < maxiter)
        if not prob.any(act):
            break
        s = dict(st)
        p_k = -(s["H_k"] @ s["g_k"][..., None])[..., 0]
        failed, nfev, a_k, f_kp1, g_kp1, ls_status = _line_search(
            prob, s["x_k"], p_k, s["f_k"], s["old_old_fval"], s["g_k"], act)
        s.update(nfev=s["nfev"] + nfev, failed=failed, ls_status=ls_status)
        s_k = a_k[:, None] * p_k
        x_kp1 = s["x_k"] + s_k
        y_k = g_kp1 - s["g_k"]
        rho_k = 1.0 / _dot(y_k, s_k)
        w = eye - rho_k[:, None, None] * (s_k[:, :, None] * y_k[:, None, :])
        h_kp1 = (w @ s["H_k"] @ w.transpose(-1, -2) + rho_k[:, None, None]
                 * s_k[:, :, None] * s_k[:, None, :])
        h_kp1 = _sel(torch.isfinite(rho_k), h_kp1, s["H_k"])
        s.update(converged=torch.amax(torch.abs(g_kp1), -1) < gtol,
                 k=s["k"] + 1, x_k=x_kp1, f_k=f_kp1, g_k=g_kp1, H_k=h_kp1,
                 old_old_fval=s["f_k"])
        st = _merge(act, st, s)
    status = torch.where(
        st["converged"], 0, torch.where(
            st["k"] == maxiter, 1,
            torch.where(st["failed"], 2 + st["ls_status"], -1)))
    return BFGSResult(st["x_k"], st["f_k"], st["g_k"], st["H_k"],
                      st["converged"] & ~st["failed"], status, st["nfev"],
                      st["k"], prob.host_syncs)


def find_map(logp_fn, x0, maxiter=500, dtype=torch.float32, batched=False,
             device="cuda"):
    """Maximize ``logp_fn`` from one or many starts (x0: (P,) or
    (n_starts, P)), all starts one batched BFGS; the best final logp wins.
    ``logp_fn``: (P,) -> scalar, or with ``batched=True`` (n, P) -> (n,)."""
    device = resolve_device(device)
    x0 = torch.as_tensor(np.asarray(x0) if not isinstance(
        x0, torch.Tensor) else x0).to(device, dtype)
    res = bfgs(logp_fn if batched else torch.func.vmap(logp_fn),
               torch.atleast_2d(x0), maxiter=maxiter)
    lps = -res.fun
    best = torch.argmax(torch.where(torch.isnan(lps), -torch.inf, lps))
    return MapResult(position=res.x[best], logp=lps[best],
                     converged=res.success[best], all_positions=res.x,
                     all_logps=lps)


def laplace(logp_fn, x0=None, map_result=None, maxiter=500, jitter=0.0,
            dtype=torch.float32, batched=False, device="cuda"):
    """Laplace approximation N(θ_map, (−H)⁻¹) around the MAP, from ``x0``
    (the MAP is found first) or a ``map_result``. ``jitter`` adds a ridge
    before inversion. ``log_evidence`` = logp(mode) + P/2·log 2π +
    ½·log|cov|."""
    if map_result is None:
        if x0 is None:
            raise ValueError("pass x0 or map_result")
        map_result = find_map(logp_fn, x0, maxiter=maxiter, dtype=dtype,
                              batched=batched, device=device)
    mode = map_result.position
    one = ((lambda x: logp_fn(x[None])[0]) if batched else logp_fn)
    h = torch.func.hessian(one)(mode)
    p = mode.shape[-1]
    eye = torch.eye(p, dtype=h.dtype, device=h.device)
    prec = -(h + h.T) / 2.0 + jitter * eye
    chol_prec, info = torch.linalg.cholesky_ex(prec)
    if bool(info != 0) or bool(torch.isnan(chol_prec).any()):
        raise ValueError(
            "negative Hessian is not positive definite at the mode found; "
            "the point is a saddle/ridge — try more starts or jitter > 0")
    inv_chol = torch.linalg.solve_triangular(chol_prec, eye, upper=False)
    cov = inv_chol.T @ inv_chol
    logdet_cov = -2.0 * torch.sum(torch.log(torch.diagonal(chol_prec)))
    log_ev = (map_result.logp + 0.5 * p * np.log(2.0 * np.pi)
              + 0.5 * logdet_cov)
    return LaplaceResult(mean=mode, covariance=cov,
                         chol=torch.linalg.cholesky(cov),
                         logp_mode=map_result.logp, log_evidence=log_ev)


def laplace_sample(gen, lap, n):
    """``n`` draws of a Laplace approximation; ``gen`` a generator on its
    device."""
    z = torch.randn((int(n), lap.mean.shape[-1]), generator=gen,
                    dtype=lap.mean.dtype, device=lap.mean.device)
    return lap.mean[None, :] + z @ lap.chol.T


def laplace_summary(lap):
    """Posterior mean/sd dict (numpy) of a Laplace approximation."""
    return {"mean": lap.mean.cpu().numpy(),
            "sd": np.sqrt(np.diagonal(lap.covariance.cpu().numpy())),
            "log_evidence": float(lap.log_evidence)}
