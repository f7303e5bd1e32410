"""Fused stretch half-step: the CUDA kernel and its plain PyTorch version.

Counterpart of ``mcmcpp_tpu/ops/pallas_stretch.py::fused_stretch_half``. One
call updates the active half against the other half: partner
``other[(i + shift) % n]``, z from u, proposal, logp, and the accept select
log(ue) < (P−1)·log z + lp_new − lp_old, in one pass.

The random inputs are explicit: a (1,) int32 device ``shift`` and two (n,)
uniforms ``u`` and ``ue`` in [2^-25, 1). The Pallas kernel drew them from the
TPU's hardware generator; here the caller draws them (``ops/random.py``), which
also lets tests feed both packages the same numbers.

:func:`fused_stretch_half` dispatches on the tensors' device: on the CPU it
runs :func:`fused_stretch_half_reference`; on CUDA it launches the kernel in
``csrc/fused_stretch.cu``, or raises. The kernel evaluates the Gaussian logp
in its own body, so on CUDA the target must be a
:class:`~mcmcpp_tpu_torch.models.targets.GaussianTarget`.
"""

import torch

from mcmcpp_tpu_torch.models.targets import GaussianTarget
from mcmcpp_tpu_torch.ops.gw import gw_sample

#: launches of the CUDA kernel in this process (reset by callers that count)
LAUNCHES = 0

MAX_P = 64


def stretch_proposal(active, active_logp, other, shift, u, *, logp_fn,
                     a=2.0):
    """Proposal, its logp and the log acceptance ratio of one half-step,
    in plain PyTorch: (proposal (n, P), lp_new (n,), log_ratio (n,))."""
    n, p = active.shape
    if other.shape != (n, p):
        raise ValueError("fused stretch requires equal halves")
    idx = (torch.arange(n, device=active.device) + shift.to(torch.int64)) % n
    partner = other[idx]
    z = gw_sample(u, a)
    proposal = partner + z[:, None] * (active - partner)
    lp_new = logp_fn(proposal)
    return proposal, lp_new, (p - 1) * torch.log(z) + lp_new - active_logp


def fused_stretch_half_reference(active, active_logp, other, shift, u, ue, *,
                                 logp_fn, a=2.0):
    """Plain PyTorch half-step; ``logp_fn`` is any (n, P) -> (n,) callable.

    Returns (new_active, new_logp, accepted int32).
    """
    proposal, lp_new, log_ratio = stretch_proposal(
        active, active_logp, other, shift, u, logp_fn=logp_fn, a=a
    )
    accept = torch.log(ue) < log_ratio
    return (
        torch.where(accept[:, None], proposal, active),
        torch.where(accept, lp_new, active_logp),
        accept.to(torch.int32),
    )


def _check_kernel_args(active, active_logp, other, shift, u, ue, prec_chol):
    n, p = active.shape
    if other.shape != (n, p):
        raise ValueError("fused stretch requires equal halves")
    if n == 0:
        raise ValueError("fused stretch needs at least one walker")
    if p > MAX_P:
        raise NotImplementedError(
            f"the fused CUDA kernel supports P <= {MAX_P}, got P = {p}"
        )
    floats = {"active": active, "active_logp": active_logp, "other": other,
              "u": u, "ue": ue, "prec_chol": prec_chol}
    shapes = {"active": (n, p), "active_logp": (n,), "other": (n, p),
              "u": (n,), "ue": (n,), "prec_chol": (p, p)}
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
    if shift.dtype != torch.int32 or shift.numel() != 1:
        raise TypeError("shift must be one int32 element")
    for name, t in {**floats, "shift": shift}.items():
        if t.device != active.device:
            raise ValueError(f"{name} is on {t.device}, active on "
                             f"{active.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(active, active_logp, other, shift, u, ue, prec_chol, a):
    global LAUNCHES
    from mcmcpp_tpu_torch._build import load_library

    lib = load_library()
    n, p = active.shape
    out_act = torch.empty_like(active)
    out_lp = torch.empty_like(active_logp)
    out_acc = torch.empty((n,), dtype=torch.int32, device=active.device)
    with torch.cuda.device(active.device):
        stream = torch.cuda.current_stream(active.device).cuda_stream
        err = lib.mcmcpp_fused_stretch_half_f32(
            active.data_ptr(), active_logp.data_ptr(), other.data_ptr(),
            shift.data_ptr(), u.data_ptr(), ue.data_ptr(),
            prec_chol.data_ptr(), out_act.data_ptr(), out_lp.data_ptr(),
            out_acc.data_ptr(), n, p, float(a), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused stretch kernel launch failed (cudaError {err})"
        )
    LAUNCHES += 1
    return out_act, out_lp, out_acc


def fused_stretch_half(active, active_logp, other, shift, u, ue, *, logp_fn,
                       a=2.0):
    """One fused stretch half-step. Returns (new_active, new_logp, accepted
    int32). CPU tensors take the plain version; CUDA tensors the kernel."""
    if active.device.type == "cpu":
        return fused_stretch_half_reference(
            active, active_logp, other, shift, u, ue, logp_fn=logp_fn, a=a
        )
    if not isinstance(logp_fn, GaussianTarget):
        raise NotImplementedError(
            "the fused CUDA half-step evaluates a GaussianTarget in its own "
            "body (pass the module itself, batched=True); other logps need "
            "the propose -> torch logp -> accept split path, not yet ported. "
            "Use StretchMove for them."
        )
    if active.device.type != "cuda":
        raise RuntimeError(f"no fused stretch path for {active.device}")
    prec_chol = logp_fn.prec_chol
    _check_kernel_args(active, active_logp, other, shift, u, ue, prec_chol)
    return _launch(active, active_logp, other, shift, u, ue, prec_chol, a)
