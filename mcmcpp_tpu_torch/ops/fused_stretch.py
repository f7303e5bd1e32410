"""Fused stretch half-step: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``mcmcpp_tpu/ops/pallas_stretch.py::fused_stretch_half``. One
call updates the active half against the other half: partner
``other[(i + shift) % n]``, z from u, proposal, logp, and the accept select
log(ue) < (P−1)·log z + lp_new − lp_old.

Row offset: every function takes ``row0`` (default 0). The n active rows are
then rows row0…row0+n−1 of a half of m walkers, and ``other`` is the whole
opposite half (m rows): local row i pairs with ``other[(row0 + i + shift) %
m]``, draws its uniforms from counter row0 + i, and its outputs are local
row i. That is a rank's shard of a sharded ensemble
(``parallel/sharded.py``); R calls over consecutive row shards give the one
unsharded call's outputs, bit for bit. Unsharded, row0 = 0 and m = n.

The random inputs: a (1,) int32 device ``shift`` and the uniforms ``u`` and
``ue`` in [2^-25, 1), one pair per active walker. The Pallas kernel seeded the
TPU's hardware generator and drew them inside its body. The CUDA kernels do
the same with a counter-based generator: they take a 64-bit ``key`` (a Python
int, passed by value) and compute walker i's pair in registers as the Philox
words of (key, i), so no plane of uniforms exists on the card. The plain
versions keep explicit (n,) planes, which also lets tests feed both packages
the same numbers; ``ops/random.py::philox_unit_uniforms(key, n, device)`` gives
the planes the kernels draw, bit for bit, so a kernel run with ``key`` is held
against its plain version run on those planes.

:func:`fused_stretch_half` dispatches on the tensors' device and the logp:

- CPU tensors run :func:`fused_stretch_half_reference`, for any logp, on the
  planes ``u`` and ``ue`` (a caller that holds a key makes them with
  ``philox_unit_uniforms``);
- CUDA tensors take ``key`` (planes raise) and go one of three routes, each
  a hand-written kernel:

  1. a :class:`~mcmcpp_tpu_torch.models.targets.GaussianTarget` of P <=
     ``MAX_P`` (16) launches the fused kernel of ``csrc/fused_stretch.cu``
     (a thread a walker, Y in registers, all of L in shared memory), which
     evaluates the Gaussian logp in its own body: one launch a half-step;
  2. a GaussianTarget wider than ``MAX_P`` launches the wide kernel of
     ``csrc/fused_stretch_wide.cu``, one launch a half-step at any P, by
     one of the routes of ``WIDE_ROUTES``: where L's split halves fit in
     shared memory beside two Y tiles and their rings (P <= 117 on an H100)
     a persistent, warp-specialised block on each SM (a producer warp
     bulk-loads walker tiles into mbarrier rings, consumer warpgroups form
     Y and take Y·L with wgmma as 3xTF32, about float32's accuracy); wider,
     where a cluster's plan fits (P <= 296 on an H100), the same kernel on
     thread-block clusters of 2, 4 or 8 blocks, each holding a column slice
     of L and forming its share of every tile's proposal rows, which it
     sends into the others' shared memory, the row sums reduced through
     distributed shared memory; wider, while a 64-row Y tile fits beside
     two slots of a ring (P <= 784 on an H100), the L-streamed kernel (a
     prologue splits L once a launch into scratch this module allocates,
     in the order of its stages, which a producer warp bulk-copies,
     multicast to a cluster's blocks, into the ring that also takes the
     walker rows, under two consumer warpgroups' wgmma); wider, while a
     cluster's k-slices of a 128-row Y tile fit (P = 785–2944 on an H100:
     ``WIDE_ROUTES[5]``), the K-split kernel (each block of a cluster of
     4 or 8 keeps its k-slice of the tile's Y and streams its rows of L,
     split by the same prologue, under two consumer warpgroups' wgmma; the
     partial products of each column panel are added in rank order by the
     blocks that own their rows, through distributed shared memory); wider
     still, at any P (``WIDE_ROUTES[6]``), Y and L both streamed (a
     4 × 2 thread-block cluster forms each tile's Y once into the scratch
     and streams it back beside the same prologue's L stages, each stage
     multicast to the blocks that share it, under two consumer warpgroups'
     wgmma; the row sums of each column group are added in rank order by
     the block that owns the rows). The mma.sync kernel (a block of 64 or
     128 walkers, L streamed, Y in a tile or streamed through the output
     rows) stays in the library for a device whose blocks no wgmma plan
     fits; on an H100 the dispatch reaches it at no width, and
     :func:`wide_forced_mma` launches it for checking and timing;
  3. any other batched logp takes the split path of ``csrc/
     stretch_split.cu``: the propose kernel, the logp as torch ops on the
     current stream, then the accept kernel (the Pallas kernel traced the
     logp into its body; a torch logp cannot run inside a CUDA C++ kernel).
     The split kernels take any P, as the Pallas kernel does.

  A kernel that fails to build or launch raises; no route falls back to
  another;
- any other device raises.

Each kernel has its plain twin here: :func:`stretch_propose_reference`,
:func:`stretch_accept_reference`, and :func:`fused_stretch_half_reference`,
which is the two with the logp between them and is the plain version of
both fused kernels (with the target's torch ``forward`` as the logp).
"""

import torch

from mcmcpp_tpu_torch.models.targets import GaussianTarget
from mcmcpp_tpu_torch.ops.gw import gw_sample

#: launches of each CUDA kernel in this process, by kernel name (callers that
#: count set them to 0)
LAUNCHES = {"fused_stretch_half": 0, "fused_stretch_wide": 0,
            "stretch_propose": 0, "stretch_accept": 0}

#: the widest GaussianTarget the fused kernel takes (``csrc/fused_stretch.cu``'s
#: ``kMaxP``); a wider one runs the wide kernel, which measured 1.3–5.0x
#: faster than the fused kernel's former 32- and 64-wide builds at P = 17–64
#: and slower at P = 16 (n = 2^20, an H100, in turns; ``PERF.md`` §6)
MAX_P = 16


def _check_rows(active, other, row0):
    """Rows row0…row0+n−1 of the active half must lie in the other half's
    m rows, of the same width (unsharded: equal halves)."""
    (n, p), m = active.shape, other.shape[0]
    if other.ndim != 2 or other.shape[1] != p or not 0 <= row0 <= m - n:
        raise ValueError(
            f"fused stretch requires equal halves: active rows {row0}…"
            f"{row0 + n - 1} of width {p} against other {tuple(other.shape)}")


def _partner_index(n, shift, m, row0, device):
    i = torch.arange(row0, row0 + n, device=device)
    return (i + shift.to(torch.int64)) % m


def stretch_propose_reference(active, other, shift, u, a=2.0, row0=0):
    """Plain twin of the propose kernel: (proposal (n, P), (P−1)·log z
    (n,)) with partner ``other[(row0 + i + shift) % m]``."""
    n, p = active.shape
    _check_rows(active, other, row0)
    partner = other[_partner_index(n, shift, other.shape[0], row0,
                                   active.device)]
    z = gw_sample(u, a)
    return partner + z[:, None] * (active - partner), (p - 1) * torch.log(z)


def stretch_accept_reference(active, proposal, active_logp, lp_new,
                             log_factor, ue):
    """Plain twin of the accept kernel: accept iff
    log(ue) < log_factor + lp_new − lp_old. Returns (new_active, new_logp,
    accepted int32)."""
    accept = torch.log(ue) < log_factor + lp_new - active_logp
    return (
        torch.where(accept[:, None], proposal, active),
        torch.where(accept, lp_new, active_logp),
        accept.to(torch.int32),
    )


def stretch_proposal(active, active_logp, other, shift, u, *, logp_fn,
                     a=2.0, row0=0):
    """Proposal, its logp and the log acceptance ratio of one half-step,
    in plain PyTorch: (proposal (n, P), lp_new (n,), log_ratio (n,))."""
    proposal, log_factor = stretch_propose_reference(active, other, shift, u,
                                                     a, row0)
    lp_new = logp_fn(proposal)
    return proposal, lp_new, log_factor + lp_new - active_logp


def fused_stretch_half_reference(active, active_logp, other, shift, u, ue, *,
                                 logp_fn, a=2.0, row0=0):
    """Plain PyTorch half-step; ``logp_fn`` is any (n, P) -> (n,) callable.

    Returns (new_active, new_logp, accepted int32).
    """
    proposal, log_factor = stretch_propose_reference(active, other, shift, u,
                                                     a, row0)
    return stretch_accept_reference(active, proposal, active_logp,
                                    logp_fn(proposal), log_factor, ue)


def _check_args(tensors, shapes, device):
    """float32 (int32 for ``shift``), shape, device and contiguity checks
    of the tensors a kernel reads."""
    for name, t in tensors.items():
        want = torch.int32 if name == "shift" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, active on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_key(key):
    """``key`` as the 64-bit unsigned int the kernels take."""
    if isinstance(key, bool) or not isinstance(key, int):
        raise TypeError("on a CUDA tensor the stretch kernels draw u and ue "
                        "themselves: pass key, a Python int below 2^64, not "
                        f"planes (got key={key!r})")
    if not 0 <= key < 1 << 64:
        raise ValueError(f"a Philox key is a 64-bit unsigned int, got {key}")
    return key


def _half_args(active, active_logp, other, shift, row0):
    n, p = active.shape
    _check_rows(active, other, row0)
    if n == 0:
        raise ValueError("fused stretch needs at least one walker")
    tensors = {"active": active, "active_logp": active_logp, "other": other,
               "shift": shift}
    shapes = {"active": (n, p), "active_logp": (n,),
              "other": tuple(other.shape), "shift": (1,)}
    _check_args(tensors, shapes, active.device)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _checked(err, name, count=True):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
    if count:
        LAUNCHES[name] += 1


def _launch_fused(active, active_logp, other, shift, key, prec_chol, a,
                  row0):
    from mcmcpp_tpu_torch._build import load_library

    lib = load_library()
    n, p = active.shape
    out_act = torch.empty_like(active)
    out_lp = torch.empty_like(active_logp)
    out_acc = torch.empty((n,), dtype=torch.int32, device=active.device)
    with torch.cuda.device(active.device):
        err = lib.mcmcpp_fused_stretch_half_f32(
            active.data_ptr(), active_logp.data_ptr(), other.data_ptr(),
            shift.data_ptr(), key, prec_chol.data_ptr(),
            out_act.data_ptr(), out_lp.data_ptr(),
            out_acc.data_ptr(), n, row0, other.shape[0], p, float(a),
            _stream(active.device),
        )
    _checked(err, "fused_stretch_half")
    return out_act, out_lp, out_acc


def _launch_wide(active, active_logp, other, shift, key, prec_chol, a,
                 row0, loads_only=False):
    from mcmcpp_tpu_torch._build import load_library

    lib = load_library()
    entry = (lib.mcmcpp_fused_stretch_wide_loads_only_f32 if loads_only
             else lib.mcmcpp_fused_stretch_wide_f32)
    n, p = active.shape
    out_act = torch.empty_like(active)
    out_lp = torch.empty_like(active_logp)
    out_acc = torch.empty((n,), dtype=torch.int32, device=active.device)
    with torch.cuda.device(active.device):
        scratch = _wide_scratch(p, active.device)
        err = entry(
            active.data_ptr(), active_logp.data_ptr(), other.data_ptr(),
            shift.data_ptr(), key, prec_chol.data_ptr(),
            out_act.data_ptr(), out_lp.data_ptr(),
            out_acc.data_ptr(), n, row0, other.shape[0], p, float(a),
            _stream(active.device),
            None if scratch is None else scratch.data_ptr(),
        )
    _checked(err, "fused_stretch_wide", count=not loads_only)
    return out_act, out_lp, out_acc


#: the routes of the wide kernel, by the number ``wide_layout`` gives
WIDE_ROUTES = ("wgmma, warp-specialised", "mma.sync, Y tile",
               "mma.sync, Y streamed", "wgmma, thread-block cluster",
               "wgmma, L streamed", "wgmma, K split over a cluster",
               "wgmma, Y and L streamed")

#: bytes of the scratch a wide launch takes and of L's split stages at its
#: start, by (device index, P): both 0 but on the L-streamed, K-split and
#: Y-and-L-streamed routes (the last also keeps its Y buffers there)
_SCRATCH_BYTES = {}


def _scratch_bytes(p, device):
    """(scratch bytes of a wide launch at width ``p``, bytes of L's split
    stages at its start), as the library sizes them on ``device``."""
    import ctypes

    from mcmcpp_tpu_torch._build import load_library

    at = (torch.device(device).index, p)
    if at not in _SCRATCH_BYTES:
        out = (ctypes.c_longlong * 2)()
        with torch.cuda.device(device):
            err = load_library().mcmcpp_fused_stretch_wide_scratch_bytes(
                int(p), out)
        if err != 0:
            raise RuntimeError(f"wide kernel scratch at P={p} failed "
                               f"(cudaError {err})")
        _SCRATCH_BYTES[at] = (out[0], out[1])
    return _SCRATCH_BYTES[at]


def _wide_scratch(p, device):
    """The scratch of a wide launch at width ``p`` on ``device``: a new
    ``torch.empty`` buffer where the library's route keeps L's split stages
    there (the L-streamed and K-split routes; on the Y-and-L-streamed route
    also its Y buffers), else None."""
    nbytes = _scratch_bytes(p, device)[0]
    if not nbytes:
        return None
    return torch.empty((nbytes // 4,), dtype=torch.float32, device=device)


def wide_layout(p, device="cuda"):
    """The block the wide kernel launches at width ``p`` on ``device``, as
    the library plans it: route (an index of ``WIDE_ROUTES``), dynamic
    shared memory in bytes, walkers a block holds at once (on the K-split
    route the 128 rows of its Y slice, a cluster's tile), for the wgmma
    kernels rows a walker stage, stages a ring (a consumer's on the
    warp-specialised route; on the L-streamed and K-split routes the one
    ring's slots, each a walker stage or a stage of L) and wgmma N (a
    block's columns of S on the cluster route, a consumer's of a panel on
    the L-streamed and K-split routes; 0 elsewhere), blocks a cluster (1
    but on the cluster, L-streamed and K-split routes), the clusters the
    device holds at once (those three routes; 0 elsewhere), the k-steps of
    8 in a stage of L and the bytes of the launch's scratch (the L-streamed
    and K-split routes: L's split stages; 0 elsewhere). On the
    Y-and-L-streamed route (index 6) the walkers are a cluster's tile of
    128 rows, the rows a stage the 128 of a Y stage, the stages the ring's
    slots (each a Y stage beside an L stage), N a panel's columns, the
    cluster its 4 × 2 blocks, and the scratch L's split stages and the Y
    buffers of as many clusters as the device holds."""
    import ctypes

    from mcmcpp_tpu_torch._build import load_library

    out = (ctypes.c_int * 10)()
    with torch.cuda.device(device):
        err = load_library().mcmcpp_fused_stretch_wide_layout(int(p), out)
    if err != 0:
        raise RuntimeError(f"wide kernel layout at P={p} failed "
                           f"(cudaError {err})")
    keys = ("route", "smem_bytes", "block_walkers", "stage_rows", "stages",
            "wgmma_n", "cluster", "active_clusters", "l_ksteps",
            "scratch_bytes")
    layout = dict(zip(keys, list(out)))
    # the library's int gives −1 past 2^31 − 1 bytes
    layout["scratch_bytes"] = _scratch_bytes(p, device)[0]
    return layout


def wide_split_l(prec_chol):
    """The prologue of the L-streamed, K-split and Y-and-L-streamed routes
    alone on a CUDA ``prec_chol`` (P, P): L's split stages, as the wide
    kernel writes them at the start of its scratch, for measuring what the
    prologue takes. Nothing in the port calls it; it counts no launch.
    Raises where none of those routes takes P."""
    from mcmcpp_tpu_torch._build import load_library

    p = prec_chol.shape[0]
    _check_args({"prec_chol": prec_chol}, {"prec_chol": (p, p)},
                prec_chol.device)
    with torch.cuda.device(prec_chol.device):
        l_bytes = _scratch_bytes(p, prec_chol.device)[1]
        if not l_bytes:
            raise RuntimeError(f"none of the routes that split L takes "
                               f"P={p}")
        stages = torch.empty((l_bytes // 4,), dtype=torch.float32,
                             device=prec_chol.device)
        err = load_library().mcmcpp_fused_stretch_wide_split_l_f32(
            prec_chol.data_ptr(), p, stages.data_ptr(),
            _stream(prec_chol.device))
    if err != 0:
        raise RuntimeError(f"wide kernel prologue at P={p} failed "
                           f"(cudaError {err})")
    return stages


def wide_loads_only(active, active_logp, other, shift, key, prec_chol, a=2.0,
                    row0=0):
    """The wide kernel's loads and stores without its product, through the
    library's debug entry point, on CUDA tensors: for measuring what the
    loads alone take on the wgmma routes (on the cluster route with the
    proposal rows sent between the blocks and the exchange of the row
    sums, on the L-streamed and K-split routes with the prologue and every
    stage of L through its ring, on the K-split route with the exchange of
    the partial products, on the Y-and-L-streamed route with the Y buffers
    formed and every Y and L stage through the ring). lp_new is taken as
    lp_old,
    so its outputs are not a half-step's. Nothing in the port calls it; it
    counts no launch."""
    key = _check_key(key)
    _half_args(active, active_logp, other, shift, int(row0))
    return _launch_wide(active, active_logp, other, shift, key, prec_chol, a,
                        int(row0), loads_only=True)


def wide_forced_mma(active, active_logp, other, shift, key, prec_chol,
                    a=2.0, row0=0):
    """The wide kernel's mma.sync route (``WIDE_ROUTES[1]`` where its Y tile
    fits the device's block, else ``WIDE_ROUTES[2]``, Y streamed) at any
    width, whatever route the dispatch takes there, through the library's
    debug entry point, on CUDA tensors: a half-step's outputs, for holding
    that kernel against its plain version and timing it. Nothing in the
    port calls it; it counts no launch."""
    from mcmcpp_tpu_torch._build import load_library

    key = _check_key(key)
    row0 = int(row0)
    _half_args(active, active_logp, other, shift, row0)
    n, p = active.shape
    _check_args({"prec_chol": prec_chol}, {"prec_chol": (p, p)},
                active.device)
    out_act = torch.empty_like(active)
    out_lp = torch.empty_like(active_logp)
    out_acc = torch.empty((n,), dtype=torch.int32, device=active.device)
    with torch.cuda.device(active.device):
        err = load_library().mcmcpp_fused_stretch_wide_forced_mma_f32(
            active.data_ptr(), active_logp.data_ptr(), other.data_ptr(),
            shift.data_ptr(), key, prec_chol.data_ptr(),
            out_act.data_ptr(), out_lp.data_ptr(), out_acc.data_ptr(), n,
            row0, other.shape[0], p, float(a), _stream(active.device))
    _checked(err, "fused_stretch_wide", count=False)
    return out_act, out_lp, out_acc


def stretch_propose(active, other, shift, key, a=2.0, row0=0):
    """The propose kernel on CUDA tensors: (proposal (n, P), (P−1)·log z
    (n,)), as :func:`stretch_propose_reference` computes them on the plane
    ``philox_unit_uniforms(key, n, row0=row0)[0]``."""
    from mcmcpp_tpu_torch._build import load_library

    n, p = active.shape
    key = _check_key(key)
    _check_rows(active, other, row0)
    _check_args({"active": active, "other": other, "shift": shift},
                {"active": (n, p), "other": tuple(other.shape),
                 "shift": (1,)},
                active.device)
    lib = load_library()
    proposal = torch.empty_like(active)
    log_factor = torch.empty((n,), dtype=active.dtype, device=active.device)
    with torch.cuda.device(active.device):
        err = lib.mcmcpp_stretch_propose_f32(
            active.data_ptr(), other.data_ptr(), shift.data_ptr(), key,
            proposal.data_ptr(), log_factor.data_ptr(), n, row0,
            other.shape[0], p, float(a), _stream(active.device),
        )
    _checked(err, "stretch_propose")
    return proposal, log_factor


def stretch_accept(active, proposal, active_logp, lp_new, log_factor, key,
                   row0=0):
    """The accept kernel on CUDA tensors: (new_active, new_logp, accepted
    int32), as :func:`stretch_accept_reference` computes them on the plane
    ``philox_unit_uniforms(key, n, row0=row0)[1]``."""
    from mcmcpp_tpu_torch._build import load_library

    n, p = active.shape
    key = _check_key(key)
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    tensors = {"active": active, "proposal": proposal,
               "active_logp": active_logp, "lp_new": lp_new,
               "log_factor": log_factor}
    shapes = {"active": (n, p), "proposal": (n, p), "active_logp": (n,),
              "lp_new": (n,), "log_factor": (n,)}
    _check_args(tensors, shapes, active.device)
    lib = load_library()
    out_act = torch.empty_like(active)
    out_lp = torch.empty_like(active_logp)
    out_acc = torch.empty((n,), dtype=torch.int32, device=active.device)
    with torch.cuda.device(active.device):
        err = lib.mcmcpp_stretch_accept_f32(
            active.data_ptr(), proposal.data_ptr(), active_logp.data_ptr(),
            lp_new.data_ptr(), log_factor.data_ptr(), key,
            out_act.data_ptr(), out_lp.data_ptr(), out_acc.data_ptr(), n,
            row0, p, _stream(active.device),
        )
    _checked(err, "stretch_accept")
    return out_act, out_lp, out_acc


def kernel_unit_uniforms(key, n, device):
    """The (u, ue) planes as the kernels' own device function computes them
    on the card, written out by the library's debug entry point: for holding
    it against :func:`~mcmcpp_tpu_torch.ops.random.philox_unit_uniforms`.
    Nothing in the port reads these planes."""
    from mcmcpp_tpu_torch._build import load_library

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the kernels' uniforms are drawn on a CUDA "
                           f"device, not on {device}")
    key = _check_key(key)
    lib = load_library()
    u = torch.empty((n,), dtype=torch.float32, device=device)
    ue = torch.empty_like(u)
    with torch.cuda.device(device):
        err = lib.mcmcpp_unit_uniforms_f32(key, u.data_ptr(), ue.data_ptr(),
                                           n, _stream(device))
    if err != 0:
        raise RuntimeError(f"unit_uniforms kernel launch failed "
                           f"(cudaError {err})")
    return u, ue


def fused_stretch_half(active, active_logp, other, shift, u=None, ue=None, *,
                       key=None, logp_fn, a=2.0, row0=0):
    """One stretch half-step over rows row0…row0+n−1 of a half against the
    whole other half. Returns (new_active, new_logp, accepted int32). CPU
    tensors take the plain version on the planes ``u``, ``ue`` (the rows'
    own); CUDA tensors take ``key`` and launch the fused kernel (a
    GaussianTarget of P <= MAX_P), the wide kernel (a wider GaussianTarget)
    or the split kernels (any other logp, any P)."""
    row0 = int(row0)
    if active.device.type == "cpu":
        if key is not None or u is None or ue is None:
            raise TypeError("on a CPU tensor pass the planes u and ue, not "
                            "key (philox_unit_uniforms makes a key's planes)")
        return fused_stretch_half_reference(
            active, active_logp, other, shift, u, ue, logp_fn=logp_fn, a=a,
            row0=row0)
    if active.device.type != "cuda":
        raise RuntimeError(f"no fused stretch path for {active.device}")
    if u is not None or ue is not None:
        raise TypeError("on a CUDA tensor the stretch kernels draw u and ue "
                        "themselves: pass key, not planes")
    key = _check_key(key)
    _half_args(active, active_logp, other, shift, row0)
    p = active.shape[1]
    if isinstance(logp_fn, GaussianTarget):
        prec_chol = logp_fn.prec_chol
        _check_args({"prec_chol": prec_chol}, {"prec_chol": (p, p)},
                    active.device)
        launch = _launch_fused if p <= MAX_P else _launch_wide
        return launch(active, active_logp, other, shift, key, prec_chol, a,
                      row0)
    proposal, log_factor = stretch_propose(active, other, shift, key, a, row0)
    lp_new = logp_fn(proposal).contiguous()
    return stretch_accept(active, proposal, active_logp, lp_new, log_factor,
                          key, row0)
