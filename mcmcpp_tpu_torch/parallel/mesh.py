"""Rank layouts for walker-sharded sampling.

Counterpart of ``mcmcpp_tpu/parallel/mesh.py``. JAX shards the walker axis
over a ``jax.sharding.Mesh`` of devices and lets GSPMD place the rows; here
each process of a ``torch.distributed`` group owns one device and a static,
equal run of walker rows of each half, and a layout says which: rank r of R
holds rows r·n/R … (r+1)·n/R − 1 of a half of n walkers. Walker updates cost
the same, so a static equal split is optimal (the reference's work stealing,
``RedBlkCtrlerSpinLock.h:119``, is unnecessary), and an uneven split is
refused.

``make_walker_mesh()`` and ``make_ladder_mesh(k)`` keep the JAX names and
return layouts of the default process group; ``WALKER_AXES`` and
``LADDER_AXES`` are the JAX axis names, kept as names only.

The engines' collectives sit on the layout: :meth:`WalkerLayout.gather`
(the ranks' rows of any ``(n_local, …)`` tensor as the whole ``(n, …)`` in
global order, one all-gather), :meth:`WalkerLayout.any`/:meth:`~WalkerLayout.
all` (a data-dependent loop's test, one MAX all-reduce, so that every rank
runs the same iterations), :meth:`LadderLayout.gather_grid` (a
tempering grid's blocks as the whole ``(K, H, …)`` grid) and, since the
variational and time-series engines, :meth:`WalkerLayout.sum` (JAX's
``psum``: the ranks' partial gradients of ADVI's ELBO and NeuTra's loss as
one all-reduce of the flat gradient; integer counts summed exactly).
:meth:`~WalkerLayout.gather_rows` carries several tensors of any dtypes (a
filter's particles beside its log weights, an RBPF's integer regimes beside
their Kalman moments) as their bytes, in one all-gather.

Who draws the noise. (a) Noise an engine draws itself (the proposals,
accept uniforms, resampling offsets, perturbations, initial draws and
prior draws of every engine) is drawn whole on every rank from the same
generator, which therefore stays in step on every rank, and each rank
keeps its rows: the sharded engine equals the unsharded one bit for bit
on any number of ranks. (b) Noise a user hook draws inside itself (a state-
space model's ``init_sample``, ``trans_sample`` and ``prop_sample``, an
RBPF's ``z_trans_sample``, an EnKF's forecast, PMMH's ``loglik_fn``) is
sized by the rows the hook is handed, so the unsharded rows cannot be
reproduced: :func:`hook_generator` gives those hooks the caller's generator
unchanged in a group of one (so a group of one still equals the unsharded
run bit for bit) and, over R > 1 ranks, a generator forked for the rank, so
that no two ranks propagate their rows on the same stream. Taking the fork
does not move the caller's generator, so the engine's own draws stay the
unsharded run's: with hooks that draw nothing, a sharded run equals the
unsharded one on any number of ranks. With drawn hook noise, a run over
R > 1 ranks is a different, equally valid Monte Carlo draw: unlike the JAX
package, whose keys are global and whose results do not depend on the
mesh, the port's results with drawn hook noise depend on R.
"""

from collections import OrderedDict
from dataclasses import dataclass

import torch
import torch.distributed as dist

from mcmcpp_tpu_torch.ops.random import make_generator
from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.sampler import resolve_device

WALKER_AXES = ("hosts", "devices")
LADDER_AXES = ("ladder", "walkers")
# the stream of a rank's hook generator (make_generator's streams 0-2 are
# the engines' own)
HOOK_STREAM = 3
# hook_generator's count of the forks taken from each generator, by id, for
# the _MAX_FORKED generators forked last (held, so that no other generator
# takes their ids; torch's generators take no weak references)
_FORKS = OrderedDict()
_MAX_FORKED = 64


class _Layout:
    """The collectives every layout shares: over all ``world_size`` ranks of
    the default group, on tensors on the layout's ``device``."""

    @property
    def size(self):
        """Ranks of the layout (JAX's ``Mesh.size``)."""
        return self.world_size

    def bind(self, device=None):
        """The device of an engine built on this layout: the layout's own.
        ValueError if the layout does not match the process group, or if
        ``device`` (the engine's argument) names another device."""
        if self.world_size != distributed.world_size():
            raise ValueError(
                f"the layout has {self.world_size} ranks, the process "
                f"group {distributed.world_size()}")
        if device is not None:
            dev = resolve_device(device)
            if dev.type != self.device.type or (
                    dev.index is not None and dev != self.device):
                raise ValueError(
                    f"a sampler on {dev} cannot run under a process group "
                    f"whose collectives run on {self.device} (NCCL takes "
                    "the card, gloo the CPU)")
        return self.device

    def stack(self, x):
        """Every rank's ``x`` (the same shape on each) stacked on a new
        leading axis in rank order: one all-gather (gloo's takes only a
        flat output, so the tensor travels flat; a bool as uint8)."""
        flag = x.dtype == torch.bool
        flat = (x.to(torch.uint8) if flag else x).reshape(-1).contiguous()
        out = flat.new_empty((self.world_size * flat.numel(),))
        distributed.all_gather_rows(out, flat)
        out = out.view((self.world_size,) + tuple(x.shape))
        return out.to(torch.bool) if flag else out

    def gather(self, x, dim=0):
        """The whole axis ``dim`` of ``x`` from every rank's run of it (rank
        r's rows follow rank r−1's), contiguous: one all-gather, also in a
        group of one."""
        stacked = self.stack(x.movedim(dim, 0))
        whole = stacked.reshape((-1,) + tuple(stacked.shape[2:]))
        return whole.movedim(0, dim).contiguous()

    def gather_rows(self, *xs):
        """Several ``(n_local, …)`` tensors of any dtypes, each as its whole
        ``(n, …)`` in global order (contiguous): one all-gather of their
        rows' bytes side by side (a bool travels as uint8)."""
        if len(xs) == 1:
            return (self.gather(xs[0]),)

        def as_bytes(x):
            x = x.to(torch.uint8) if x.dtype == torch.bool else x
            return x.contiguous().reshape(x.shape[0], -1).view(torch.uint8)

        whole = self.gather(torch.cat([as_bytes(x) for x in xs], 1))
        out, i = [], 0
        for x in xs:
            w = as_bytes(x[:1]).shape[1]
            dt = torch.uint8 if x.dtype == torch.bool else x.dtype
            part = whole[:, i:i + w].contiguous().view(dt).reshape(
                (-1,) + tuple(x.shape[1:]))
            out.append(part.to(torch.bool) if x.dtype == torch.bool
                       else part)
            i += w
        return tuple(out)

    def sum(self, x):
        """``x`` summed over the ranks (JAX's ``psum``), the same bits on
        every rank: one SUM all-reduce; in a group of one ``x`` itself (no
        arithmetic)."""
        if self.world_size == 1:
            return x
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    def any(self, flag):
        """True if ``flag`` (a bool tensor) has a True element on any rank:
        a MAX all-reduce of this rank's answer when there is more than one
        rank."""
        if self.world_size == 1:
            return bool(torch.any(flag))
        f = torch.any(flag).to(torch.int32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MAX)
        return bool(f)

    def all(self, flag):
        """True if every element of ``flag`` is True on every rank (the
        complement of :meth:`any` of its negation)."""
        return not self.any(~flag)


@dataclass(frozen=True)
class WalkerLayout(_Layout):
    """Rank ``rank`` of ``world_size`` processes, each with one ``device``,
    the walker axis split over all of them."""

    world_size: int
    rank: int
    device: torch.device
    axis_names = WALKER_AXES

    @property
    def shape(self):
        """Axis sizes by name: one process a host, one device a process."""
        return {"hosts": self.world_size, "devices": 1}

    def rows(self, n, axis=None):
        """``(row0, n_local)``: this rank's rows of an axis of n rows (a
        half of n walkers, or the engine's ``axis``, e.g. "n_chains");
        ValueError, in the JAX package's words, if they do not split
        evenly."""
        if n % self.world_size:
            if axis is None:
                raise ValueError(f"n_walkers/2 = {n} must be divisible by "
                                 f"the {self.world_size} ranks of the "
                                 "layout")
            raise ValueError(f"{axis}={n} not divisible by mesh size "
                             f"{self.world_size}")
        n_local = n // self.world_size
        return self.rank * n_local, n_local


@dataclass(frozen=True)
class LadderLayout(_Layout):
    """A ``(ladder, walkers)`` layout of ``world_size`` ranks: the
    temperature ladder split in ``n_ladder_shards`` and each replica's
    walkers over the ranks of a ladder shard."""

    n_ladder_shards: int
    world_size: int
    rank: int
    device: torch.device
    axis_names = LADDER_AXES

    def __post_init__(self):
        k = self.n_ladder_shards
        if k < 1 or self.world_size % k:
            raise ValueError(f"{self.world_size} ranks not divisible by {k} "
                             "ladder shards")

    @property
    def shape(self):
        k = self.n_ladder_shards
        return {"ladder": k, "walkers": self.world_size // k}

    @property
    def ladder_index(self):
        """This rank's shard of the ladder."""
        return self.rank // self.shape["walkers"]

    @property
    def walker_index(self):
        """This rank's shard of the walkers within its ladder shard."""
        return self.rank % self.shape["walkers"]

    def grid_rows(self, k, h):
        """``((k0, k_local), (h0, h_local))``: this rank's rungs of a ladder
        of k and its walkers of a half of h; ValueError, in the JAX
        package's words, if either does not split evenly."""
        kd, wd = self.n_ladder_shards, self.shape["walkers"]
        if k % kd:
            raise ValueError(f"ladder size {k} not divisible by the mesh's "
                             f"{kd} ladder shards")
        if h % wd:
            raise ValueError(f"half-ensemble size {h} not divisible by {wd} "
                             "walker shards")
        return ((self.ladder_index * (k // kd), k // kd),
                (self.walker_index * (h // wd), h // wd))

    def gather_grid(self, x):
        """The whole ``(K, H, …)`` grid from every rank's ``(K/kd, H/wd,
        …)`` block (rank r holds ladder shard r // wd, walker shard
        r % wd): one all-gather."""
        kd, wd = self.n_ladder_shards, self.shape["walkers"]
        stacked = self.stack(x).view((kd, wd) + tuple(x.shape))
        kn, hn, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
        return stacked.transpose(1, 2).reshape(
            (kd * kn, wd * hn) + rest).contiguous()


def own_rows(mesh, n, axis):
    """This rank's rows of an axis of ``n`` rows (named ``axis`` in its
    errors) as a slice: all of them without a layout; ValueError, in the
    JAX package's words, on an uneven split."""
    if mesh is None:
        return slice(0, n)
    row0, n_local = mesh.rows(n, axis)
    return slice(row0, row0 + n_local)


def _engine_device(mesh, device):
    """The device of an engine: ``device`` ("cuda" when None) without a
    layout, else the layout's (``device``, if given, must name it)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    return mesh.bind(device)


def _engine_rows(mesh, device, n, axis):
    """``(device, row0, n_local)`` of an engine with an axis of ``n`` rows:
    :func:`_engine_device` and the start and length of :func:`own_rows`
    (the rows are checked first, before any process group is asked)."""
    rows = own_rows(mesh, n, axis)
    return _engine_device(mesh, device), rows.start, rows.stop - rows.start


def gathered(mesh, *xs):
    """Every rank's rows of the rank's ``xs``, in global order (``xs``
    themselves without a layout): one all-gather."""
    return xs if mesh is None else mesh.gather_rows(*xs)


def summed_grad(mesh, obj, params):
    """(∂obj/∂params, obj) of a rank's share ``obj`` of an objective, summed
    over the ranks: one all-reduce of the flat gradient with ``obj``'s
    value beside it (no arithmetic in a group of one)."""
    grads = torch.autograd.grad(obj, params)
    flat = mesh.sum(torch.cat([g.reshape(-1) for g in grads]
                              + [obj.detach().reshape(1)]))
    out, i = [], 0
    for p in params:
        out.append(flat[i:i + p.numel()].view_as(p))
        i += p.numel()
    return out, flat[-1]


def hook_generator(mesh, gen):
    """The generator a user hook draws from under ``mesh`` (rule (b) of the
    module docstring): ``gen`` itself without a layout or in a group of
    one; over R > 1 ranks a generator on ``gen``'s device seeded from
    ``SeedSequence([w, HOOK_STREAM, rank, k])``. ``w`` is the next 62-bit
    word of ``gen``, read from a copy of its state, so ``gen`` does not
    move and the engine's own draws from it stay the unsharded run's; ``k``
    counts the forks taken from ``gen`` before (while it is among the 64
    generators forked last), so two calls on a ``gen`` that did not move
    between them still fork anew. Every rank makes the same calls, so
    ``w`` and ``k`` agree across the ranks. Reading ``w`` waits for the
    device of a CUDA generator."""
    if mesh is None or mesh.world_size == 1:
        return gen
    peek = torch.Generator(device=gen.device)
    peek.set_state(gen.get_state())
    w = int(torch.randint(0, 1 << 62, (1,), generator=peek,
                          device=gen.device))
    k = _FORKS.pop(id(gen), (gen, 0))[1]
    _FORKS[id(gen)] = (gen, k + 1)
    if len(_FORKS) > _MAX_FORKED:
        _FORKS.popitem(last=False)
    return make_generator(w, HOOK_STREAM, gen.device, mesh.rank, k)


def _group():
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call mcmcpp_tpu_torch.parallel.distributed."
            "initialize() first (a group of one needs no arguments)")
    return dist.get_world_size(), dist.get_rank(), distributed.group_device()


def make_walker_mesh():
    """The walker layout of the default process group."""
    return WalkerLayout(*_group())


def make_ladder_mesh(n_ladder_shards):
    """The ``(ladder, walkers)`` layout of the default process group, for a
    tempering ladder sharded in ``n_ladder_shards``."""
    return LadderLayout(int(n_ladder_shards), *_group())
