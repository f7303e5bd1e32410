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
runs the same iterations) and :meth:`LadderLayout.gather_grid` (a
tempering grid's blocks as the whole ``(K, H, …)`` grid).
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist

from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.sampler import resolve_device

WALKER_AXES = ("hosts", "devices")
LADDER_AXES = ("ladder", "walkers")


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
        """Several ``(n_local, …)`` tensors of one dtype, each as its whole
        ``(n, …)`` in global order (contiguous): one all-gather of their
        rows side by side."""
        n = xs[0].shape[0]
        whole = self.gather(torch.cat([x.reshape(n, -1) for x in xs], 1))
        out, i = [], 0
        for x in xs:
            w = x[:1].numel()
            out.append(whole[:, i:i + w].reshape(
                (-1,) + tuple(x.shape[1:])).contiguous())
            i += w
        return tuple(out)

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


def _engine_rows(mesh, device, n, axis):
    """``(device, row0, n_local)`` of an engine with an axis of ``n`` rows
    (named ``axis`` in its errors): the whole axis on ``device`` ("cuda"
    when None) without a layout, else the layout's device (``device``, if
    given, must name it) and this rank's rows."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device), 0, n
    row0, n_local = mesh.rows(n, axis)
    return mesh.bind(device), row0, n_local


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
