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
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist

from mcmcpp_tpu_torch.parallel import distributed

WALKER_AXES = ("hosts", "devices")
LADDER_AXES = ("ladder", "walkers")


@dataclass(frozen=True)
class WalkerLayout:
    """Rank ``rank`` of ``world_size`` processes, each with one ``device``,
    the walker axis split over all of them."""

    world_size: int
    rank: int
    device: torch.device
    axis_names = WALKER_AXES

    @property
    def size(self):
        """Shards of the walker axis (JAX's ``Mesh.size``)."""
        return self.world_size

    @property
    def shape(self):
        """Axis sizes by name: one process a host, one device a process."""
        return {"hosts": self.world_size, "devices": 1}

    def rows(self, n):
        """``(row0, n_local)``: this rank's rows of a half of n walkers;
        ValueError if the halves do not split evenly."""
        if n % self.world_size:
            raise ValueError(f"n_walkers/2 = {n} must be divisible by the "
                             f"{self.world_size} ranks of the layout")
        n_local = n // self.world_size
        return self.rank * n_local, n_local

    def any(self, flag):
        """True if ``flag`` (a bool tensor) has a True element on any rank:
        a MAX all-reduce of this rank's answer when there is more than one
        rank."""
        if self.world_size == 1:
            return bool(torch.any(flag))
        f = torch.any(flag).to(torch.int32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MAX)
        return bool(f)


@dataclass(frozen=True)
class LadderLayout:
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
    def size(self):
        return self.world_size

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
