"""Multi-process initialization helpers.

Counterpart of ``mcmcpp_tpu/parallel/distributed.py``. JAX wires its
processes into one runtime and lets GSPMD insert the collectives; here every
process is one rank of a ``torch.distributed`` process group with one device,
and the collectives are written out (``parallel/sharded.py``,
``analysis/global_stats.py``).

Usage in each process, under ``torchrun`` (which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``) or alone::

    from mcmcpp_tpu_torch.parallel import distributed
    rank, world = distributed.initialize()
    s = ShardedEnsembleSampler(logp, n_walkers=2**22, n_params=P)

The process's device is ``cuda:{LOCAL_RANK or 0}`` and the group's backend
NCCL; gloo only when the caller names the CPU (``device="cpu"``). There is
no fallback: a failed NCCL init raises.

Chain storage: each rank's ``Chain`` holds its own walkers; combine them
with ``process_allgather`` (small results) or the collective
``analysis.global_*`` statistics.
"""

import contextlib
import os
import socket

import torch
import torch.distributed as dist

from mcmcpp_tpu_torch.sampler import resolve_device


def process_device(device=None):
    """This process's device: ``cuda:{LOCAL_RANK or 0}``, or ``device``
    (a "cuda" without an index takes ``LOCAL_RANK``'s)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    device = resolve_device(f"cuda:{local}" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    return device


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _address(coordinator_address, world):
    """``tcp://host:port`` from the argument, else from ``MASTER_ADDR`` and
    ``MASTER_PORT``, else (a group of one) localhost at a free port."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        if world != 1:
            raise ValueError(
                "a group of more than one process needs coordinator_address "
                "(host:port) or MASTER_ADDR/MASTER_PORT in the environment")
        coordinator_address = f"localhost:{_free_port()}"
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    return coordinator_address


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None):
    """Join this process to the default process group; returns
    ``(rank, world_size)``, as JAX returns ``(process_index,
    process_count)``.

    Arguments left out come from ``MASTER_ADDR``/``MASTER_PORT``, ``RANK``
    and ``WORLD_SIZE``; with none of them this process is a group of one.
    NCCL on ``cuda:{LOCAL_RANK or 0}`` (made the current device), gloo when
    ``device`` names the CPU. Idempotent: a process already in a group
    returns its rank and size.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = process_device(device)
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    rank = int(os.environ.get("RANK", 0) if process_id is None
               else process_id)
    world = int(os.environ.get("WORLD_SIZE", 1) if num_processes is None
                else num_processes)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=_address(coordinator_address, world),
        rank=rank, world_size=world, **kw)
    return rank, world


@contextlib.contextmanager
def process_group(device=None):
    """:func:`initialize` (from the environment, else a group of one) for
    the ``with`` block, which gets ``(rank, world_size)``; a group this call
    made is destroyed when the block ends."""
    made = not dist.is_initialized()
    try:
        yield initialize(device=device)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def world_size():
    """Processes in the default group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def group_device():
    """Where the default group's collectives run: the current CUDA device
    under NCCL, the CPU under gloo (and outside a group)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(out, tensor):
    """All-gather ``tensor`` from every rank into ``out``, concatenated on
    the leading axis in rank order (``all_gather_single`` where this
    torch has it, else its older name ``all_gather_into_tensor``)."""
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:
        gather = dist.all_gather_into_tensor
    gather(out, tensor)
    return out


def process_allgather(tensor):
    """Every rank's ``tensor`` (the same shape on each), stacked on a new
    leading axis in rank order, as numpy on every rank (JAX's
    ``process_allgather`` of a host-local value). Small results only
    (summaries, acceptance statistics): chains stay on their ranks."""
    t = torch.as_tensor(tensor).detach()
    if not dist.is_initialized():
        return t.cpu().numpy()[None]
    t = t.to(group_device())
    out = t.new_empty((dist.get_world_size() * t.numel(),))
    all_gather_rows(out, t.reshape(-1).contiguous())
    return out.reshape(-1, *t.shape).cpu().numpy()


def is_multihost():
    """True in a group of more than one process."""
    return world_size() > 1


__all__ = ["all_gather_rows", "group_device", "initialize", "is_multihost",
           "process_allgather", "process_device", "process_group",
           "world_size"]
