"""ShardedEnsembleSampler: the ensemble sampler with its walkers split over
the ranks of a ``torch.distributed`` process group.

Counterpart of ``mcmcpp_tpu/parallel/sharded.py`` (≙ the reference's
``MCMCpp/ParallelEnsembleSampler.h:78-357``, with none of its worker pool,
controller state machine or barriers). Everything about the API is
inherited; only data placement changes. JAX jits the unchanged step over a
mesh and GSPMD supplies three things, which are written out here:

- Gathers. Each rank holds ``(n_local, P)`` of red and of black (rank r:
  rows r·n_local… of each half), with their logps and int32 counters. A step
  makes two all-gathers into one preallocated ``(W/2, P)`` buffer: black
  before red proposes, then the *new* red before black proposes
  (``EnsembleSampler.h:350-354``). In a group of one the gather is the same
  call, a copy.
- Draws. Every rank draws the whole half's noise from generators seeded
  alike, in the unsharded order, and keeps its rows
  (:meth:`~mcmcpp_tpu_torch.movers.base.Mover.noise_rows`); the movers and
  kernels take the rows' global offset (``row0``), and the slice move's loop
  tests are all-reduced across the ranks. So a row gets the draws it gets
  unsharded, and a sharded run equals the unsharded one bit for bit at any
  rank count (where the logp's bits do not depend on the batch size).
- Counters. They stay local in the hot loop. ``accepted_steps`` and
  ``acceptance_fraction`` are summed across the ranks when read, and are the
  same on every rank; ``per_walker_accepted`` is the rank's own, in chain
  column order ``[red_local, black_local]``.

Each rank's :class:`~mcmcpp_tpu_torch.chain.Chain` holds its own walkers,
``(S, 2·n_local, P)`` in global column order; thinning, ``step_action`` and
``store_dtype`` behave as in the unsharded ``run_mcmc``.
``set_initial_walker_pos``/``init_ball`` take (or draw, from the shared seed)
the whole ensemble and keep the rank's rows. ``current_positions`` is the
rank's ``(2·n_local, P)``.

The sampler's device is the layout's (``cuda:{LOCAL_RANK or 0}`` under NCCL,
the CPU under gloo); a sampler on another device raises.
"""

import torch
import torch.distributed as dist

from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.parallel.mesh import make_walker_mesh
from mcmcpp_tpu_torch.sampler import (
    EnsembleSampler,
    EnsembleState,
    init_state,
)


def make_sharded_step_fn(batched_logp, mover, mover_state, gen, host_gen,
                         layout, gathered):
    """``step(state) -> state`` for a rank's rows: the step of
    :func:`~mcmcpp_tpu_torch.sampler.make_step_fn` with the opposite half
    all-gathered into ``gathered`` (W/2, P) before each half-step."""

    def half_step(active, active_logp, other_local):
        n_local, p = active.shape
        n = n_local * layout.world_size
        row0 = layout.rank * n_local
        noise = mover.draw_noise(gen, n, n, p, active.device,
                                 dtype=active.dtype, host_gen=host_gen)
        other = distributed.all_gather_rows(gathered, other_local)
        return mover.apply(active, active_logp, other, batched_logp,
                           mover_state, mover.noise_rows(noise, row0, n_local),
                           row0=row0, layout=layout)

    def step(state: EnsembleState) -> EnsembleState:
        red, logp_red, acc_r = half_step(state.red, state.logp_red,
                                         state.black)
        # black proposes against the *updated* red half
        black, logp_black, acc_b = half_step(state.black, state.logp_black,
                                             red)
        return EnsembleState(
            red, black, logp_red, logp_black,
            state.accepted_red + acc_r.to(torch.int32),
            state.accepted_black + acc_b.to(torch.int32),
            state.step + 1,
        )

    return step


class ShardedEnsembleSampler(EnsembleSampler):
    """EnsembleSampler whose walker axis is split over the ranks of a
    process group (``mesh``: a
    :class:`~mcmcpp_tpu_torch.parallel.mesh.WalkerLayout`, default
    :func:`~mcmcpp_tpu_torch.parallel.mesh.make_walker_mesh`).

    ``n_walkers/2`` must divide evenly by the rank count, so each rank owns
    an equal static shard (the uniform-cost analogue of the reference's
    dynamic work stealing, ``RedBlkCtrlerSpinLock.h:119``). Every rank must
    construct, initialize and run it collectively, with the same arguments.
    """

    def __init__(self, *args, mesh=None, device=None, **kwargs):
        self.mesh = mesh if mesh is not None else make_walker_mesh()
        super().__init__(*args, device=self.mesh.bind(device), **kwargs)
        self._row0, self._n_local = self.mesh.rows(self.n_walkers // 2)
        self._gathered = torch.empty((self.n_walkers // 2, self.n_params),
                                     dtype=self.dtype, device=self.device)
        self._step_fn = make_sharded_step_fn(
            self._batched_logp, self.mover, self._mover_state, self._step_gen,
            self._host_gen, self.mesh, self._gathered)

    def _local_walkers(self):
        return 2 * self.mesh.rows(self.n_walkers // 2)[1]

    def set_initial_walker_pos(self, positions):
        """The whole ensemble (W, P), the same on every rank; the rank keeps
        its rows of each half."""
        positions = torch.as_tensor(positions, dtype=self.dtype,
                                    device=self.device)
        if tuple(positions.shape) != (self.n_walkers, self.n_params):
            raise ValueError(
                f"positions shape {tuple(positions.shape)} != "
                f"({self.n_walkers}, {self.n_params})"
            )
        half, r0, n = self.n_walkers // 2, self._row0, self._n_local
        self.state = init_state(torch.cat([
            positions[r0:r0 + n], positions[half + r0:half + r0 + n]]),
            self._batched_logp)
        return self

    @property
    def accepted_steps(self):
        """Accepted walker moves of all ranks since the last reset (the same
        on every rank)."""
        local = torch.tensor([int(self.per_walker_accepted.sum())],
                             dtype=torch.int64,
                             device=distributed.group_device())
        if self.mesh.world_size > 1:
            dist.all_reduce(local)
        return int(local)
