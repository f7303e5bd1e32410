"""Sharded (multi-process) ensemble runtime.

PyTorch counterpart of ``mcmcpp_tpu/parallel``, the replacement for the
reference's pthread parallel runtime (``MCMCpp/ParallelEnsembleSampler.h``,
``MCMCpp/Threading/``): the walker ensemble is split over the ranks of a
``torch.distributed`` process group, one device each, and the steps'
collectives are written out: an all-gather of the opposite half before each
half-step, and all-reduces for the acceptance counts and the slice move's
loop tests (``sharded.py``).
"""

from mcmcpp_tpu_torch.parallel import distributed
from mcmcpp_tpu_torch.parallel.mesh import (
    LADDER_AXES,
    WALKER_AXES,
    LadderLayout,
    WalkerLayout,
    make_ladder_mesh,
    make_walker_mesh,
)
from mcmcpp_tpu_torch.parallel.sharded import ShardedEnsembleSampler

__all__ = [
    "LADDER_AXES",
    "LadderLayout",
    "ShardedEnsembleSampler",
    "WALKER_AXES",
    "WalkerLayout",
    "distributed",
    "make_ladder_mesh",
    "make_walker_mesh",
]
