"""Ensemble movers (torch): every mover of ``mcmcpp_tpu/movers``."""

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.movers.de import DifferentialEvolutionMove
from mcmcpp_tpu_torch.movers.diagnostic import AutoRegressiveMove, SequenceMove
from mcmcpp_tpu_torch.movers.dram import DRAMMove
from mcmcpp_tpu_torch.movers.fused import FusedStretchMove
from mcmcpp_tpu_torch.movers.mh import MetropolisHastingsMove
from mcmcpp_tpu_torch.movers.mixture import MixtureMover
from mcmcpp_tpu_torch.movers.slice import EnsembleSliceMove
from mcmcpp_tpu_torch.movers.snooker import DESnookerMove
from mcmcpp_tpu_torch.movers.stretch import StretchMove
from mcmcpp_tpu_torch.movers.walk import WalkMove

__all__ = [
    "Mover",
    "StretchMove",
    "WalkMove",
    "DifferentialEvolutionMove",
    "DESnookerMove",
    "MetropolisHastingsMove",
    "DRAMMove",
    "MixtureMover",
    "EnsembleSliceMove",
    "AutoRegressiveMove",
    "SequenceMove",
    "FusedStretchMove",
]
