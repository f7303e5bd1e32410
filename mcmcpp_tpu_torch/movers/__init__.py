"""Ensemble movers (torch)."""

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.movers.fused import FusedStretchMove
from mcmcpp_tpu_torch.movers.stretch import StretchMove

__all__ = ["Mover", "StretchMove", "FusedStretchMove"]
