"""mcmcpp_tpu_torch — the ensemble sampler of ``mcmcpp_tpu``, ported to
PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``mcmcpp_tpu`` is the reference and this package imports
nothing of it, nor JAX. Module names mirror the JAX package's. Targets are
``nn.Module``s, the device is explicit (``device=``, default "cuda", with no
CPU fallback), and randomness comes from explicit ``torch.Generator``s.

The one TPU kernel of the JAX package, the fused stretch half-step
(``mcmcpp_tpu/ops/pallas_stretch.py``), is a hand-written CUDA kernel here
(``csrc/fused_stretch.cu``), built with ``nvcc`` at first use.
"""

from mcmcpp_tpu_torch import analysis
from mcmcpp_tpu_torch.chain import Chain
from mcmcpp_tpu_torch.models.targets import (
    GaussianTarget,
    correlated_gaussian,
    equicorrelated_gaussian,
    skewed_gaussian,
)
from mcmcpp_tpu_torch.movers import FusedStretchMove, Mover, StretchMove
from mcmcpp_tpu_torch.sampler import EnsembleSampler, EnsembleState, sample_ball

__all__ = [
    "Chain",
    "EnsembleSampler",
    "EnsembleState",
    "FusedStretchMove",
    "GaussianTarget",
    "Mover",
    "StretchMove",
    "analysis",
    "correlated_gaussian",
    "equicorrelated_gaussian",
    "sample_ball",
    "skewed_gaussian",
]
