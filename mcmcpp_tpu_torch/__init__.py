"""mcmcpp_tpu_torch — the ensemble sampler of ``mcmcpp_tpu``, ported to
PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``mcmcpp_tpu`` is the reference and this package imports
nothing of it, nor JAX. Module names mirror the JAX package's. Targets are
``nn.Module``s, the device is explicit (``device=``, default "cuda", with no
CPU fallback), and randomness comes from explicit ``torch.Generator``s.

The one TPU kernel of the JAX package, the fused stretch half-step
(``mcmcpp_tpu/ops/pallas_stretch.py``), is hand-written CUDA here, built with
``nvcc`` at first use: one fused kernel for a Gaussian target
(``csrc/fused_stretch.cu``) and a propose/accept pair around any other torch
logp (``csrc/stretch_split.cu``).

Around the sampler: reduced-precision store tiers (``store_dtype=``), an
injected or disk-backed chain (``chain=``, :class:`DiskChain`), checkpoint and
resume (``io``), convergence-driven runs (:func:`run_until_converged`), the
Analysis layer (``analysis``), the writers (``io``), the emcee surface
(``compat.emcee``), the ArviZ export and the reference's three test programs
(``examples``).
"""

from mcmcpp_tpu_torch import analysis
from mcmcpp_tpu_torch.chain import Chain
from mcmcpp_tpu_torch.chain_disk import DiskChain
from mcmcpp_tpu_torch.convergence import ConvergenceReport, run_until_converged
from mcmcpp_tpu_torch.export import to_arviz, to_inference_dict
from mcmcpp_tpu_torch.models.targets import (
    BayesianLinearRegression,
    GaussianMixture,
    GaussianTarget,
    LogisticRegression,
    NealFunnel,
    Rosenbrock,
    Target,
    bayesian_linear_regression,
    correlated_gaussian,
    equicorrelated_gaussian,
    gaussian_mixture,
    logistic_regression,
    neal_funnel,
    rosenbrock,
    skewed_gaussian,
)
from mcmcpp_tpu_torch.movers import (
    AutoRegressiveMove,
    DESnookerMove,
    DifferentialEvolutionMove,
    DRAMMove,
    EnsembleSliceMove,
    FusedStretchMove,
    MetropolisHastingsMove,
    MixtureMover,
    Mover,
    SequenceMove,
    StretchMove,
    WalkMove,
)
from mcmcpp_tpu_torch.sampler import EnsembleSampler, EnsembleState, sample_ball

__all__ = [
    "AutoRegressiveMove",
    "BayesianLinearRegression",
    "Chain",
    "ConvergenceReport",
    "DESnookerMove",
    "DRAMMove",
    "DifferentialEvolutionMove",
    "DiskChain",
    "EnsembleSampler",
    "EnsembleSliceMove",
    "EnsembleState",
    "FusedStretchMove",
    "GaussianMixture",
    "GaussianTarget",
    "LogisticRegression",
    "MetropolisHastingsMove",
    "MixtureMover",
    "Mover",
    "NealFunnel",
    "Rosenbrock",
    "SequenceMove",
    "StretchMove",
    "Target",
    "WalkMove",
    "analysis",
    "bayesian_linear_regression",
    "correlated_gaussian",
    "equicorrelated_gaussian",
    "gaussian_mixture",
    "logistic_regression",
    "neal_funnel",
    "rosenbrock",
    "run_until_converged",
    "sample_ball",
    "skewed_gaussian",
    "to_arviz",
    "to_inference_dict",
]
