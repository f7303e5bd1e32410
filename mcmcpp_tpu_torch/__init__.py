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

The gradient engines (``gradient``: HMC, NUTS, MALA, Barker, ChEES, MEADS,
MCLMC/MAMS, SGLD/SGHMC) run a batch of chains on the device with autograd
gradients of a batched logp; they need no hand kernel.

The population engines run plain torch ops too: parallel tempering
(``tempering``, the ladder as one vmapped half-step, with power-posterior
evidence), pCN (``pcn``), elliptical slice sampling (``elliptical``) and
blocked Gibbs with its eight conditional kernels (``gibbs``).

The evidence and variational engines: adaptive-tempering SMC (``smc``, four
mutations; its ensemble mutation with :class:`FusedStretchMove` runs the
split CUDA kernels around the tempered logp), nested sampling (``nested``),
the NeuTra flows (``neutra``: RealNVP, IAF, spline coupling, as
``nn.Module``s), ADVI (``vi``), SVGD (``svgd``), Pathfinder (``pathfinder``)
and MAP/Laplace (``map_laplace``, with a batched BFGS), trained with optax's
Adam (``optim``).

The log-probability DSL (``dsl``: transforms, distributions, :class:`Model`)
compiles declarative models to a per-θ logp for every engine, with the
special functions torch lacks in ``ops.special``; ``models.gp`` and
``models.hsgp`` hold the exact and reduced-rank Gaussian processes.
"""

from mcmcpp_tpu_torch import analysis
from mcmcpp_tpu_torch import dsl
from mcmcpp_tpu_torch import models
from mcmcpp_tpu_torch.dsl import Model
from mcmcpp_tpu_torch.chain import Chain
from mcmcpp_tpu_torch.chain_disk import DiskChain
from mcmcpp_tpu_torch.convergence import ConvergenceReport, run_until_converged
from mcmcpp_tpu_torch.elliptical import EllipticalSliceSampler
from mcmcpp_tpu_torch.export import (
    nested_to_inference_dict,
    to_arviz,
    to_inference_dict,
)
from mcmcpp_tpu_torch.gibbs import (
    BlockedGibbsSampler,
    CategoricalGibbsKernel,
    EllipticalSliceKernel,
    ExactGibbsKernel,
    GaussianInterweaveKernel,
    HMCKernel,
    InterweaveKernel,
    MALAKernel,
    RWMKernel,
)
from mcmcpp_tpu_torch.gradient import (
    BarkerSampler,
    CheesHMCSampler,
    HMCSampler,
    MALASampler,
    MAMSSampler,
    MCLMCSampler,
    MEADSSampler,
    NUTSSampler,
    SGHMCSampler,
    SGLDSampler,
)
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
from mcmcpp_tpu_torch.map_laplace import find_map, laplace, laplace_sample
from mcmcpp_tpu_torch.nested import NestedSampler
from mcmcpp_tpu_torch.neutra import IAF, NeuTra, RealNVP, SplineCoupling
from mcmcpp_tpu_torch.pathfinder import multi_pathfinder, pathfinder
from mcmcpp_tpu_torch.pcn import PCNSampler
from mcmcpp_tpu_torch.sampler import EnsembleSampler, EnsembleState, sample_ball
from mcmcpp_tpu_torch.smc import SMCSampler
from mcmcpp_tpu_torch.svgd import SVGD
from mcmcpp_tpu_torch.tempering import (
    ParallelTemperingSampler,
    geometric_ladder,
    power_ladder,
)
from mcmcpp_tpu_torch.vi import ADVI

__all__ = [
    "ADVI",
    "AutoRegressiveMove",
    "BarkerSampler",
    "BayesianLinearRegression",
    "BlockedGibbsSampler",
    "CategoricalGibbsKernel",
    "Chain",
    "CheesHMCSampler",
    "ConvergenceReport",
    "DESnookerMove",
    "DRAMMove",
    "DifferentialEvolutionMove",
    "DiskChain",
    "EnsembleSampler",
    "EnsembleSliceMove",
    "EnsembleState",
    "EllipticalSliceKernel",
    "EllipticalSliceSampler",
    "ExactGibbsKernel",
    "GaussianInterweaveKernel",
    "FusedStretchMove",
    "GaussianMixture",
    "GaussianTarget",
    "HMCKernel",
    "HMCSampler",
    "IAF",
    "InterweaveKernel",
    "LogisticRegression",
    "MALAKernel",
    "MALASampler",
    "MAMSSampler",
    "MCLMCSampler",
    "Model",
    "MEADSSampler",
    "MetropolisHastingsMove",
    "MixtureMover",
    "Mover",
    "NUTSSampler",
    "NealFunnel",
    "NestedSampler",
    "NeuTra",
    "PCNSampler",
    "ParallelTemperingSampler",
    "RWMKernel",
    "RealNVP",
    "Rosenbrock",
    "SGHMCSampler",
    "SGLDSampler",
    "SMCSampler",
    "SVGD",
    "SequenceMove",
    "SplineCoupling",
    "StretchMove",
    "Target",
    "WalkMove",
    "analysis",
    "bayesian_linear_regression",
    "correlated_gaussian",
    "dsl",
    "equicorrelated_gaussian",
    "find_map",
    "gaussian_mixture",
    "geometric_ladder",
    "laplace",
    "laplace_sample",
    "logistic_regression",
    "models",
    "multi_pathfinder",
    "neal_funnel",
    "nested_to_inference_dict",
    "pathfinder",
    "power_ladder",
    "rosenbrock",
    "run_until_converged",
    "sample_ball",
    "skewed_gaussian",
    "to_arviz",
    "to_inference_dict",
]
