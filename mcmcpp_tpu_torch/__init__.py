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
injected or disk-backed chain (``chain=``, :class:`DiskChain`; the C++ chain
arena of ``native``, built with ``g++`` at first use), checkpoint and
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

The multi-process layer (``parallel``): :class:`ShardedEnsembleSampler`
splits the walkers over the ranks of a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU) and equals the unsharded sampler bit for
bit; ``analysis.global_*`` and ``run_until_converged(multihost=True)`` take
the whole ensemble's statistics from the ranks' shards.
"""

from mcmcpp_tpu_torch import analysis
from mcmcpp_tpu_torch import dsl
from mcmcpp_tpu_torch import gradient
from mcmcpp_tpu_torch import io
from mcmcpp_tpu_torch import models
from mcmcpp_tpu_torch import ops
from mcmcpp_tpu_torch import parallel
from mcmcpp_tpu_torch.dsl import Model
from mcmcpp_tpu_torch.chain import Chain
from mcmcpp_tpu_torch.chain_disk import DiskChain
from mcmcpp_tpu_torch.convergence import ConvergenceReport, run_until_converged
from mcmcpp_tpu_torch.eks import (
    EKIResult,
    EKSResult,
    ensemble_kalman_inversion,
    ensemble_kalman_sampler,
)
from mcmcpp_tpu_torch.elliptical import EllipticalSliceSampler
from mcmcpp_tpu_torch.enkf import EnKFModel, ensemble_kalman_filter
from mcmcpp_tpu_torch.export import (
    ibis_to_inference_dict,
    nested_to_inference_dict,
    smc2_to_inference_dict,
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
from mcmcpp_tpu_torch.ibis import IBISSampler
from mcmcpp_tpu_torch.if2 import IF2Result, if2
from mcmcpp_tpu_torch.map_laplace import find_map, laplace, laplace_sample
from mcmcpp_tpu_torch.nested import NestedSampler
from mcmcpp_tpu_torch.neutra import IAF, NeuTra, RealNVP, SplineCoupling
from mcmcpp_tpu_torch.pathfinder import multi_pathfinder, pathfinder
from mcmcpp_tpu_torch.particle import (
    ParticleGibbsKernel,
    PMMHSampler,
    StateSpaceModel,
    particle_filter,
    particle_forecast,
    particle_smoother,
)
from mcmcpp_tpu_torch.parallel import (
    ShardedEnsembleSampler,
    make_ladder_mesh,
    make_walker_mesh,
)
from mcmcpp_tpu_torch.pcn import PCNSampler
from mcmcpp_tpu_torch.rbpf import (
    RaoBlackwellSSM,
    rao_blackwell_filter,
    rbpf_forecast,
    switching_model,
)
from mcmcpp_tpu_torch.sampler import EnsembleSampler, EnsembleState, sample_ball
from mcmcpp_tpu_torch.smc import SMCSampler
from mcmcpp_tpu_torch.smc2 import SMC2Sampler
from mcmcpp_tpu_torch.svgd import SVGD
from mcmcpp_tpu_torch.tempering import (
    ParallelTemperingSampler,
    geometric_ladder,
    power_ladder,
)
from mcmcpp_tpu_torch.ukf import (
    UKFModel,
    UKFResult,
    unscented_kalman_filter,
    unscented_rts_smoother,
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
    "EKIResult",
    "EKSResult",
    "EllipticalSliceKernel",
    "EllipticalSliceSampler",
    "EnKFModel",
    "EnsembleSampler",
    "EnsembleSliceMove",
    "EnsembleState",
    "ExactGibbsKernel",
    "FusedStretchMove",
    "GaussianInterweaveKernel",
    "GaussianMixture",
    "GaussianTarget",
    "HMCKernel",
    "HMCSampler",
    "IAF",
    "IBISSampler",
    "IF2Result",
    "InterweaveKernel",
    "LogisticRegression",
    "MALAKernel",
    "MALASampler",
    "MAMSSampler",
    "MCLMCSampler",
    "MEADSSampler",
    "MetropolisHastingsMove",
    "MixtureMover",
    "Model",
    "Mover",
    "NUTSSampler",
    "NealFunnel",
    "NestedSampler",
    "NeuTra",
    "PCNSampler",
    "PMMHSampler",
    "ParallelTemperingSampler",
    "ParticleGibbsKernel",
    "RWMKernel",
    "RaoBlackwellSSM",
    "RealNVP",
    "Rosenbrock",
    "SGHMCSampler",
    "SGLDSampler",
    "SMC2Sampler",
    "SMCSampler",
    "SVGD",
    "SequenceMove",
    "ShardedEnsembleSampler",
    "SplineCoupling",
    "StateSpaceModel",
    "StretchMove",
    "Target",
    "UKFModel",
    "UKFResult",
    "WalkMove",
    "analysis",
    "bayesian_linear_regression",
    "correlated_gaussian",
    "dsl",
    "ensemble_kalman_filter",
    "ensemble_kalman_inversion",
    "ensemble_kalman_sampler",
    "equicorrelated_gaussian",
    "find_map",
    "gaussian_mixture",
    "geometric_ladder",
    "gradient",
    "ibis_to_inference_dict",
    "if2",
    "io",
    "laplace",
    "laplace_sample",
    "logistic_regression",
    "make_ladder_mesh",
    "make_walker_mesh",
    "models",
    "multi_pathfinder",
    "neal_funnel",
    "nested_to_inference_dict",
    "ops",
    "parallel",
    "particle_filter",
    "particle_forecast",
    "particle_smoother",
    "pathfinder",
    "power_ladder",
    "rao_blackwell_filter",
    "rbpf_forecast",
    "rosenbrock",
    "run_until_converged",
    "sample_ball",
    "skewed_gaussian",
    "smc2_to_inference_dict",
    "switching_model",
    "to_arviz",
    "to_inference_dict",
    "unscented_kalman_filter",
    "unscented_rts_smoother",
]
