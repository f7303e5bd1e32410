"""Target distributions as ``nn.Module``s, the Gaussian-process layer
(``gp``: exact GPs; ``hsgp``: reduced-rank GPs) and the exact state-space
models (``lgss``: linear-Gaussian; ``hmm``: finite-state)."""

from mcmcpp_tpu_torch.models import gp
from mcmcpp_tpu_torch.models import hmm
from mcmcpp_tpu_torch.models import hsgp
from mcmcpp_tpu_torch.models import lgss
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

__all__ = [
    "gp",
    "hmm",
    "hsgp",
    "lgss",
    "BayesianLinearRegression",
    "GaussianMixture",
    "GaussianTarget",
    "LogisticRegression",
    "NealFunnel",
    "Rosenbrock",
    "Target",
    "bayesian_linear_regression",
    "correlated_gaussian",
    "equicorrelated_gaussian",
    "gaussian_mixture",
    "logistic_regression",
    "neal_funnel",
    "rosenbrock",
    "skewed_gaussian",
]
