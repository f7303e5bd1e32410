"""Target distributions as ``nn.Module``s, and the Gaussian-process layer
(``gp``: exact GPs; ``hsgp``: reduced-rank GPs)."""

from mcmcpp_tpu_torch.models import gp
from mcmcpp_tpu_torch.models import hsgp
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
    "hsgp",
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
