"""Target distributions as ``nn.Module``s."""

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
