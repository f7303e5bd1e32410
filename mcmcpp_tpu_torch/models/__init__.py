"""Target distributions as ``nn.Module``s."""

from mcmcpp_tpu_torch.models.targets import (
    GaussianTarget,
    correlated_gaussian,
    equicorrelated_gaussian,
    skewed_gaussian,
)

__all__ = [
    "GaussianTarget",
    "correlated_gaussian",
    "equicorrelated_gaussian",
    "skewed_gaussian",
]
