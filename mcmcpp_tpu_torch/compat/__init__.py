"""Compatibility shims for other ecosystems' APIs."""

from mcmcpp_tpu_torch.compat.emcee import EnsembleSampler, State

__all__ = ["EnsembleSampler", "State"]
