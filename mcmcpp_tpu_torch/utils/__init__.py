"""Utility layer: observability/metrics (stand-in for the reference's
``MCMCpp/Utility`` grab-bag; its PRNG plumbing is ``ops/random.py``)."""

from mcmcpp_tpu_torch.utils.metrics import ThroughputMonitor, trace_profile

__all__ = ["ThroughputMonitor", "trace_profile"]
