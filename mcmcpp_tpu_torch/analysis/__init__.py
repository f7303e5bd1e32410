"""Chain analysis (torch)."""

from mcmcpp_tpu_torch.analysis.autocorr import autocorr_time, normalized_autocov

__all__ = ["autocorr_time", "normalized_autocov"]
