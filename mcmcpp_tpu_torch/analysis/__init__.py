"""Post-hoc chain analysis (counterpart of ``mcmcpp_tpu/analysis``, the
rebuild of ``MCMCpp/Analysis/``), under the JAX package's names. Not ported
yet: ``global_stats``, ``sbc``, ``bridge``, ``ksd``, ``scores``,
``model_compare``, ``power_scaling``, ``rstar``, ``importance``."""

from mcmcpp_tpu_torch.analysis.autocorr import autocorr_time, normalized_autocov
from mcmcpp_tpu_torch.analysis.streaming import StreamingACT, autocorr_time_streaming
from mcmcpp_tpu_torch.analysis.covariance import covariance_matrix, correlation_matrix
from mcmcpp_tpu_torch.analysis.histograms import CornerHistograms
from mcmcpp_tpu_torch.analysis.percentiles import PercentileAndMaximumFinder
from mcmcpp_tpu_torch.analysis.ess import (
    batch_means_ess,
    effective_sample_size,
    ess_bulk,
    ess_tail,
    min_ess_required,
    multivariate_ess,
)
from mcmcpp_tpu_torch.analysis.diagnostics import (
    mcse_quantile,
    nested_rhat,
    hdi,
    mcse_mean,
    potential_scale_reduction,
    ppc_pvalue,
    summary,
)

__all__ = [
    "batch_means_ess",
    "ess_bulk",
    "ess_tail",
    "multivariate_ess",
    "min_ess_required",
    "potential_scale_reduction",
    "mcse_mean",
    "mcse_quantile",
    "nested_rhat",
    "hdi",
    "ppc_pvalue",
    "summary",
    "autocorr_time",
    "autocorr_time_streaming",
    "StreamingACT",
    "normalized_autocov",
    "covariance_matrix",
    "correlation_matrix",
    "CornerHistograms",
    "PercentileAndMaximumFinder",
    "effective_sample_size",
]
