"""Post-hoc chain analysis (counterpart of ``mcmcpp_tpu/analysis``, the
rebuild of ``MCMCpp/Analysis/``), under the JAX package's names and with its
``__all__`` (which leaves out ``rstar`` and the power-scaling names, imported
all the same). The
``global_*`` statistics are the single-process half of
``analysis/global_stats.py``: across processes they raise (ROADMAP A13)."""

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
from mcmcpp_tpu_torch.analysis.model_compare import (
    ElpdResult,
    compare,
    loo,
    pseudo_bma_weights,
    stacked_predictive_resample,
    stacking_weights,
    waic,
)
from mcmcpp_tpu_torch.analysis.scores import crps_ensemble, energy_score
from mcmcpp_tpu_torch.analysis.diagnostics import (
    mcse_quantile,
    nested_rhat,
    hdi,
    mcse_mean,
    potential_scale_reduction,
    ppc_pvalue,
    summary,
)
from mcmcpp_tpu_torch.analysis.bridge import BridgeResult, bridge_log_evidence
from mcmcpp_tpu_torch.analysis.rstar import rstar
from mcmcpp_tpu_torch.analysis.power_scaling import (
    PowerScaleResult,
    SensitivityResult,
    powerscale,
    powerscale_sensitivity,
)
from mcmcpp_tpu_torch.analysis.ksd import ksd, ksd_curve
from mcmcpp_tpu_torch.analysis.global_stats import (
    global_autocorr_time,
    global_batch_means_ess,
    global_correlation_matrix,
    global_covariance_matrix,
    global_effective_sample_size,
    global_ess_bulk,
    global_ess_tail,
    global_mcse_mean,
    global_multivariate_ess,
    global_rank_normalized_rhat,
    global_split_rhat,
    global_summary,
)
from mcmcpp_tpu_torch.analysis.sbc import (
    sbc_ecdf_band,
    sbc_model,
    sbc_ranks,
    sbc_summary,
    sbc_uniformity,
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
    "ksd",
    "ksd_curve",
    "crps_ensemble",
    "energy_score",
    "ElpdResult",
    "compare",
    "loo",
    "pseudo_bma_weights",
    "stacked_predictive_resample",
    "stacking_weights",
    "waic",
    "BridgeResult",
    "bridge_log_evidence",
    "global_autocorr_time",
    "global_batch_means_ess",
    "global_correlation_matrix",
    "global_covariance_matrix",
    "global_effective_sample_size",
    "global_ess_bulk",
    "global_ess_tail",
    "global_mcse_mean",
    "global_multivariate_ess",
    "global_rank_normalized_rhat",
    "global_split_rhat",
    "global_summary",
    "sbc_ecdf_band",
    "sbc_model",
    "sbc_ranks",
    "sbc_summary",
    "sbc_uniformity",
]
