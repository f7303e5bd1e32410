"""Gradient-based samplers (HMC, NUTS, MALA, Barker, ChEES, MEADS, MCLMC/MAMS,
SGLD/SGHMC), the PyTorch counterpart of ``mcmcpp_tpu.gradient``.

Every engine runs a batch of chains as one set of tensors; gradients come
from autograd on a batched logp ``(C, P) -> (C,)``; each transition splits
into ``draw_noise`` and a deterministic ``apply``.
"""

from mcmcpp_tpu_torch.gradient.barker import BarkerSampler, barker_kernel
from mcmcpp_tpu_torch.gradient.chees import CheesHMCSampler, chees_batch_step
from mcmcpp_tpu_torch.gradient.hmc import HMCSampler, hmc_kernel
from mcmcpp_tpu_torch.gradient.mala import MALASampler, mala_kernel
from mcmcpp_tpu_torch.gradient.mclmc import MAMSSampler, MCLMCSampler
from mcmcpp_tpu_torch.gradient.meads import MEADSSampler, ghmc_fold_step
from mcmcpp_tpu_torch.gradient.metric import (
    DenseMassMatrix,
    dense_mass_from_cov,
)
from mcmcpp_tpu_torch.gradient.nuts import NUTSSampler, nuts_kernel
from mcmcpp_tpu_torch.gradient.sgmcmc import SGHMCSampler, SGLDSampler

__all__ = [
    "BarkerSampler",
    "barker_kernel",
    "CheesHMCSampler",
    "chees_batch_step",
    "DenseMassMatrix",
    "dense_mass_from_cov",
    "HMCSampler",
    "hmc_kernel",
    "MALASampler",
    "mala_kernel",
    "MAMSSampler",
    "MCLMCSampler",
    "MEADSSampler",
    "ghmc_fold_step",
    "NUTSSampler",
    "nuts_kernel",
    "SGHMCSampler",
    "SGLDSampler",
]
