"""FusedStretchMove: the stretch move as one fused half-step kernel.

Counterpart of ``mcmcpp_tpu/movers/fused.py``: the same transition as
:class:`~mcmcpp_tpu_torch.movers.stretch.StretchMove` in roll mode, run by
``ops/fused_stretch.py``. The Pallas version's ``tile`` and ``interpret``
options are gone: the tensors' device picks the CUDA kernels or the plain
version, and the logp picks the kernel: one fused launch per half-step for
a :class:`~mcmcpp_tpu_torch.models.targets.GaussianTarget` (pass the module
itself with ``batched=True``), the propose and accept kernels around the
torch logp for any other.
"""

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.fused_stretch import fused_stretch_half
from mcmcpp_tpu_torch.ops.partner import distinct_shifts
from mcmcpp_tpu_torch.ops.random import unit_uniform


class FusedStretchMove(Mover):
    """Stretch move through the fused kernel; ``noise`` is ``(shift, u, ue)``
    with u, ue uniform in [2^-25, 1) so that log(ue) is finite."""

    def __init__(self, a=2.0):
        self.a = float(a)

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        if n != m:
            raise ValueError(f"fused stretch requires equal halves "
                             f"(n={n}, m={m})")
        return (distinct_shifts(gen, m, 1, device),
                unit_uniform(gen, n, dtype, device),
                unit_uniform(gen, n, dtype, device))

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0):
        if not (isinstance(beta, (int, float)) and float(beta) == 1.0):
            raise NotImplementedError(
                "FusedStretchMove does not support tempered acceptance "
                "(beta != 1); use StretchMove for parallel tempering"
            )
        shift, u, ue = noise
        return fused_stretch_half(active, active_logp, other, shift, u, ue,
                                  logp_fn=logp_fn, a=self.a)
