"""FusedStretchMove: the stretch move as one fused half-step kernel.

Counterpart of ``mcmcpp_tpu/movers/fused.py``: the same transition as
:class:`~mcmcpp_tpu_torch.movers.stretch.StretchMove` in roll mode, run by
``ops/fused_stretch.py``. The Pallas version's ``tile`` and ``interpret``
options are gone: the tensors' device picks the CUDA kernels or the plain
version, and the logp picks the kernel, one of three routes:

- a :class:`~mcmcpp_tpu_torch.models.targets.GaussianTarget` (pass the
  module itself with ``batched=True``) of P <= 16: one launch a half-step of
  the fused kernel (``csrc/fused_stretch.cu``);
- a wider GaussianTarget: one launch a half-step of the wide kernel
  (``csrc/fused_stretch_wide.cu``: Y·L as 3xTF32 on the tensor cores, any
  P), by one of its kernels (``ops/fused_stretch.WIDE_ROUTES``): on an
  H100 to P = 117 a warp-specialised block an SM with L resident in shared
  memory (``wgmma``), to P = 296 the same on thread-block clusters, each
  block holding a column slice of L, to P = 784 a block an SM with its Y
  tile resident and L, split once a launch into scratch, streamed through a
  ring shared by a cluster's blocks (``wgmma``), to P = 2944 the product's
  K split over a thread-block cluster, each block with a k-slice of a
  128-row Y tile and its rows of L streamed, the partial products added in
  rank order through distributed shared memory (``wgmma``), and wider, at
  any P, Y formed once into scratch and streamed back beside L's stages,
  each multicast over a 4 × 2 cluster (``wgmma``); the ``mma.sync`` kernel
  with L streamed through shared memory is kept for a device whose blocks
  no ``wgmma`` plan fits;
- any other logp: the propose and accept kernels around the torch logp
  (``csrc/stretch_split.cu``).

The noise of a half-step, one format per device. The Pallas kernel seeded
the TPU's generator and drew its uniforms u and ue inside its body; the CUDA
kernels do the same with Philox words of a 64-bit key and the walker's index
(``csrc/stretch_common.cuh``). So ``draw_noise`` draws the shift, on the
ensemble's device, and one key per half-step, and:

- on a CUDA device the noise is ``(shift, key)`` and no plane of uniforms is
  ever drawn or stored;
- on the CPU the noise is ``(shift, u, ue)``, the planes that the kernels
  would draw from that key (``ops/random.py::philox_unit_uniforms``), and
  ``apply`` takes any such planes, which is how the tests hand the port the
  JAX package's own numbers.

The key is a Python int drawn from ``host_gen``, the sampler's CPU generator
(two 32-bit words in one draw), and reaches the kernel by value. That
choice keeps the half-step free of host syncs and of any extra device launch:
device words beside ``shift`` would cost one more small launch per half-step
on a path that is bound by the host's enqueue time, and the host generator
is already there for the mixture mover's branch. Distinct half-steps (red,
black, consecutive steps) get independent 64-bit keys, so a walker index
never meets the same key twice. What it costs: a CUDA graph of the step
bakes by-value arguments in when it is captured, so a captured step would
replay one key; graphs need the key as device words that a captured op
advances (a pointer argument, as ``shift`` is), which is a change to the
kernels' interface and to this method only.

Seeded runs of this mover give another stream than they did when the planes
came from ``torch.rand``; the distribution is the same.
"""

import torch

from mcmcpp_tpu_torch.movers.base import Mover
from mcmcpp_tpu_torch.ops.fused_stretch import fused_stretch_half
from mcmcpp_tpu_torch.ops.partner import distinct_shifts
from mcmcpp_tpu_torch.ops.random import draw_key, philox_unit_uniforms


class FusedStretchMove(Mover):
    """Stretch move through the fused kernel; ``noise`` is ``(shift, key)``
    on a CUDA device and ``(shift, u, ue)`` on the CPU, with u, ue uniform
    in [2^-25, 1) so that log(ue) is finite. A rank's rows of a sharded
    half-step keep the shift and the key (the kernels take the row offset)
    or their rows of the planes."""

    partner_mode = "roll"

    def __init__(self, a=2.0):
        self.a = float(a)

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        if n != m:
            raise ValueError(f"fused stretch requires equal halves "
                             f"(n={n}, m={m})")
        key_gen = gen if host_gen is None else host_gen
        if key_gen.device.type != "cpu":
            raise ValueError("FusedStretchMove draws its Philox key on the "
                             "host: pass host_gen, a CPU torch.Generator")
        shift = distinct_shifts(gen, m, 1, device)
        key = draw_key(key_gen)
        if torch.device(device).type != "cpu":
            return shift, key
        u, ue = philox_unit_uniforms(key, n, device)
        return shift, u.to(dtype), ue.to(dtype)

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0, row0=0, layout=None):
        if not (isinstance(beta, (int, float)) and float(beta) == 1.0):
            raise NotImplementedError(
                "FusedStretchMove does not support tempered acceptance "
                "(beta != 1); use StretchMove for parallel tempering"
            )
        if active.device.type == "cuda":
            shift, key = noise
            return fused_stretch_half(active, active_logp, other, shift,
                                      key=key, logp_fn=logp_fn, a=self.a,
                                      row0=row0)
        shift, u, ue = noise
        return fused_stretch_half(active, active_logp, other, shift, u, ue,
                                  logp_fn=logp_fn, a=self.a, row0=row0)
