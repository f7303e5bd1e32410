"""MixtureMover: one mover per half-step, drawn from a weighted list.

PyTorch counterpart of ``mcmcpp_tpu/movers/mixture.py`` (emcee's
``moves=[(m, w)]``). JAX draws the branch on the device and runs it with
``lax.switch``; torch cannot branch on a device value without waiting for
it, so the branch index is drawn on the host, from the sampler's CPU
generator (``host_gen``, stream ``HOST_STREAM`` of the seed), and the chosen
mover's draws and update run on the device. The choice is independent of
the chain state, so the mixture kernel keeps detailed balance.
"""

import bisect

import numpy as np
import torch

from mcmcpp_tpu_torch.movers.base import Mover


class MixtureMover(Mover):
    """``movers``: list of (Mover, weight) or plain Movers (equal weights).
    ``noise`` is ``(idx, sub_noise)``: the branch as a Python int and the
    branch's own noise."""

    def __init__(self, movers):
        if not movers:
            raise ValueError("need at least one mover")
        pairs = [m if isinstance(m, tuple) else (m, 1.0) for m in movers]
        self.movers = [m for m, _ in pairs]
        w = np.asarray([float(wt) for _, wt in pairs])
        if np.any(w <= 0):
            raise ValueError("weights must be positive")
        self.weights = w / np.sum(w)
        self._cumulative = np.cumsum(self.weights).tolist()
        if any(m.always_accept for m in self.movers):
            raise ValueError("diagnostic (always-accept) movers cannot be mixed")

    def init_state(self, n_params, dtype, device):
        return tuple(m.init_state(n_params, dtype, device)
                     for m in self.movers)

    def draw_noise(self, gen, n, m, p, device, dtype=torch.float32,
                   host_gen=None):
        if host_gen is None or host_gen.device.type != "cpu":
            raise ValueError("MixtureMover draws its branch on the host: "
                             "pass host_gen, a CPU torch.Generator")
        u = float(torch.rand((), generator=host_gen, dtype=torch.float64))
        idx = min(bisect.bisect_right(self._cumulative, u),
                  len(self.movers) - 1)
        return idx, self.movers[idx].draw_noise(gen, n, m, p, device, dtype,
                                                host_gen=host_gen)

    def noise_rows(self, noise, row0, n):
        idx, sub_noise = noise
        return idx, self.movers[idx].noise_rows(sub_noise, row0, n)

    def apply(self, active, active_logp, other, logp_fn, state, noise,
              beta=1.0, row0=0, layout=None):
        idx, sub_noise = noise
        return self.movers[idx].apply(active, active_logp, other, logp_fn,
                                      state[idx], sub_noise, beta, row0=row0,
                                      layout=layout)
