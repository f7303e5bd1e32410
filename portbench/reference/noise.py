"""The half-steps' draws, worked out again from the run's seed.

The sampler under test is seeded with the run's seed. Its step generator (on
the ensemble's device) draws one partner shift a half-step; its host
generator (on the CPU) draws one 64-bit Philox key a half-step, red before
black in every step. Both are ``torch.Generator``s seeded with the first
word of ``numpy.random.SeedSequence([seed, stream])``, streams 0 and 2.
:class:`Replay` seeds its own pair the same way and draws in the same
order, so after skipping the half-steps a run took it yields the shift and
key of the next one.
"""

import numpy as np
import torch

STEP_STREAM = 0
HOST_STREAM = 2


def generator(seed, stream, device):
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


class Replay:
    """Shifts and keys of a sampler's half-steps on halves of ``m``
    walkers."""

    def __init__(self, seed, m, device):
        self.m = int(m)
        self.device = torch.device(device)
        self.step_gen = generator(seed, STEP_STREAM, self.device)
        self.host_gen = generator(seed, HOST_STREAM, "cpu")

    def _shift(self):
        return torch.randint(0, self.m, (1,), generator=self.step_gen,
                             device=self.device, dtype=torch.int32)

    def _key(self):
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=self.host_gen,
                               dtype=torch.int64).tolist()
        return (hi << 32) | lo

    def skip(self, half_steps):
        """Advance past ``half_steps`` half-steps (no host sync)."""
        for _ in range(int(half_steps)):
            self._shift()
            self._key()

    def next(self):
        """(shift as a Python int, key as a Python int) of the next
        half-step."""
        shift = self._shift()
        return int(shift.item()), self._key()
