"""Cases shared by ``tests/test_torch_sharded.py`` and its two-process
workers: every mover and partner mode on an elementwise 3-D target, and the
runs both the sharded workers and the unsharded reference make. Imports
neither JAX nor the JAX package, so that a worker starts fast."""

import numpy as np
import torch

import mcmcpp_tpu_torch as mt


def logp3(x):
    """A correlated 3-D Gaussian in elementwise ops (batch-independent
    bits)."""
    a, b, c = x[:, 0], x[:, 1] - 0.5 * x[:, 0], x[:, 2]
    return -0.5 * (a * a + b * b / 0.3 + 2.0 * c * c)


# name: (a fresh mover, walkers per half); 512 takes block mode's
# block-granular path for k <= 4 partners (walk's 6 take the per-walker one)
MOVERS = {
    "stretch_roll": lambda: mt.StretchMove(),
    "stretch_block": lambda: mt.StretchMove(partner_mode="block"),
    "stretch_gather": lambda: mt.StretchMove(partner_mode="gather"),
    "walk_roll": lambda: mt.WalkMove(),
    "walk_block": lambda: mt.WalkMove(partner_mode="block"),
    "walk_gather": lambda: mt.WalkMove(partner_mode="gather"),
    "de_roll": lambda: mt.DifferentialEvolutionMove(),
    "de_block": lambda: mt.DifferentialEvolutionMove(partner_mode="block"),
    "de_gather": lambda: mt.DifferentialEvolutionMove(partner_mode="gather"),
    "snooker_block": lambda: mt.DESnookerMove(partner_mode="block"),
    "snooker_gather": lambda: mt.DESnookerMove(partner_mode="gather"),
    "mh_full": lambda: mt.MetropolisHastingsMove(
        covariance=np.array([[1.0, 0.3, 0.0], [0.3, 0.5, 0.1],
                             [0.0, 0.1, 0.8]]), scale=0.7),
    "dram": lambda: mt.DRAMMove(),
    "slice_roll": lambda: mt.EnsembleSliceMove(),
    "slice_gather": lambda: mt.EnsembleSliceMove(partner_mode="gather"),
    "mixture": lambda: mt.MixtureMover([
        (mt.StretchMove(), 0.5), (mt.DifferentialEvolutionMove(), 0.5)]),
    "ar": lambda: mt.AutoRegressiveMove([0.1, 0.0, -0.2], [0.5, 0.7, 0.9],
                                        [1.0, 2.0, 0.5]),
    "sequence": lambda: mt.SequenceMove([1e-3, 2e-3, -1e-3]),
    "fused_planes": lambda: mt.FusedStretchMove(),
}
HALF = 512


def skewed(x, eps=0.13):
    """The 2-D skewed Gaussian of ``tests/targets.py``, batched."""
    t1 = x[:, 0] / 2.0 - x[:, 1]
    t2 = x[:, 0] / 2.0 + x[:, 1]
    return -0.5 * (t1 * t1 / eps + t2 * t2)


def std_normal(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def sharded_case(cls, name):
    """One bitwise case of ``MOVERS``, run by ``cls`` (the sharded sampler
    in the workers, the unsharded one here): 2 × 512 walkers in 3-D, 20
    steps at thin 2 (the slice move 10)."""
    kw = {} if cls is mt.ShardedEnsembleSampler else {"device": "cpu"}
    s = cls(logp3, 2 * HALF, 3, mover=MOVERS[name](), seed=7, batched=True,
            **kw)
    s.init_ball(np.zeros(3), scale=0.5, seed=3)
    steps = 10 if name.startswith("slice") else 20
    assert s.run_mcmc(steps, thin=2)
    return s
