"""AR(1) autocorrelation-time oracle: the reference's AcTime test.

Mirrors the reference's ``test/sequential/AcTime/src/main.cpp``: run the
AutoRegressiveMove ensemble whose integrated autocorrelation time is
analytically (1+phi)/(1-phi) and compare the FFT/Sokal estimator to the
truth (phi -> tau: 0.8->9, 0.905->20, 0.9355->30, 0.9672->60, 0.99->200).
Exits non-zero when an estimate is more than ``--rtol`` from the truth.

``--sharded`` (≙ ``test/parallel/AcTime``) splits the walkers over the ranks
of a process group (``torchrun``, or a group of one), padded so that each
half divides by the rank count, and takes the whole ensemble's ACT with
``analysis.global_autocorr_time``.

Usage:
    python -m mcmcpp_tpu_torch.examples.actime [--device cuda|cpu] \
        [--walkers 100] [--steps 65536] [--sharded]
    torchrun --nproc_per_node=1 -m mcmcpp_tpu_torch.examples.actime --sharded
"""

import argparse
import contextlib
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import (
    AutoRegressiveMove,
    EnsembleSampler,
    ShardedEnsembleSampler,
    analysis,
)
from mcmcpp_tpu_torch.ops.random import make_generator
from mcmcpp_tpu_torch.parallel import distributed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walkers", type=int, default=100)
    ap.add_argument("--steps", type=int, default=65536)
    ap.add_argument("--rtol", type=float, default=0.12)
    ap.add_argument("--sharded", action="store_true",
                    help="split the walkers over the process group's ranks")
    args = ap.parse_args(argv)
    with (distributed.process_group(args.device) if args.sharded
          else contextlib.nullcontext()):
        return run(args)


def run(args):

    # ≙ test/sequential/AcTime/src/main.cpp:16-22
    phis = np.array([0.8, 0.905, 0.9355, 0.9672, 0.99])
    mover = AutoRegressiveMove(
        offsets=np.zeros(5), phis=phis, variances=np.ones(5)
    )
    cls, n_walkers = EnsembleSampler, args.walkers
    if args.sharded:  # pad so that each half divides by the rank count
        cls, step = ShardedEnsembleSampler, 2 * distributed.world_size()
        n_walkers = -(-n_walkers // step) * step
    s = cls(lambda t: torch.zeros_like(t[:, 0]), n_walkers=n_walkers,
            n_params=5, seed=0, mover=mover, batched=True, device=args.device)
    s.set_initial_walker_pos(mover.initial_positions(
        make_generator(1, 0, s.device), n_walkers, device=s.device))
    s.run_mcmc(args.steps)
    # the FFT runs on the device the samples lie on; sharded, every rank
    # holds its walkers and the ACT is the whole ensemble's
    samples = torch.from_numpy(s.get_samples()).to(s.device)
    tau = np.atleast_1d(analysis.global_autocorr_time(samples) if args.sharded
                        else analysis.autocorr_time(samples))
    print(f"{'phi':>8} {'true tau':>9} {'estimate':>9} {'rel err':>8}"
          f"   ({s.device}, {n_walkers} walkers on "
          f"{distributed.world_size()} rank(s))")
    worst = 0.0
    for p, t in zip(phis, tau):
        truth = (1 + p) / (1 - p)
        err = abs(t - truth) / truth
        worst = max(worst, err)
        print(f"{p:8.4f} {truth:9.2f} {t:9.2f} {err:8.2%}")
    if not worst <= args.rtol:
        print(f"FAILED: an estimate is more than {args.rtol:.0%} from the "
              "truth")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
