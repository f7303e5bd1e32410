"""AR(1) autocorrelation-time oracle: the reference's AcTime test.

Mirrors the reference's ``test/sequential/AcTime/src/main.cpp``: run the
AutoRegressiveMove ensemble whose integrated autocorrelation time is
analytically (1+phi)/(1-phi) and compare the FFT/Sokal estimator to the
truth (phi -> tau: 0.8->9, 0.905->20, 0.9355->30, 0.9672->60, 0.99->200).
Exits non-zero when an estimate is more than ``--rtol`` from the truth.

Usage:
    python -m mcmcpp_tpu_torch.examples.actime [--device cuda|cpu] \
        [--walkers 100] [--steps 65536]
"""

import argparse
import sys

import numpy as np
import torch

from mcmcpp_tpu_torch import AutoRegressiveMove, EnsembleSampler, analysis
from mcmcpp_tpu_torch.ops.random import make_generator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walkers", type=int, default=100)
    ap.add_argument("--steps", type=int, default=65536)
    ap.add_argument("--rtol", type=float, default=0.12)
    args = ap.parse_args(argv)

    # ≙ test/sequential/AcTime/src/main.cpp:16-22
    phis = np.array([0.8, 0.905, 0.9355, 0.9672, 0.99])
    mover = AutoRegressiveMove(
        offsets=np.zeros(5), phis=phis, variances=np.ones(5)
    )
    s = EnsembleSampler(lambda t: torch.zeros_like(t[:, 0]),
                        n_walkers=args.walkers, n_params=5, seed=0,
                        mover=mover, batched=True, device=args.device)
    s.set_initial_walker_pos(mover.initial_positions(
        make_generator(1, 0, s.device), args.walkers, device=s.device))
    s.run_mcmc(args.steps)
    # the FFT runs on the device the samples lie on
    tau = np.atleast_1d(analysis.autocorr_time(
        torch.from_numpy(s.get_samples()).to(s.device)))
    print(f"{'phi':>8} {'true tau':>9} {'estimate':>9} {'rel err':>8}"
          f"   ({s.device})")
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
