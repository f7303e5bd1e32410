"""Skewed-Gaussian sampling example: the reference's flagship test.

Mirrors the pipeline of the reference's
``test/sequential/SkewedGaussian/{StretchMove,WalkMove,DiffEvo,MH}/src/main.cpp``:
sample the 2-D skewed Gaussian (eps = 0.13, true covariance
[[1+eps, (1-eps)/2], [(1-eps)/2, (1+eps)/4]]) until
:func:`~mcmcpp_tpu_torch.convergence.run_until_converged` is satisfied (or
the step budget is spent), report acceptance, ACT, covariance/correlation,
corner histograms and percentiles beside the oracle, and write CSV outputs,
with the mover selected on the command line. Exits non-zero when the
covariance, the mean, the acceptance or the autocorrelation time is outside
its tolerance.

Usage:
    python -m mcmcpp_tpu_torch.examples.skewed_gaussian \
        [--mover fused|stretch|walk|de|mh|dram] [--device cuda|cpu] \
        [--walkers 320] [--steps 8000] [--thin 4] [--outdir out]
"""

import argparse
import sys

import numpy as np

from mcmcpp_tpu_torch import (
    DRAMMove, DifferentialEvolutionMove, EnsembleSampler, FusedStretchMove,
    MetropolisHastingsMove, StretchMove, WalkMove, analysis, skewed_gaussian,
)
from mcmcpp_tpu_torch.convergence import run_until_converged
from mcmcpp_tpu_torch.io import CsvEngine, DataWriter, HistMultiOutput, MatrixOutput

EPS = 0.13


def true_cov():
    return np.array([[1 + EPS, (1 - EPS) / 2], [(1 - EPS) / 2, (1 + EPS) / 4]])


# mover -> (constructor, covariance tolerance at the default run length)
MOVERS = {
    "fused": (lambda: FusedStretchMove(), 0.05),
    "stretch": (lambda: StretchMove(), 0.05),
    "walk": (lambda: WalkMove(n_samples=6), 0.12),
    "de": (lambda: DifferentialEvolutionMove(), 0.15),
    "mh": (lambda: MetropolisHastingsMove(covariance=true_cov(), scale=1.2),
           0.15),
    "dram": (lambda: DRAMMove(), 0.15),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mover", choices=MOVERS, default="fused")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walkers", type=int, default=320)
    ap.add_argument("--steps", type=int, default=8000,
                    help="step budget of the convergence-driven run")
    ap.add_argument("--thin", type=int, default=4)
    ap.add_argument("--burn", type=int, default=1000)
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args(argv)

    make, cov_atol = MOVERS[args.mover]
    s = EnsembleSampler(
        skewed_gaussian(EPS, device=args.device), n_walkers=args.walkers,
        n_params=2, seed=0, mover=make(), batched=True, device=args.device,
    )
    s.init_ball(np.zeros(2), scale=0.3)
    s.run_mcmc(args.burn, store=False)
    report = run_until_converged(
        s, max_steps=args.steps, check_every=max(args.steps // 4, 1),
        thin=args.thin, rhat_threshold=1.01,
    )

    samples = s.get_samples()
    flat = s.get_samples(flat=True)
    cov = analysis.covariance_matrix(samples, device=args.device)
    act = np.atleast_1d(analysis.autocorr_time(samples))
    acc = s.acceptance_fraction
    print(f"mover              : {args.mover} on {s.device}")
    print(f"convergence        : {report.reason} after {report.steps_run} "
          f"steps, {report.stored_steps} stored, rhat "
          f"{np.round(report.rhat, 4)}")
    print(f"acceptance fraction: {acc:.4f}")
    print(f"autocorr times     : {np.round(act, 2)} (stored-step units)")
    print(f"covariance         :\n{np.round(cov, 4)}")
    print(f"true covariance    :\n{np.round(true_cov(), 4)}")
    print(f"correlation        :\n"
          f"{np.round(analysis.correlation_matrix(samples, device=args.device), 4)}")
    pf = analysis.PercentileAndMaximumFinder().process_chain_data(samples)
    for p in (15.866, 50.0, 84.134):  # -1sigma, median, +1sigma
        vals = [pf.get_value_from_percentile(i, p) for i in range(2)]
        print(f"percentile {p:7.3f}%: {np.round(vals, 4)}")
    print(f"peaks              : "
          f"{np.round([pf.get_peak_location(i) for i in range(2)], 4)}")

    if args.outdir:
        ch = analysis.CornerHistograms(n_bins=100).calculate(samples)
        with DataWriter(CsvEngine(args.outdir)) as w:
            w.add(MatrixOutput("covariance", cov))
            w.add(HistMultiOutput("corner", ch))
        print(f"wrote CSV outputs to {args.outdir}/")

    failures = []
    if not np.allclose(cov, true_cov(), atol=cov_atol):
        failures.append(f"covariance off by more than {cov_atol}")
    if not np.allclose(flat.mean(axis=0), 0.0, atol=0.15):
        failures.append(f"mean {flat.mean(axis=0)} off by more than 0.15")
    if args.mover in ("fused", "stretch"):
        if not 0.6 < acc < 0.8:
            failures.append(f"acceptance {acc} outside (0.6, 0.8)")
        if not (np.all(act > 0) and np.all(act < 20)):
            failures.append(f"autocorrelation time {act} outside (0, 20)")
    for f in failures:
        print(f"FAILED: {f}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
