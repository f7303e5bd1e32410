"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # every phase
    python3 chip_smoke.py --phases 2b,11    # phase 1 and the phases named

Builds the port's CUDA kernels from ``mcmcpp_tpu_torch/csrc/`` (into
``build/kernels/``, one ``nvcc`` per source, all started together), then:

1. identifies the card (torch and CUDA versions, ``nvidia-smi`` name and
   power limit) and prints ``ptxas``'s register and shared-memory counts;
2. holds the fused stretch kernel against its plain PyTorch version on the
   card. The kernel draws its uniforms u and ue from a Philox key; the plain
   version gets the key's planes from the kernels' plain twin
   (``philox_unit_uniforms``), and the kernels' own u and ue, written out by
   a debug entry point, must equal the twin's bit for bit. Shapes: the main
   path's (n = 2^20 walkers per half, P = 10) and the edges (P = 2, 3, 7,
   13, 16; n = 50, 160, 1000; shifts 0, 1, n - 1, a wrap in the middle of a
   tile, a negative and an out-of-range shift; rows with lp_old = -inf);
   times both at the main path's shape. Then the wide kernel (a
   GaussianTarget wider than ``fs.MAX_P``): its routes from P = 100 to
   4096, one launch a half-step and no other, against its plain version at
   n = 2^20 and P = 65, 100 (its warp-specialised block), 128, 257 (thread-
   block clusters), 297, 384, 512 (L streamed), 800, 1000, 1536 (K split
   over a cluster) and 3000 (Y and L streamed, route 6) and at edge shapes
   and shifts (the routes' first and widest P, one past each, 3000 and
   4096), 4 row shards against one launch (at rows that are multiples of 4
   and at rows that are not), the old split route bit for bit against the
   plain version, the mma.sync kernel (which the dispatch no longer
   reaches) forced through a debug entry point against its plain version,
   and the kernel's time in turns beside its loads and stores alone (a
   debug entry point without the product), the plain version's and the
   split route's (route 6 also beside the forced mma.sync kernel), with the
   bytes and the product bounds apart, and the prologue alone of the routes
   that split L; and its main path, the samplers on GaussianTargets of
   P = 100, 257, 512, 1000 and 3000 at W = 2^21 in turns with the split
   route (walker-updates/s, acceptance within 4 binomial SE, stored rows
   at P = 100);
2b. holds the split path's propose and accept kernels (any torch logp)
   against their plain versions, each alone bit for bit: Neal's funnel at
   n = 2^20, P = 10 and at the edge shapes and shifts above, the Rosenbrock
   banana (P = 2), a logistic regression at ragged n = 1000, rows with
   lp_old = -inf (which accept), a logp that is NaN on some rows (which
   reject) and GaussianTargets of P = 65 and 100 passed as plain callables;
   times each kernel and the split half-step against the plain
   versions;
3. runs the flagship (10-D equicorrelated Gaussian, W = 2^21 walkers)
   through ``EnsembleSampler`` + ``FusedStretchMove``: 20 steps with no host
   sync allowed, three timed runs of 200 burn-in steps and 40 steps stored
   at thin 10, counting
   kernel launches, checking the stored logp and the acceptance, and timing
   the burn-in against the same steps through the plain version (which also
   pays for the twin's integer ops, so its time is a plain version's time
   and no yardstick);
4. samples the 2-D skewed Gaussian oracle through the fused kernel and
   checks acceptance, covariance and the autocorrelation time;
5. drives every other mover and partner mode at full width (W = 2^21,
   P = 10): 20 burn-in steps whose step loop runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no half-step may wait on the
   host; the slice move, which syncs by design, is the one exception), then
   2 stored steps; checks finite rows, the stored logp and the acceptance
   against a window taken from the JAX package; prints walker-updates/s,
   peak device memory and the slice move's loop iterations; then times
   roll, block and gather partners for the stretch and walk moves in turns;
6. runs the reference's oracles on the card: the skewed Gaussian with every
   mover, the Rosenbrock banana (BASELINE config #3) with the split-path
   fused stretch, walk and DE moves, the AR(1) autocorrelation-time table
   (AcTime), the deterministic sequence (InnerBenchmark) and a
   ``step_action`` run;
8. (before 7) the store, checkpoint and analysis path at the flagship's full
   width: a storing run under ``store_dtype=torch.bfloat16`` and one under
   ``float8_e4m3fn`` (rates with and without the store, the seconds inside
   ``Chain.append``, the stored bits against the state cast on the card and
   on the CPU, the refusal of an injected 8-bit-logp chain); bitwise resume
   from a checkpoint for the fused kernel, for the split kernels on Neal's
   funnel and with an injected ``DiskChain`` of bfloat16 rows (40 + 40 steps
   at thin 40 against 40, load, 40; the checkpoint's bytes and seconds);
   ``run_until_converged`` on the skewed Gaussian; the Analysis layer on a
   flagship chain (``covariance_matrix`` on the card against float64 numpy
   and against Σ, correlation, corner histograms, percentiles, summary,
   ESS) and the CSV and NPZ writers read back; the three example programs
   as subprocesses;
9. (before 7) the gradient engines, which run no hand kernel: (a) the repo's
   own configuration (``benchmarks/grad_bench.py``: the flagship's 10-D
   Gaussian, 1024 chains, 300 warmup steps or ``tune(300)``, 200 stored;
   NUTS 100 + 50 with either metric)
   for NUTS, ChEES, MEADS, MCLMC, MAMS, HMC, MALA and Barker, each with its
   transitions/s, gradient evaluations/s, worst-parameter ESS/s, host syncs
   per step and peak device memory, and its mean and covariance within 5
   Monte-Carlo standard errors of Σ (from the run's own ESS); (b) Bayesian
   logistic regression at the German-credit shape (N = 1000, P = 25,
   synthetic from a seed) with NUTS (150 + 200 steps) and ChEES (300 + 200)
   at 2^14 chains (R-hat < 1.01, their means within 5 MC standard errors of
   each other) and SGLD and SGHMC at 1024 chains on minibatches of 100
   rows, against the NUTS posterior; (c) bitwise resume of HMC at 2^14
   chains from a checkpoint;
10. (before 7) the population engines, which run no hand kernel: (a)
   parallel tempering, K = 16 geometric rungs of 2^17 walkers on the
   flagship's 10-D Gaussian (no host sync in the step loop, the cold chain's
   mean and covariance within 5 Monte-Carlo standard errors, every pair's
   swap rate above 0.05, walker-rung updates/s, peak memory) and the
   separated-mode oracle of ``tests/test_tempering.py`` (±8, K = 8, 2^14
   walkers started in one mode: the other mode's share within 5 SE of 1/2);
   (b) power mode on ``tests/test_evidence.py``'s conjugate model (K = 12,
   2^17 walkers: stepping stone within 0.1 and TI within 0.5 of the
   quadrature log Z); (c) pCN (after ``tune``) and elliptical slice on
   ``examples/function_space.py``'s GP latent at P = 1024, C = 4096
   (posterior means within 5 SE of the discretized model's closed form;
   acceptance, shrink iterations and host syncs a step, steps/s); (d)
   blocked Gibbs on ``tests/test_gibbs.py``'s hierarchical conjugate oracle
   at 2^14 chains (no host sync in a sweep but the slice loop's own tests;
   each block's time alone) and its mixture data augmentation at 2^12
   (against a quadrature of the means' posterior); (e) bitwise resume, 40 + 40 steps
   against 40, load, 40, for power-mode PT and the Gibbs sampler;
11. (before 7) the evidence and variational engines: (a) SMC on the 10-D
   conjugate Gaussian (prior N(0, 4I), likelihood N(1, I)) with 2^20
   particles, 10 mutation steps a stage and FusedStretchMove, whose
   half-steps (2^19 walkers) run the split kernels around the tempered logp:
   their launches on this path are counted (2·10 of each a stage) and both
   kernels are held bit for bit against their plain versions on a stage's
   inputs; log Z within 0.15 and the posterior mean and variance within
   the JAX test's bounds; a waste-free run (K = 7), HMC mutation on the
   10-D correlated model at 2^16 and flow mutation on the bimodal model at
   2^14, each with ``tests/test_smc_vi.py``'s bounds; (b) nested sampling
   on the same model, the stretch kernel at 4096 live points (batch 1024,
   30 steps) and the slice kernel at 1024 (5 directions): log Z within
   max(3·logz_err, 0.15), the n_calls identity; (c) NeuTra on Neal's
   funnel (10-D, RealNVP 6x64, 2000 fit steps of 1024), ChEES on the warped
   target with 4096 chains (v's mean and sd within
   ``tests/test_neutra.py``'s bounds), IAF and spline round trips on 2^16
   rows; (d) full-rank ADVI and SVGD (8192 particles, 500 steps: a 268 MB
   kernel and a median over 2^26 distances) on the flagship Gaussian; (e)
   ``multi_pathfinder`` (256 paths) and BFGS with 256 starts then
   ``laplace`` on the German-credit-shaped logistic regression and the
   Gaussian (Laplace exact there, 1e-4 relative); (f) bitwise resumes of
   SMC (stage by stage), nested sampling and NeuTra's fit, with each
   checkpoint's bytes and seconds. Every engine prints its rate, host
   syncs per stage or iteration and peak memory;
12. (before 7) the DSL, the GP models and the rest of the analysis layer:
   (a) a hierarchical Bayesian logistic regression at the German-credit
   shape (phase 9 (b)'s data, a HalfNormal scale over 25 coefficients)
   written in the DSL: its logp and gradient against the same posterior
   written by hand on 2^14 random points, ChEES on both at 2^14 chains
   (R-hat < 1.01, means within 5 MC standard errors of each other), and
   ``EnsembleSampler`` + ``FusedStretchMove`` at W = 2^20 on the DSL's
   vmapped logp, whose split kernels are counted (``launches_dsl_path``)
   and held bit for bit against their plain versions on one half-step's
   inputs; (b) eight schools through the ported example at 4096 chains
   against the JAX package's long run; (c) the exact GP's log marginal and
   lengthscale gradient at N = 4096 against float64 numpy/scipy,
   ``gram_cholesky``'s jitter level against JAX's on grams that escalate on
   the CPU, the HSGP's marginal and gradient at N = 2^17, m = 64; (d)
   ``global_stats`` on a (2000, 2^14, 10) chain on the card against the local
   functions, ``ksd``, bridge sampling on the 10-D conjugate Gaussian, the
   scoring rules against float64 numpy, and ``sbc_model`` with ChEES fits;
   after phase 7, the DSL's launches per logp evaluation under the profiler;
13. (before 7) the time-series layer at its users' widths, every check at the
   JAX tests' or examples' bounds: (a) the Kalman filter on a trend + weekly
   seasonal model (D = 8) over 2^16 steps with 5% missing, parallel against
   sequential and both against float64, the log-likelihood's gradient
   against central differences, 256 FFBS draws against the RTS smoother,
   the forecast, and the LGSSKernel Gibbs loop at 1024 chains; (b) an 8-state
   HMM over 2^14 steps (both forward passes, smoother, Viterbi, 1024
   posterior paths) and its Gibbs loop at 1024 chains; (c) on the
   stochastic-volatility model, the bootstrap filter at 2^18 particles over
   16 seeds, the fully adapted filter against Kalman, PMMH at 256 chains ×
   1024 particles, the smoother, forecast and PGAS; (d) the RBPF, (e) IF2
   against the Kalman MLE, (f) IBIS (grouped stages bitwise equal to
   per-stage ones) and SMC² against the exact evidence, (g) the EnKF and ETKF
   on Lorenz-96, (h) the UKF/URTS and EKI/EKS, (i) bitwise resumes of PMMH,
   IBIS and SMC²; the stretch kernels' launches on this path (0); after
   phase 7, the launches a time step costs under the profiler;
14. (before 7) (a) the eight later example programs (``dp_mixture``,
   ``tempering_and_dsl``, ``bayesian_workflow``, ``evidence``,
   ``function_space``, ``gp_hyperparams``, ``gp_latent``,
   ``gradient_inference``) at their default widths, their steps cut
   (``EX_*``), each with its wall time and gate values, the gates held where
   the cut keeps the program's own, in a process of their own started after
   phase 5 and run beside phases 6-13 (``--examples-child``; each phase it
   ran beside is marked so in its header, and its rates are not records:
   ``--phases`` without 14 runs a phase alone); (b) the native C++ chain
   arena (built with ``g++`` from the checkout) against
   the numpy backend on the flagship's rows (W = 2^21, P = 10, float32 and
   bfloat16): bit for bit on ``get``, ``get_logp``, ``iter_steps`` and
   ``compact``, and the seconds inside ``Chain.append`` for each; (c) a numpy
   flagship chain's ``autocorr_time`` on the card (timed beside
   ``device="cpu"``), its ``effective_sample_size`` on the card, and
   ``run_until_converged`` taking its ACT on the sampler's device; (d) the
   stretch kernels' launches on the examples' path (0);
15. (before 7) the sharded ensemble, in an NCCL process group of one:
   (a) the three kernels over 4 row shards of the flagship half (n = 2^20,
   P = 10; each launch on 2^18 rows with its offset ``row0`` against the
   whole other half), ``torch.equal`` to one launch, each shard held
   against its plain version (the split kernels bit for bit), and each
   kernel's time with the offset beside one launch and its bound; (b)
   ``ShardedEnsembleSampler`` against ``EnsembleSampler`` on the same seed
   bit for bit (20 + 40 steps at thin 10: the flagship with the fused
   kernel and with ``StretchMove``, the funnel with the split kernels, the
   slice move on the skewed Gaussian at W = 320), the kernels' launches on
   this sharded path, and the flagship's rate both ways in turns; after
   phase 7, the device time a sharded step spends in its all-gathers under
   the profiler; (c) ``actime`` and ``inner_benchmark`` with ``--sharded``;
16. (before 7) the engines with ``mesh=``, in the same NCCL group of one,
   at phases 9-11's widths with few steps: HMC, NUTS, ChEES, MEADS, SGLD and
   MCLMC at C = 1024, P = 10; PT at K = 16 × 2^17 on a walker layout and on
   a ladder layout of one shard; power PT; blocked Gibbs at 2^14 chains;
   pCN and the elliptical slice on the P = 1024 GP latent; SMC at 2^20
   particles with the ``FusedStretchMove`` mutation (the split kernels on
   the rank's rows); nested sampling at 4096 / 1024. Each sharded run
   first (the split kernels' launches on this path counted), then the
   unsharded one, equal by ``torch.equal`` (samples, logps, replicated
   statistics); then, in turns, host and device microseconds a step both
   ways and the collectives a sharded step makes;
17. (before 7) the variational and time-series engines with ``mesh=``, in
   the same NCCL group of one, at phases 11 and 13's widths with their T,
   steps or passes cut: full-rank ADVI (8192 draws) and SVGD (8192
   particles) on the flagship Gaussian, ``multi_pathfinder`` (256 paths) on
   the logistic regression, NeuTra on the funnel (batch 1024, HMC on 4096
   warped chains), the bootstrap filter (2^18 particles) and PMMH (256 ×
   1024) on the SV model, the RBPF (2^14), IF2 (2^16), IBIS (2^16), SMC²
   (1024 × 1024), the EnKF and ETKF on Lorenz-96 (1024 members), EKI and
   EKS (2^14). Each sharded run first (the stretch kernels' launches on
   this path counted: none), then the unsharded one, equal by
   ``torch.equal``; then, in turns, host and device microseconds a unit of
   work both ways and the collectives a sharded unit makes;
7. times 50 steps of the flagship and of Neal's funnel (wall time and the
   host's enqueue time per step) and takes a ``torch.profiler`` window over
   50 more of each: device time and launches per step by kernel; a flagship
   step must launch the fused kernel twice, a funnel step the propose and
   accept kernels twice each, and neither a ``uniform_`` kernel (nor the
   flagship a ``clamp_``), and a window over a storing run (bfloat16 rows):
   the casting row copies and the device-to-host copies beside the steps,
   and 20 PT steps of phase 10 (a) (launches and device time a step; no
   stretch kernel). Last, since the profiler's tracing slows every launch
   after it.

Any failure raises (non-zero exit); every phase prints its seconds. The
second-to-last lines are the kernel table (each kernel's launches on the
main path, the store path, the SMC path, the DSL path, the time-series path,
the examples' path, the sharded paths of phases 15, 16 and 17, its time
beside
its plain version's and its bound: its bytes, each input read once and each
output written once, over the card's 3.35 TB/s, or its operations over
67 TFLOP/s, whichever is larger) and the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``. With ``--phases`` the kernel
line, which needs every phase's launches, is left out. Without a CUDA device
the script raises before printing any result.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

# published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
# the dense TF32 rate of its tensor cores
PEAK_TF32_FLOP_PER_S = 495e12
# kernel vs plain version: logf/sqrtf against torch's ops and another
# summation order in the P×P product
RTOL = ATOL = 1e-5
# accept masks may differ only this close to the threshold
MARGIN = 1e-4
W_FULL = 1 << 21
P_FULL = 10
# fills of a 1 GiB buffer that a timed run of kernel calls queues up behind
BLOCKER_FILLS = 16
# burn-in steps at full width: the first WARM_FULL untimed (allocator growth,
# library handles), all of them with no host sync allowed
BURN_FULL = 20
WARM_FULL = 2
# acceptance over 20 burn-in + 2 stored steps from init_ball(0, 0.5) on the
# flagship (the funnel for fused_funnel), measured with the JAX package on
# the CPU at W = 4096, three seeds each (the same movers; StretchMove stands
# for FusedStretchMove, which JAX's mixture cannot hold): stretch block
# 0.434-0.440, gather 0.437-0.438; walk roll 0.0487-0.0492, gather
# 0.0483-0.0492; DE roll 0.329-0.334, block 0.330-0.334; snooker
# 0.394-0.398; MH 0.223-0.227; DRAM 0.662; mixture 0.380-0.410 (the branch
# draws vary); the funnel 0.469-0.472. The windows allow for W = 2^21 and
# another stream of draws.
ACCEPT_WINDOWS = {
    "stretch_block": (0.41, 0.47),
    "stretch_gather": (0.41, 0.47),
    "walk_roll": (0.035, 0.065),
    "walk_gather": (0.035, 0.065),
    "de_roll": (0.30, 0.36),
    "de_block": (0.30, 0.36),
    "snooker": (0.37, 0.42),
    "mh": (0.20, 0.25),
    "dram": (0.63, 0.69),
    "slice": (0.999, 1.0),
    "mixture": (0.30, 0.48),
    "fused_funnel": (0.44, 0.50),
}
SKEWED_COV = np.array([[1.13, 0.435], [0.435, 0.2825]])
# phase 6's burn-in on the skewed Gaussian (it and the steps cut twice to
# keep the script inside its time limit: at 500 burn-in steps and half the
# steps of the first cut the covariances stayed within 0.013 of the truth
# against gates of 0.12-0.15), and on the banana (its moments within 0.031
# of the gates' 0.12-0.5 at 2000 burn-in steps and twice the steps)
SKEWED_BURN = 300
BANANA_BURN = 1000
# phase 9's stochastic-gradient runs on the logistic target (N = 1000,
# B = 100): steps small beside the posterior's curvature (~250), so that the
# minibatch noise inflates the variance well inside tests/test_sgmcmc.py's
# 2.5x, and enough of them to mix from a start on the NUTS posterior
SGLD_STEP = 2e-5
SGHMC_STEP = 2e-6
SG_STEPS = 2000


# phase 14 (a)'s process while it runs beside the other phases
_EXAMPLES_CHILD = []
BESIDE_EXAMPLES = (" [beside phase 14 (a)'s programs, another process on this "
                   "card and host: its rates and times are not records; "
                   "--phases without 14 runs it alone]")


def examples_running():
    return any(c.poll() is None for c in _EXAMPLES_CHILD)


@contextmanager
def phase(name):
    """Print the phase's seconds when it ends (failures propagate), marked
    where phase 14 (a)'s programs ran beside it."""
    beside = examples_running()
    print(f"-- phase {name}{BESIDE_EXAMPLES if beside else ''}", flush=True)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    beside = beside or examples_running()
    print(f"-- phase {name}: {time.perf_counter() - t0:.1f} s"
          f"{BESIDE_EXAMPLES if beside else ''}", flush=True)


@contextmanager
def no_host_sync():
    """Raise on any operation that waits for the device."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def reset_launches(fs):
    for name in fs.LAUNCHES:
        fs.LAUNCHES[name] = 0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters, blocker, warmup=3):
    """Mean ms per call of ``fn`` between CUDA events, after ``warmup``
    calls, and the host's microseconds to enqueue one call. The calls queue
    up behind BLOCKER_FILLS fills of ``blocker`` (1 GiB: some 6 ms of
    device work), so the device runs them back to back and the time between
    the events is the device's, also when the host needs longer to enqueue
    a call than the device to run it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(BLOCKER_FILLS):
        blocker.zero_()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us


def in_turns(fns, iters, blocker, warmup=3):
    """Mean ms per call of each of ``fns``, timed in turns a, b, …, …, b, a
    on one card: (the means in the order given, each one's two readings,
    each one's mean host microseconds per enqueue)."""
    order = list(fns) + list(reversed(fns))
    times, host = {}, {}
    for f in order:
        ms, us = timed_ms(f, iters, blocker, warmup)
        times.setdefault(f, []).append(ms)
        host.setdefault(f, []).append(us)
    return ([sum(times[f]) / 2 for f in fns], [times[f] for f in fns],
            [sum(host[f]) / 2 for f in fns])


def device_rows_per_step(run, steps):
    """Device kernels and copies of ``run()`` (which takes ``steps`` sampler
    steps) by name, as {name: (launches per step, device microseconds per
    step)}, from a ``torch.profiler`` window. Fails if the profiler shows no
    device rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            n, us = rows.get(e.key, (0.0, 0.0))
            rows[e.key] = (n + e.count / steps, us + dev_us / steps)
    if not rows:
        raise AssertionError(
            "torch.profiler recorded no device rows, so the step's device "
            "launches cannot be counted")
    return rows


def random_chol(p, rng):
    a = rng.normal(size=(p, p))
    cov = a @ a.T / p + np.eye(p)
    return np.linalg.cholesky(np.linalg.inv(cov))


def bound_ms(n, p, row_arrays, vectors, ops_per_walker):
    """The least time the card could take for one call on n walkers of
    dimension p that moves ``row_arrays`` (n, p) arrays and ``vectors`` (n,)
    4-byte vectors, each once, and does ``ops_per_walker`` operations a
    walker: (ms, "bytes" or "operations"), whichever bounds it."""
    by_bytes = n * 4 * (row_arrays * p + vectors) / PEAK_BYTES_PER_S * 1e3
    by_ops = n * ops_per_walker / PEAK_FLOP_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def kernel_bounds(n, p):
    """Bounds of the three kernels as their interfaces are now (the uniforms
    are drawn in registers and move no byte). The fused kernel reads X and
    the partner rows and writes the row, plus lp_old, out_lp and out_acc; its
    operations are the P×P product, the proposal, the squares, and some 120
    for Philox's ten rounds, the logs and the square root. propose reads X
    and the partner rows and writes Y and the log factor. accept reads X and
    Y and writes the row, plus lp_old, lp_new, the factor, out_lp, out_acc."""
    return {"fused_stretch_half": bound_ms(n, p, 3, 3,
                                           2 * p * p + 5 * p + 120),
            "fused_stretch_wide": wide_bound_ms(n, p),
            "stretch_propose": bound_ms(n, p, 3, 1, 3 * p + 120),
            "stretch_accept": bound_ms(n, p, 3, 5, p + 120)}


def wide_bound_parts(n, p):
    """The wide half-step's two least times, in ms: its bytes (X, the
    partner and the output row, lp_old, out_lp, out_acc) over the memory
    rate, and its product kept at float32's accuracy (3xTF32: three TF32
    products of 2P² FLOP a walker) at the tensor cores' TF32 rate."""
    return (n * 4 * (3 * p + 3) / PEAK_BYTES_PER_S * 1e3,
            n * 3 * 2 * p * p / PEAK_TF32_FLOP_PER_S * 1e3)


def wide_bound_ms(n, p):
    """The wide half-step's least time, the longer of its two
    (``wide_bound_parts``). The same work whatever computes it, so no
    kernel reads above 100%."""
    by_bytes, by_ops = wide_bound_parts(n, p)
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def card_shift(n, shift):
    """Named shifts of the edge cases; "mid" wraps the partner run of a
    256-row tile at n in the middle of the tile."""
    named = {"last": n - 1, "mid": n - 100 if n > 100 else n // 2,
             "negative": -7, "beyond": 3 * n + 5}
    return named.get(shift, shift)


def half_inputs(fs_random, p, n, seed, neg_inf_every=0, lp_fn=None,
                shift=None, act_scale=0.5):
    """Active rows near the mode (``act_scale`` times standard normals),
    partners with every fourth row ×10 (far partners give rejections beside
    the accepts), lp_old (−inf on every ``neg_inf_every``-th row) and a
    shift on the card: the kernel's tensor arguments; then the Philox key
    and its planes (u, ue) from the plain twin."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    act = act_scale * torch.randn((n, p), generator=g, device=dev)
    other = torch.randn((n, p), generator=g, device=dev)
    other[::4] *= 10.0
    lp = lp_fn(act)
    if neg_inf_every:
        lp[::neg_inf_every] = -torch.inf
    drawn = torch.randint(0, n, (1,), generator=g, device=dev,
                          dtype=torch.int32)
    if shift is not None:
        drawn = torch.tensor([card_shift(n, shift)], dtype=torch.int32,
                             device=dev)
    key = (0x9E3779B97F4A7C15 * (seed + 1) + n * p) % (1 << 64)
    return (act, lp, other, drawn), key, fs_random.philox_unit_uniforms(
        key, n, dev)


def compare_half(label, k_out, r_out, log_ratio, ue, must_accept=None,
                 must_reject=None):
    """A kernel half-step against the plain one: accept masks equal except
    near the threshold, rows and logps within RTOL/ATOL. Returns the
    largest absolute difference."""
    k_act, k_lp, k_acc = k_out
    r_act, r_lp, r_acc = r_out
    n = k_acc.shape[0]
    n_acc = int(r_acc.sum())
    if not 0 < n_acc < n:
        raise AssertionError(f"{label}: {n_acc} accepts, need a mix")
    if must_accept is not None and not bool((k_acc[must_accept] == 1).all()):
        raise AssertionError(f"{label}: a row with lp_old = -inf rejected")
    if must_reject is not None and bool((k_acc[must_reject] != 0).any()):
        raise AssertionError(f"{label}: a row with a NaN logp accepted")
    near = ((log_ratio - torch.log(ue)).abs()
            < MARGIN * log_ratio.abs().clamp(min=1.0))
    same = k_acc == r_acc
    if not bool((same | near).all()):
        raise AssertionError(
            f"{label}: {int((~same & ~near).sum())} accept decisions differ "
            "away from the threshold"
        )
    torch.testing.assert_close(k_act[same], r_act[same], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(k_lp[same], r_lp[same], rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    err = max(float((k_act[same] - r_act[same]).abs().max()),
              float(torch.nan_to_num(k_lp[same] - r_lp[same],
                                     nan=0.0).abs().max()))
    print(f"  {label}: accepts {n_acc}/{n}, mask diffs {int((~same).sum())} "
          f"(all near threshold), max abs err {err:.3e}")
    return err


def kernel_case(fs, rnd, target, n, seed, neg_inf_every=0, shift=None,
                half=None, name="fused"):
    """Fused kernel (uniforms from the key) vs plain version (the key's
    planes) on one input set; ``half(*args, key)`` launches another kernel
    in its place (``name`` in the printed label). Returns (max_abs_err,
    tensor args, key, planes)."""
    args, key, (u, ue) = half_inputs(rnd, target.dim, n, seed, neg_inf_every,
                                     target, shift)
    if half is None:
        k_out = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    else:
        k_out = half(*args, key)
    torch.cuda.synchronize()
    r_out = fs.fused_stretch_half_reference(*args, u, ue, logp_fn=target)
    _, _, log_ratio = fs.stretch_proposal(*args, u, logp_fn=target)
    torch.cuda.synchronize()
    neg = slice(None, None, neg_inf_every) if neg_inf_every else None
    err = compare_half(f"{name} n={n} P={target.dim} shift={int(args[3])}",
                       k_out, r_out, log_ratio, ue, must_accept=neg)
    return err, args, key, (u, ue)


def split_case(fs, rnd, target, n, seed, neg_inf_every=0, nan_every=0,
               shift=None):
    """The split path (propose kernel, the torch logp, accept kernel) and
    each of its kernels alone against their plain versions on the key's
    planes. Both kernels round after every operation as torch's ops do, so
    each alone must equal its plain version bit for bit. Returns
    (max_abs_err, tensor args, key, planes)."""
    dev = torch.device("cuda")
    rows = torch.arange(n, device=dev)
    nan_rows = (rows % nan_every == 1) if nan_every else None

    def logp(x):
        out = target(x)
        return out if nan_rows is None else torch.where(nan_rows, torch.nan,
                                                        out)

    args, key, (u, ue) = half_inputs(rnd, target.dim, n, seed, neg_inf_every,
                                     target, shift)
    act, lp, other, shift = args
    before = dict(fs.LAUNCHES)
    k_out = fs.fused_stretch_half(*args, key=key, logp_fn=logp)
    torch.cuda.synchronize()
    counted = {k: fs.LAUNCHES[k] - before[k] for k in before}
    if counted != {"fused_stretch_wide": 0, "fused_stretch_half": 0,
                   "stretch_propose": 1,
                   "stretch_accept": 1}:
        raise AssertionError(f"split half-step launched {counted}")
    r_out = fs.fused_stretch_half_reference(*args, u, ue, logp_fn=logp)
    proposal, lp_new, log_ratio = fs.stretch_proposal(*args, u, logp_fn=logp)
    neg = slice(None, None, neg_inf_every) if neg_inf_every else None
    label = (f"split {getattr(target, 'name', 'gaussian')} n={n} "
             f"P={target.dim} shift={int(shift)}")
    err = compare_half(label, k_out, r_out, log_ratio, ue, must_accept=neg,
                       must_reject=nan_rows)
    # each kernel alone, on the plain path's own intermediates
    k_prop, k_fac = fs.stretch_propose(act, other, shift, key)
    r_prop, r_fac = fs.stretch_propose_reference(act, other, shift, u)
    k_acc_out = fs.stretch_accept(act, r_prop, lp, lp_new, r_fac, key)
    r_acc_out = fs.stretch_accept_reference(act, r_prop, lp, lp_new, r_fac,
                                            ue)
    alone = max(float((k_prop - r_prop).abs().max()),
                float((k_fac - r_fac).abs().max()),
                compare_half(label + " (accept alone)", k_acc_out, r_acc_out,
                             log_ratio, ue, must_accept=neg,
                             must_reject=nan_rows))
    if alone != 0.0 or not torch.equal(k_acc_out[2], r_acc_out[2]):
        raise AssertionError(f"{label}: a split kernel alone differs from "
                             f"its plain version (max abs err {alone})")
    return max(err, alone), args, key, (u, ue)


# the wide kernel (csrc/fused_stretch_wide.cu, phase 2): the widths it is
# checked and timed at (on an H100 P = 65 and 100 take its warp-specialised
# wgmma block, 128 and 257 its thread-block clusters of 2 and 8 blocks, 297,
# 384 and 512 its L-streamed route, 800, 1000 and 1536 its K-split route),
# with WIDE_TIMED_ITERS launches a reading; the routes from the sampler's
# width to WIDE_SCAN_TO (the L-streamed route from P = WIDE_LSTREAM_FROM,
# just past the widest P the cluster route takes, to the widest whose Y
# tile fits beside its rings, the K-split route from the next P to the
# widest whose Y slice fits a cluster of 8, route 6 (Y and L streamed) from
# the next P on, all found on the card; the mma.sync kernel at no width);
# route 6's widths (WIDE_YL_P: its first P on an H100, 3000 and 4096),
# timed at 2^20 with WIDE_YL_ITERS launches a reading (the plain version
# and the split route at 2^18 where 2^20 does not fit the card beside them,
# P = 4096), route 6 held to the plain version at 2^20 and over 4 row
# shards at WIDE_YL_SAMPLER_P, the mma.sync kernel forced
# (``fs.wide_forced_mma``) at WIDE_YL_SAMPLER_P; row offsets of shards that
# are not multiples of 4; and its main path, the sampler on GaussianTargets
# of P = 100, 257, 512, 1000 and 3000 at the flagship's W: burn-in steps a
# reading (WIDE_BURN, WIDE_YL_BURN at P = 3000; two readings a route, in
# turns with the split route's) and, at P = 100, the stored steps after
# them (a row of 2^21 walkers at P = 257 is 2.2 GB, past a chain's 2 GiB
# cap)
WIDE_P = (65, 100, 128, 257, 297, 384, 512, 800, 1000, 1536)
WIDE_TIMED_ITERS = 10
WIDE_ODD_SHARDS = (0, 262145, 524290, 786435)
WIDE_LSTREAM_FROM = 297
WIDE_KSPLIT_FROM = 785
WIDE_YL_FROM = 2945
WIDE_YL_P = (WIDE_YL_FROM, 3000, 4096)
WIDE_YL_ITERS = 1
WIDE_SCAN_TO = 4096
WIDE_SAMPLER_P, WIDE_BURN, WIDE_STORE, WIDE_THIN = 100, 20, 4, 2
WIDE_CLUSTER_SAMPLER_P = 257
WIDE_LSTREAM_SAMPLER_P = 512
WIDE_KSPLIT_SAMPLER_P = 1000
WIDE_YL_SAMPLER_P, WIDE_YL_BURN = 3000, 5


def launches_only(fs, **counts):
    """``fs.LAUNCHES`` as it must read when only ``counts`` were launched."""
    return {k: counts.get(k, 0) for k in fs.LAUNCHES}


def wide_kernel(mt, fs, rnd, card, blocker):
    """Phase 2's wide block: the wide kernel against its plain version at
    n = 2^20 and the edge cases (one launch a half-step, no split launch),
    at the L-streamed and K-split routes' first and widest P and one past
    each edge, route 6's first P and the next, 3000 and 4096, 4 row shards
    at offsets that are multiples of 4 and at offsets that are not against
    one launch, the old split route (propose, the torch logp, accept) bit
    for bit against the plain version, and the kernel's time beside the
    plain version's and the split route's and, on the wgmma routes, its
    loads alone (the debug entry without the product), in turns, with the
    bytes and the product bounds apart, and the prologue alone of the
    routes that split L; route 6 at P = 3000 and n = 2^20 against its plain
    version and over row shards, timed at its widths in turns with the
    mma.sync kernel (forced: the dispatch reaches it at no width), which
    is held to its plain version too; then its main path, the sampler at
    P = 100, at P = 257 (the cluster route), at P = 512 (the L-streamed
    route), at P = 1000 (the K-split route) and at P = 3000 (route 6) and
    W = 2^21 against the split route. Returns the kernel line's entry."""
    dev = torch.device("cuda")
    n = 1 << 20
    errs, by_p = [], {}

    def gauss(q):
        return mt.GaussianTarget(random_chol(q, np.random.default_rng(q)),
                                 device=dev)

    def split_route(target):
        # the same logp as a plain callable takes the split kernels, the
        # route a wide GaussianTarget took before the wide kernel
        return lambda x: target(x)

    def wide_case(target, n_case, seed, neg=0, shift=None):
        reset_launches(fs)
        err, args, key, planes = kernel_case(fs, rnd, target, n_case, seed,
                                             neg_inf_every=neg, shift=shift)
        if fs.LAUNCHES != launches_only(fs, fused_stretch_wide=1):
            raise AssertionError(f"a P={target.dim} half-step launched "
                                 f"{fs.LAUNCHES}")
        errs.append(err)
        return args, key, planes

    # the routes: the warp-specialised block to some P past the sampler's
    # width, then clusters (at 128 and 257 among them) to the widest P they
    # take, L streamed from the next P (at 384 and 512 among them) to the
    # widest whose Y tile fits beside its rings, K split over a cluster
    # from the next P (at 800 and 1000 among them) to the widest whose Y
    # slice fits a cluster of 8, route 6 (Y and L streamed) past it; the
    # mma.sync kernel (routes 1-2) at no width
    (ws_route, tile_route, streamed, cluster_route, lstream_route,
     ksplit_route, yl_route) = fs.WIDE_ROUTES
    scan = {q: fs.WIDE_ROUTES[fs.wide_layout(q, dev)["route"]]
            for q in range(WIDE_SAMPLER_P, WIDE_SCAN_TO + 1)}
    first = min(q for q, r in scan.items() if r == cluster_route)
    widest = max(q for q, r in scan.items() if r == cluster_route)
    l_widest = max(q for q, r in scan.items() if r == lstream_route)
    k_widest = max(q for q, r in scan.items() if r == ksplit_route)
    expect = {q: ws_route if q < first else
              cluster_route if q <= widest else
              lstream_route if q <= l_widest else
              ksplit_route if q <= k_widest else yl_route for q in scan}
    edges = (widest, widest + 1, widest + 2, widest + 3, widest + 4,
             l_widest, l_widest + 1, l_widest + 2, l_widest + 3,
             l_widest + 4, k_widest, k_widest + 1, k_widest + 2)
    routes = {q: fs.WIDE_ROUTES[fs.wide_layout(q, dev)["route"]]
              for q in (*WIDE_P, *edges, *WIDE_YL_P)}
    if (scan != expect or tile_route in scan.values()
            or streamed in scan.values()
            or any(routes[q] != yl_route for q in WIDE_YL_P)
            or widest + 1 != WIDE_LSTREAM_FROM
            or l_widest + 1 != WIDE_KSPLIT_FROM
            or k_widest + 1 != WIDE_YL_FROM
            or routes[128] != cluster_route
            or routes[WIDE_CLUSTER_SAMPLER_P] != cluster_route
            or routes[384] != lstream_route
            or routes[WIDE_LSTREAM_SAMPLER_P] != lstream_route
            or routes[800] != ksplit_route
            or routes[WIDE_KSPLIT_SAMPLER_P] != ksplit_route):
        raise AssertionError(f"wide kernel routes {routes}, the cluster "
                             f"route from P = {first} to {widest}, L "
                             f"streamed to {l_widest}, K split to "
                             f"{k_widest}: {scan}")
    print(f"  the wide kernel on this card: warp-specialised to P = "
          f"{first - 1}, the cluster route from P = {first} to {widest}, "
          f"L streamed from P = {widest + 1} to {l_widest}, K split from "
          f"P = {l_widest + 1} to {k_widest}, Y and L streamed from "
          f"P = {k_widest + 1} to {WIDE_SCAN_TO} (mma.sync at no P); "
          + ", ".join(f"P={q}: {fs.wide_layout(q, dev)['cluster']} blocks a "
                      f"cluster, {fs.wide_layout(q, dev)['active_clusters']} "
                      "clusters at once"
                      for q in (first, 128, 200, 257, widest, widest + 1,
                                384, 512, l_widest, l_widest + 1, 1000, 1536,
                                k_widest, k_widest + 1, WIDE_SCAN_TO))
          + f" [{card}]", flush=True)
    for q in (*edges[1:], *WIDE_YL_P[1:]):
        target = gauss(q)
        for n_case, neg, shift in [(1000, 7, "mid"), (4096, 5, "last")]:
            wide_case(target, n_case, seed=n_case + q, neg=neg, shift=shift)
    # the prologue alone (L split into its stages) of the L-streamed and
    # K-split routes
    prologue = {}
    for q in (widest + 1, 384, 512, l_widest, l_widest + 1, 1000, k_widest):
        prec = gauss(q).prec_chol
        prologue[q] = timed_ms(lambda: fs.wide_split_l(prec), 20, blocker)[0]
    print("  the L-streamed and K-split routes' prologue alone, ms: "
          + ", ".join(f"P={q} {ms:.4f}" for q, ms in prologue.items())
          + f" [{card}]", flush=True)

    for q in WIDE_P:
        target = gauss(q)
        for n_case, neg, shift in [(4096, 5, "last"), (1000, 7, "mid"),
                                   (300, 0, "mid"), (n, 0, "last")]:
            wide_case(target, n_case, seed=q + n_case, neg=neg, shift=shift)
        args, key, (u, ue) = wide_case(target, n, seed=q, neg=11)
        r_out = fs.fused_stretch_half_reference(*args, u, ue, logp_fn=target)
        # the old split route, bit for bit (its kernels round as torch does)
        reset_launches(fs)
        s_out = fs.fused_stretch_half(*args, key=key,
                                      logp_fn=split_route(target))
        torch.cuda.synchronize()
        if fs.LAUNCHES != launches_only(fs, stretch_propose=1,
                                        stretch_accept=1):
            raise AssertionError(f"P={q} split route launched {fs.LAUNCHES}")
        if not all(torch.equal(a, b) for a, b in zip(s_out, r_out)):
            raise AssertionError(f"P={q}: the split route is not its plain "
                                 "version bit for bit")
        whole = fs.fused_stretch_half(*args, key=key, logp_fn=target)
        m = n // 4
        act, lp, other, shift = args
        parts = [fs.fused_stretch_half(act[r0:r0 + m], lp[r0:r0 + m], other,
                                       shift, key=key, logp_fn=target,
                                       row0=r0) for r0 in range(0, n, m)]
        if not all(torch.equal(torch.cat([pt[k] for pt in parts]), whole[k])
                   for k in range(3)):
            raise AssertionError(f"P={q}: 4 row shards differ from one "
                                 "launch")
        # shards from rows that are not multiples of 4: runs off a 16-B
        # boundary at odd P
        bounds = (*WIDE_ODD_SHARDS, n)
        parts = [fs.fused_stretch_half(act[r0:r1], lp[r0:r1], other, shift,
                                       key=key, logp_fn=target, row0=r0)
                 for r0, r1 in zip(bounds[:-1], bounds[1:])]
        if not all(torch.equal(torch.cat([pt[k] for pt in parts]), whole[k])
                   for k in range(3)):
            raise AssertionError(f"P={q}: 4 row shards at rows "
                                 f"{WIDE_ODD_SHARDS} differ from one launch")
        calls = [
            lambda: fs.fused_stretch_half_reference(*args, u, ue,
                                                    logp_fn=target),
            lambda: fs.fused_stretch_half(*args, key=key,
                                          logp_fn=split_route(target)),
            lambda: fs.fused_stretch_half(*args, key=key, logp_fn=target)]
        if routes[q] in (ws_route, cluster_route, lstream_route,
                         ksplit_route):
            calls.append(lambda: fs.wide_loads_only(*args, key,
                                                    target.prec_chol))
        means, readings, _ = in_turns(calls, WIDE_TIMED_ITERS, blocker)
        plain_ms, split_ms, wide_ms = means[:3]
        loads_ms = means[3] if len(means) > 3 else None
        loads_text = (f"its loads and stores alone {loads_ms:.4f} "
                      f"({readings[3][0]:.4f}, {readings[3][1]:.4f}), "
                      if loads_ms is not None else "")
        bound, bound_by = wide_bound_ms(n, q)
        bytes_ms, product_ms = wide_bound_parts(n, q)
        by_p[q] = {"ms": wide_ms, "plain_ms": plain_ms,
                   "split_route_ms": split_ms, "loads_only_ms": loads_ms,
                   "bound_ms": bound, "bound_by": bound_by,
                   "bytes_bound_ms": bytes_ms,
                   "product_bound_ms": product_ms,
                   "layout": fs.wide_layout(q, dev)}
        loads_share = (f" (the loads alone {bytes_ms / loads_ms:.0%} of the "
                       "bytes bound)" if loads_ms is not None else "")
        print(f"  wide n=2^20 P={q}, ms per half-step (in turns): wide "
              f"{wide_ms:.4f} ({readings[2][0]:.4f}, {readings[2][1]:.4f}), "
              f"{loads_text}plain {plain_ms:.4f}, old split "
              f"route {split_ms:.4f} (bit for bit the plain version); bound "
              f"{bound:.4f} ({bound_by}; bytes {bytes_ms:.4f}, 3xTF32 product "
              f"{product_ms:.4f}), {bound / wide_ms:.0%} of it{loads_share}; "
              f"4 row shards == one launch, at rows {WIDE_ODD_SHARDS} too; "
              f"{routes[q]}, {by_p[q]['layout']} [{card}]", flush=True)
        del args, u, ue, r_out, s_out, whole, parts, act, lp, other
        torch.cuda.empty_cache()

    errs.append(wide_yl(fs, rnd, gauss, card, blocker, by_p, prologue))

    # the main path: the sampler on a P = 100 GaussianTarget (the
    # warp-specialised route), on a P = 257 one (the cluster route), on a
    # P = 512 one (the L-streamed route), on a P = 1000 one (the K-split
    # route) and on a P = 3000 one (route 6; a new sampler a reading: two
    # ensembles of 25 GB and the split route's intermediates do not fit the
    # card at once)
    runs = {q: wide_sampler(mt, fs, gauss(q), q, card, store=store,
                            burn=burn, fresh=fresh)
            for q, store, burn, fresh in (
                (WIDE_SAMPLER_P, True, WIDE_BURN, False),
                (WIDE_CLUSTER_SAMPLER_P, False, WIDE_BURN, False),
                (WIDE_LSTREAM_SAMPLER_P, False, WIDE_BURN, False),
                (WIDE_KSPLIT_SAMPLER_P, False, WIDE_BURN, False),
                (WIDE_YL_SAMPLER_P, False, WIDE_YL_BURN, True))}
    main = by_p[WIDE_SAMPLER_P]
    launches = sum(r["launches"] for r in runs.values())
    steps = sum(r["steps"] for r in runs.values())
    return {"source": "mcmcpp_tpu_torch/csrc/fused_stretch_wide.cu",
            "max_abs_err": max(errs), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "launches": launches,
            "launches_per_step": launches / steps,
            "launches_by_p": {q: r["launches"] for q, r in runs.items()},
            "p": WIDE_SAMPLER_P,
            "split_route_ms": main["split_route_ms"],
            "walker_updates_per_s": runs[WIDE_SAMPLER_P]["rates"]["wide"],
            "split_route_walker_updates_per_s":
                runs[WIDE_SAMPLER_P]["rates"]["split"],
            "sampler_by_p": runs, "by_p": by_p, "prologue_ms": prologue}


def wide_yl_full(fs, rnd, target, chunked, card):
    """Route 6 at WIDE_YL_SAMPLER_P and n = 2^20 against its plain version,
    2^18 rows at a time, and 4 row shards against one launch (at rows that
    are and are not multiples of 4); returns the errors against the plain
    version. Its own function, so that the 2^20 rows' tensors are freed
    when it returns."""
    n, q = 1 << 20, WIDE_YL_SAMPLER_P
    errs = []
    args, key, (u, ue) = half_inputs(rnd, q, n, q, 11, chunked(target))
    act, lp, other, shift = args
    reset_launches(fs)
    whole = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    torch.cuda.synchronize()
    if fs.LAUNCHES != launches_only(fs, fused_stretch_wide=1):
        raise AssertionError(f"a P={q} half-step launched {fs.LAUNCHES}")
    chunk = 1 << 18
    for r0 in range(0, n, chunk):
        rows = slice(r0, r0 + chunk)
        part = (act[rows], lp[rows], other, shift)
        r_out = fs.fused_stretch_half_reference(*part, u[rows], ue[rows],
                                                logp_fn=target, row0=r0)
        log_ratio = fs.stretch_proposal(*part, u[rows], logp_fn=target,
                                        row0=r0)[2]
        errs.append(compare_half(
            f"route 6 n=2^20 P={q} rows {r0}…{r0 + chunk - 1}",
            tuple(k[rows] for k in whole), r_out, log_ratio, ue[rows],
            must_accept=slice(-r0 % 11, None, 11)))
    for bounds in ((0, n // 4, n // 2, 3 * n // 4, n), (*WIDE_ODD_SHARDS, n)):
        parts = [fs.fused_stretch_half(act[r0:r1], lp[r0:r1], other, shift,
                                       key=key, logp_fn=target, row0=r0)
                 for r0, r1 in zip(bounds[:-1], bounds[1:])]
        if not all(torch.equal(torch.cat([pt[k] for pt in parts]), whole[k])
                   for k in range(3)):
            raise AssertionError(f"P={q}: 4 row shards at rows "
                                 f"{bounds[:-1]} differ from one launch")
        del parts
    print(f"  route 6 n=2^20 P={q}: held to the plain version in chunks of "
          f"2^18 rows; 4 row shards == one launch, at rows {WIDE_ODD_SHARDS} "
          f"too [{card}]", flush=True)
    return errs


def wide_yl(fs, rnd, gauss, card, blocker, by_p, prologue):
    """Route 6 (Y and L streamed) beyond the edge cases: the mma.sync
    kernel, which the dispatch no longer reaches, forced and held to its
    plain version at WIDE_YL_SAMPLER_P (n = 1000 and 4096); route 6 there
    at n = 2^20 against its plain version (row chunks of 2^18: the plain
    version of the whole half beside the kernel's outputs would not fit
    the card) and 4 row shards at offsets that are multiples of 4 and
    that are not against one launch; and its time at WIDE_YL_P, n = 2^20,
    in turns with its loads alone, its prologue alone, the mma.sync kernel
    forced and, where they fit the card beside the inputs (not at P =
    4096, whose plain version and split route are timed at 2^18 in turns
    with route 6 there), the plain version and the split route, with the
    bytes and the product bounds apart. Fills ``by_p`` and ``prologue``;
    returns the largest error against a plain version."""
    dev = torch.device("cuda")
    n = 1 << 20
    q = WIDE_YL_SAMPLER_P
    target = gauss(q)
    errs = []

    def chunked(target):
        # the target's logp 2^18 rows at a time: at P = 4096 the whole
        # half's Y·L and its squares beside the inputs would not fit
        return lambda x: torch.cat([target(c) for c in x.split(1 << 18)])

    def forced(*args):
        return fs.wide_forced_mma(*args, target.prec_chol)

    for n_case, neg, shift in [(1000, 7, "mid"), (4096, 5, "last")]:
        reset_launches(fs)
        err = kernel_case(fs, rnd, target, n_case, seed=n_case + q + 1,
                          neg_inf_every=neg, shift=shift, half=forced,
                          name="mma.sync forced")[0]
        if fs.LAUNCHES != launches_only(fs):
            raise AssertionError(f"the forced mma.sync kernel counted "
                                 f"{fs.LAUNCHES}")
        errs.append(err)

    errs.extend(wide_yl_full(fs, rnd, target, chunked, card))

    for q in WIDE_YL_P:
        target = gauss(q)
        prec = target.prec_chol
        fits = q <= WIDE_YL_SAMPLER_P
        turns = []
        for log2n in (20,) if fits else (20, 18):
            args, key, (u, ue) = half_inputs(rnd, q, 1 << log2n, q, 0,
                                             chunked(target))
            calls = {"wide": lambda: fs.fused_stretch_half(
                *args, key=key, logp_fn=target)}
            if fits or log2n == 18:
                calls["plain"] = lambda: fs.fused_stretch_half_reference(
                    *args, u, ue, logp_fn=target)
                calls["split"] = lambda: fs.fused_stretch_half(
                    *args, key=key, logp_fn=lambda x: target(x))
            if log2n == 20:
                calls["loads"] = lambda: fs.wide_loads_only(*args, key, prec)
                calls["prologue"] = lambda: fs.wide_split_l(prec)
                calls["mma_forced"] = lambda: fs.wide_forced_mma(*args, key,
                                                                 prec)
            means, readings, _ = in_turns(list(calls.values()),
                                          WIDE_YL_ITERS, blocker, warmup=1)
            turns.append((log2n, dict(zip(calls, means)),
                          dict(zip(calls, readings))))
            del args, u, ue, calls
            torch.cuda.empty_cache()
        t20, r20 = turns[0][1], turns[0][2]
        bound, bound_by = wide_bound_ms(n, q)
        bytes_ms, product_ms = wide_bound_parts(n, q)
        prologue[q] = t20["prologue"]
        by_p[q] = {"ms": t20["wide"], "plain_ms": t20.get("plain"),
                   "split_route_ms": t20.get("split"),
                   "loads_only_ms": t20["loads"],
                   "mma_forced_ms": t20["mma_forced"],
                   "bound_ms": bound, "bound_by": bound_by,
                   "bytes_bound_ms": bytes_ms,
                   "product_bound_ms": product_ms,
                   "layout": fs.wide_layout(q, dev)}
        small = ""
        if not fits:
            t18 = turns[1][1]
            by_p[q]["at_2_18"] = t18
            small = (f"; at n=2^18 in turns: wide {t18['wide']:.4f}, plain "
                     f"{t18['plain']:.4f}, split route {t18['split']:.4f}")
        else:
            small = (f", plain {t20['plain']:.4f}, old split route "
                     f"{t20['split']:.4f}")
        print(f"  route 6 n=2^20 P={q}, ms per half-step (in turns): wide "
              f"{t20['wide']:.4f} ({r20['wide'][0]:.4f}, "
              f"{r20['wide'][1]:.4f}), its loads and stores alone "
              f"{t20['loads']:.4f}, its prologue alone "
              f"{t20['prologue']:.4f}, the mma.sync kernel forced "
              f"{t20['mma_forced']:.4f} ({r20['mma_forced'][0]:.4f}, "
              f"{r20['mma_forced'][1]:.4f}){small}; bound {bound:.4f} "
              f"({bound_by}; bytes {bytes_ms:.4f}, 3xTF32 product "
              f"{product_ms:.4f}), {bound / t20['wide']:.0%} of it; "
              f"{fs.WIDE_ROUTES[by_p[q]['layout']['route']]}, "
              f"{by_p[q]['layout']} [{card}]", flush=True)
    return max(errs)


def wide_sampler(mt, fs, target, p, card, store, burn=WIDE_BURN,
                 fresh=False):
    """The sampler on a wide GaussianTarget at W = 2^21: ``burn`` burn-in
    steps a reading in turns with the split route (the same seeds), the
    acceptance within 4 binomial SE of the split route's, 2 wide launches a
    step and none of another kernel; with ``store``, WIDE_STORE stored steps
    after them (finite rows whose logp is the target's), else the final
    state checked the same way. With ``fresh`` each reading runs a new
    sampler (the wide and the split route's first readings from seed 0,
    their second from seed 1), so that one ensemble is on the card at a
    time, one step a ``run_mcmc`` call (a call keeps its starting state
    until it returns, so a call of several steps holds two ensembles beside
    a step's intermediates), and the split route's logp takes 2^18 rows at
    a time (at P = 3000 the proposal's Y·L and its squares of a whole half
    would not fit the card beside them). Returns the launches, steps, rates
    and acceptances."""
    def split_logp(x):
        if not fresh:
            return target(x)
        return torch.cat([target(c) for c in x.split(1 << 18)])

    def sampler(route, seed):
        logp = target if route == "wide" else split_logp
        s = mt.EnsembleSampler(logp, n_walkers=W_FULL, n_params=p,
                               mover=mt.FusedStretchMove(), seed=seed,
                               batched=True, device="cuda")
        s.init_ball(np.zeros(p), 0.5)
        return s

    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    runs = {route: ([None if fresh else sampler(route, 0)], [],
                    {k: 0 for k in fs.LAUNCHES}, [])
            for route in ("wide", "split")}
    s = None
    for route in ("wide", "split", "split", "wide"):
        held, secs, counted, accs = runs[route]
        if fresh:
            # the last reading's sampler freed before the next is made
            s = None
            for other in runs.values():
                other[0][0] = None
            torch.cuda.empty_cache()
            held[0] = sampler(route, len(secs))
        s = held[0]
        reset_launches(fs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(burn if fresh else 1):
            s.run_mcmc(1 if fresh else burn, store=False)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        accs.append(s.acceptance_fraction)
        for k, v in fs.LAUNCHES.items():
            counted[k] += v
    s, counted = runs["wide"][0][0], runs["wide"][2]
    runs["split"][0][0] = None
    # fresh: the mean of the readings' fractions (the same walker-steps
    # each); else the one sampler's fraction over both readings
    acc = {r: (float(np.mean(runs[r][3])) if fresh else runs[r][3][-1])
           for r in runs}
    walker_steps = W_FULL * 2 * burn
    se = np.sqrt(sum(f * (1 - f) for f in acc.values()) / walker_steps)
    if not 0 < acc["wide"] < 1 or abs(acc["wide"] - acc["split"]) > 4 * se:
        raise AssertionError(f"P={p}: acceptance of the wide route "
                             f"{acc['wide']} against the split route's "
                             f"{acc['split']}: more than 4 binomial SE "
                             f"({se:.2e}) apart")
    steps = 2 * burn
    if store:
        reset_launches(fs)
        if not s.run_mcmc(WIDE_STORE, thin=WIDE_THIN):
            raise AssertionError("chain capacity hit in the wide sampler run")
        for k, v in fs.LAUNCHES.items():
            counted[k] += v
        samples = check_stored(s, target, f"wide sampler P={p}")
        if samples.shape != (WIDE_STORE // WIDE_THIN, W_FULL, p):
            raise AssertionError(f"wide sampler stored {samples.shape}")
        steps += WIDE_STORE
        stored = f"{samples.shape[0]} stored rows"
        del samples
    else:
        # each half on its own: at P = 3000 the whole state is 25 GB
        rows = slice(None, None, 997)
        for x, lp in ((s.state.red, s.state.logp_red),
                      (s.state.black, s.state.logp_black)):
            if (x.shape != (W_FULL // 2, p)
                    or not bool(torch.isfinite(x).all())):
                raise AssertionError(f"wide sampler P={p}: state "
                                     f"{x.shape} not finite")
            torch.testing.assert_close(lp[rows], target(x[rows]), rtol=RTOL,
                                       atol=ATOL)
        stored = "final state finite, its logp the target's"
    if counted != launches_only(fs, fused_stretch_wide=2 * steps):
        raise AssertionError(f"the wide sampler at P={p} launched {counted}")
    split_counted = runs["split"][2]
    if split_counted != launches_only(fs, stretch_propose=4 * burn,
                                      stretch_accept=4 * burn):
        raise AssertionError(f"the split-route sampler at P={p} launched "
                             f"{split_counted}")
    rates = {r: [W_FULL * burn / t for t in runs[r][1]] for r in runs}
    print(f"  sampler W=2^21 P={p}, {burn} burn-in steps a reading"
          f"{' (a new sampler a reading)' if fresh else ''}, in "
          f"turns: wide kernel "
          f"{', '.join(f'{x:.6e}' for x in rates['wide'])} walker-updates/s, "
          f"split route {', '.join(f'{x:.6e}' for x in rates['split'])} "
          f"({np.mean(rates['wide']) / np.mean(rates['split']):.2f}x); "
          f"acceptance {acc['wide']:.5f} vs {acc['split']:.5f} (4 SE "
          f"{4 * se:.1e}); launches {counted}; {stored}; device memory "
          f"{before_gib:.2f} GiB before, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    del runs, s
    torch.cuda.empty_cache()
    return {"launches": counted["fused_stretch_wide"], "steps": steps,
            "rates": rates, "acceptance": acc}


def check_stored(s, target, label):
    """Finite stored rows whose stored logp equals the target there."""
    dev = torch.device("cuda")
    samples = s.get_samples()
    if not np.isfinite(samples).all():
        raise AssertionError(f"{label}: non-finite stored positions")
    stored_lp = torch.from_numpy(s.get_log_probs()).to(dev)
    recomputed = target(torch.from_numpy(samples).to(dev))
    torch.testing.assert_close(stored_lp, recomputed, rtol=1e-5, atol=1e-5)
    return samples


class CountedLogp(torch.nn.Module):
    """A batched logp that counts the rows it is evaluated on: one row is
    one chain's logp and, through autograd, its gradient."""

    def __init__(self, target):
        super().__init__()
        self.target = target
        self.rows = 0

    def forward(self, x, *batch):
        self.rows += x.shape[0]
        return self.target(x, *batch)


@contextmanager
def counting_syncs():
    """Count the operations that wait for the device (CUDA's sync debug mode
    in "warn"); yields a list whose length is the count at the end."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own notice on its first use in a process ("a prototype
    # feature and does not yet detect all synchronizing operations") is no
    # sync
    caught[:] = [w for w in caught if "synchroniz" in str(w.message)
                 and "prototype feature" not in str(w.message)]


def moments_within(label, samples, ess, ess_sq, mean, cov, n_se=5.0,
                   bias=0.0):
    """The sample mean and covariance against the truth, each within
    ``n_se`` Monte-Carlo standard errors from the run's own ESS: sd/√ESS_i
    for a mean (``ess`` of the draws), √((Σ_ii Σ_jj + Σ_ij²)/ESS) for a
    covariance entry (a Gaussian's), with the smallest ESS of the centered
    squares (``ess_sq``): a sampler whose draws are antithetic in the mean
    (NUTS: ESS above the draws' count) is not so in the variance. An
    unadjusted sampler's covariance may also be off by ``bias``·|Σ_ij|
    (its stationary law is not the target's). Returns (the largest
    deviation in standard errors beyond the bias, the largest relative
    deviation of a covariance entry)."""
    flat = samples.reshape(-1, samples.shape[-1]).astype(np.float64)
    sd = np.sqrt(np.diag(cov))
    z_mean = np.abs(flat.mean(axis=0) - mean) / (sd / np.sqrt(ess))
    se_cov = np.sqrt((np.outer(sd ** 2, sd ** 2) + cov ** 2) / np.min(ess_sq))
    off = np.abs(np.cov(flat.T) - cov)
    z_cov = np.maximum(off - bias * np.abs(cov), 0.0) / se_cov
    worst = float(max(z_mean.max(), z_cov.max()))
    if not worst <= n_se:
        raise AssertionError(
            f"{label}: mean or covariance {worst:.2f} MC standard errors "
            f"from the truth (bound {n_se}; covariance bias allowed "
            f"{bias})")
    return worst, float((off / np.abs(cov)).max())


def gradient_engines(mt, card, out_dir):
    """Phase 9: the gradient engines on the card, through the entry points
    a user calls (``warmup``/``tune``, ``run``, ``get_samples``), with no hand
    kernel on their path. Prints, per engine, transitions/s, gradient
    evaluations/s (rows of the batched logp), worst-parameter ESS/s (the
    port's ``analysis.effective_sample_size``), host syncs per step (CUDA's
    sync debug mode) and peak device memory, and checks what comes out."""
    import torch.nn.functional as F

    from mcmcpp_tpu_torch.analysis import potential_scale_reduction
    from mcmcpp_tpu_torch.io import load_checkpoint

    dev = torch.device("cuda")

    def drive(label, make, target, n_warm, n_steps, tune=False, center=0.0,
              scale=1.0):
        counted = CountedLogp(target)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = make(counted)
        s.init_ball(center + torch.zeros(s.n_params, device=dev), scale)
        t0 = time.perf_counter()
        if n_warm:
            (s.tune if tune else s.warmup)(n_warm)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        counted.rows = 0
        with counting_syncs() as syncs:
            t0 = time.perf_counter()
            if not s.run(n_steps):
                raise AssertionError(f"{label}: chain capacity hit")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        x = s.get_samples()
        if x.shape != (n_steps, s.n_chains, s.n_params) or not np.isfinite(
                x).all():
            raise AssertionError(f"{label}: stored samples {x.shape}, "
                                 "finite rows expected")
        ess = np.asarray(mt.analysis.effective_sample_size(
            torch.from_numpy(x).to(dev)))
        worst = float(np.nanmin(ess)) if np.isfinite(ess).any() else 0.0
        extra = ""
        if hasattr(s, "get_sample_stats"):
            extra = (f", divergences {int(s.divergence_count.sum())}, "
                     f"accept {s.last_mean_accept:.3f}")
        print(f"  {label}: C={s.n_chains} P={s.n_params}, warmup {n_warm} in "
              f"{warm_s:.2f} s, {n_steps} steps in {run_s:.3f} s: "
              f"{s.n_chains * n_steps / run_s:.6e} transitions/s, "
              f"{counted.rows / run_s:.6e} gradient evaluations/s "
              f"({counted.rows / (s.n_chains * n_steps):.2f} a transition), "
              f"worst-parameter ESS {worst:.0f} = {worst / run_s:.6e} ESS/s, "
              f"{len(syncs) / n_steps:.3f} host syncs per step, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB"
              f"{extra} [{card}]", flush=True)
        return s, x, ess

    # (a) the repo's configuration (benchmarks/grad_bench.py:42-55)
    dim, rho, n_chains = 10, 0.5, 1024
    sigma = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    gauss = mt.equicorrelated_gaussian(dim, rho, device=dev)

    # the gradient layer alone: wall time per call of the target and of
    # logp_and_grad (its autograd backward) at this width, 200 calls
    # between fences
    from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad

    x = torch.randn((n_chains, dim), device=dev)
    per_call = {}
    for name, fn in [("logp", lambda: gauss(x)),
                     ("logp_and_grad", lambda: logp_and_grad(gauss, x))]:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        per_call[name] = (time.perf_counter() - t0) / 200 * 1e6
    print(f"  gradient layer, C={n_chains} P={dim}: the target "
          f"{per_call['logp']:.1f} us a call, logp_and_grad "
          f"{per_call['logp_and_grad']:.1f} us a call [{card}]", flush=True)
    # (label, sampler, tune instead of warmup, warmup steps, stored steps):
    # 300 + 200 (grad_bench.py runs 300 + 400), but for NUTS, whose lockstep
    # trees reach depth 8 in nearly every transition of the diagonal metric
    # (~190 leaves of 2-3 ms of host time each at 1024 chains), cut so that
    # the phase stays inside the script's time
    engines = [
        ("nuts", lambda f: mt.NUTSSampler(f, n_chains, dim, max_depth=8,
                                          device="cuda"), False, 100, 50),
        ("nuts dense", lambda f: mt.NUTSSampler(
            f, n_chains, dim, max_depth=8, metric="dense", device="cuda"),
         False, 100, 50),
        ("chees", lambda f: mt.CheesHMCSampler(f, n_chains, dim,
                                               device="cuda"), False, 300,
         200),
        ("meads", lambda f: mt.MEADSSampler(f, n_chains, dim, device="cuda"),
         False, 300, 200),
        ("mclmc", lambda f: mt.MCLMCSampler(f, n_chains, dim, device="cuda"),
         True, 300, 200),
        ("mams", lambda f: mt.MAMSSampler(f, n_chains, dim, device="cuda"),
         True, 300, 200),
        ("hmc", lambda f: mt.HMCSampler(f, n_chains, dim, n_leapfrog=16,
                                        device="cuda"), False, 300, 200),
        ("mala", lambda f: mt.MALASampler(f, n_chains, dim, device="cuda"),
         False, 300, 200),
        ("barker", lambda f: mt.BarkerSampler(f, n_chains, dim,
                                              device="cuda"), False, 300,
         200),
    ]
    for label, make, tune, n_warm, n_steps in engines:
        s, x, ess = drive(f"gaussian {label}", make, gauss, n_warm, n_steps,
                          tune)
        xt = torch.from_numpy(x).to(dev)
        ess_sq = np.asarray(mt.analysis.effective_sample_size(
            (xt - xt.mean(dim=(0, 1))) ** 2))
        # MCLMC has no accept step: tests/test_mclmc.py allows its variance
        # 8% (rtol 0.08) besides the Monte-Carlo error
        bias = 0.08 if label == "mclmc" else 0.0
        z, rel = moments_within(label, x, ess, ess_sq, np.zeros(dim), sigma,
                                bias=bias)
        print(f"    mean and covariance within {z:.2f} MC standard errors of "
              f"the truth (bound 5, covariance bias allowed {bias}); "
              f"largest covariance deviation {rel:.4f} relative")
        if label == "nuts":
            syncs = s._kernel.host_syncs
            print(f"    NUTS's own count: {syncs} syncs over the warmup and "
                  f"the run, {s._kernel.leapfrogs} leapfrog steps")
        del s, x, xt
        torch.cuda.empty_cache()

    # (b) a model users run at its full width: Bayesian logistic regression
    # at the German-credit shape (N = 1000 rows, P = 25), synthetic data
    logit = mt.logistic_regression(n_data=1000, dim=25, seed=0, device=dev)
    wide = 1 << 14
    fits = {}
    for label, make, n_warm, n_steps in [
            ("nuts", lambda f: mt.NUTSSampler(f, wide, 25, max_depth=8,
                                              device="cuda"), 150, 200),
            ("chees", lambda f: mt.CheesHMCSampler(f, wide, 25,
                                                   device="cuda"), 300, 200)]:
        s, x, ess = drive(f"logistic {label}", make, logit, n_warm, n_steps,
                          scale=0.1)
        rhat = potential_scale_reduction(x, rank_normalized=False)
        flat = x.reshape(-1, 25).astype(np.float64)
        fits[label] = (flat.mean(axis=0), flat.var(axis=0), ess)
        print(f"    R-hat max {rhat.max():.5f} (bound 1.01)")
        if not rhat.max() < 1.01:
            raise AssertionError(f"logistic {label}: R-hat {rhat}")
        del s, x, flat
        torch.cuda.empty_cache()
    (m_n, v_n, e_n), (m_c, v_c, e_c) = fits["nuts"], fits["chees"]
    z = np.abs(m_n - m_c) / np.sqrt(v_n / e_n + v_c / e_c)
    print(f"    NUTS and ChEES posterior means within {z.max():.2f} MC "
          "standard errors (bound 5)")
    if not z.max() <= 5.0:
        raise AssertionError(f"NUTS and ChEES means differ by {z} SE")

    # SGLD and SGHMC on the same data, minibatches of 100 rows, started on
    # the NUTS posterior; held to tests/test_sgmcmc.py's tolerances
    data = {"x": logit.x_t, "s": logit.sign_t}

    def logprior(t):
        return -0.5 * torch.sum(t * t, dim=-1) / logit.prior_scale ** 2

    def loglike(t, batch):
        return torch.sum(F.logsigmoid(batch["s"] * (t @ batch["x"].T)),
                         dim=-1)

    for label, make in [
            ("sgld", lambda f: mt.SGLDSampler(
                logprior, f, data, 1024, 25, batch_size=100,
                step_size=SGLD_STEP, device="cuda")),
            ("sghmc", lambda f: mt.SGHMCSampler(
                logprior, f, data, 1024, 25, batch_size=100,
                step_size=SGHMC_STEP, friction=0.1, device="cuda"))]:
        s, x, _ = drive(f"logistic {label}", make, loglike, 0, SG_STEPS,
                        center=torch.from_numpy(m_n).float().to(dev),
                        scale=torch.from_numpy(np.sqrt(v_n)).float().to(dev))
        flat = x[SG_STEPS // 4:].reshape(-1, 25).astype(np.float64)
        d_mean = np.abs(flat.mean(axis=0) - m_n) / np.sqrt(v_n)
        ratio = flat.var(axis=0) / v_n
        print(f"    mean within {d_mean.max():.3f} posterior sd of NUTS's "
              f"(bound 4); variance ratio {ratio.min():.3f}-{ratio.max():.3f}"
              " (bounds 0.5-2.5)")
        if not (d_mean.max() < 4.0 and ratio.min() > 0.5
                and ratio.max() < 2.5):
            raise AssertionError(f"logistic {label}: moments off NUTS's")
        del s, x, flat

    # (c) resume on the card: HMC at C = 2^14 on the logistic target
    path = os.path.join(out_dir, "ck_hmc")

    def hmc(seed):
        return mt.HMCSampler(logit, wide, 25, n_leapfrog=8, seed=seed,
                             device="cuda")

    a = hmc(3)
    a.init_ball(torch.zeros(25, device=dev), 0.1)
    t0 = time.perf_counter()
    a.run(40, checkpoint_path=path)
    first_s = time.perf_counter() - t0
    a.run(40)
    b = hmc(77)
    t0 = time.perf_counter()
    load_checkpoint(b, path)
    load_s = time.perf_counter() - t0
    b.run(40)
    same = all(torch.equal(u, v) for u, v in zip(a.state, b.state))
    for get in ("get_samples", "get_log_probs"):
        ra, rb = getattr(a, get)(), getattr(b, get)()
        same = same and ra.shape[0] == 80 and np.array_equal(ra, rb)
    sa, sb = a.get_sample_stats(), b.get_sample_stats()
    same = same and all(np.array_equal(sa[k], sb[k]) for k in sa)
    if not same:
        raise AssertionError("HMC: the resumed run differs from the "
                             "uninterrupted one")
    print(f"  resume hmc C=2^14 P=25: 40 + 40 steps == 40, load, 40 bitwise "
          f"(state, 80 rows, sample stats); 40 steps + checkpoint of "
          f"{os.path.getsize(path + '.npz')} B in {first_s:.2f} s, loaded in "
          f"{load_s:.2f} s [{card}]", flush=True)


def phases_from_argv(argv):
    """The phases chosen on the command line (``--phases 2b,10``; phase 1,
    the card and the build, always runs), or None for every phase."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: python3 chip_smoke.py [--phases 2,2b,...]")
    chosen = {p.strip() for p in argv[1].split(",") if p.strip()}
    known = {"1", "2", "2b", "3", "4", "5", "6", "7", "8", "9", "10", "11",
             "12", "13", "14", "15", "16", "17"}
    if not chosen <= known:
        raise SystemExit(f"unknown phases {sorted(chosen - known)}; known: "
                         f"{sorted(known)}")
    return chosen


def fenced_steps(fn, n):
    """((result, wall seconds), host seconds to enqueue) of ``fn(n)``
    between two device fences."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(n)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0), enqueue_s


# phase 10: the population engines. Widths of each cell: (a) PT at the
# flagship's walker-rung count, (b) power mode at (a)'s walkers a rung, (c)
# the GP latent of examples/function_space.py at its finest grid, (d) the
# JAX tests' Gibbs oracles at 2^14 and 2^12 chains
PT_RUNGS, PT_WALKERS = 16, 1 << 17
PT_BURN, PT_STEPS, PT_THIN = 1000, 600, 5
MODES_WALKERS, MODES_BURN, MODES_STEPS = 1 << 14, 2000, 1500
POWER_RUNGS, POWER_BURN, POWER_STEPS = 12, 400, 1000
GP_P, GP_CHAINS = 1024, 4096
# burn-in: the GP posterior's data-informed directions relax over a few
# hundred steps under pCN (β ≈ 0.1, acceptance ≈ 0.3) and over ~1000 under
# the elliptical slice (its bias at 500 steps reads 2 SE at 512 chains on
# the CPU, so more at 4096); ten and two of those
PCN_BURN, PCN_STEPS, ESS_BURN, ESS_STEPS = 4000, 4000, 2000, 500
GIBBS_CHAINS, MIX_CHAINS = 1 << 14, 1 << 12
GIBBS_SYNC_SWEEPS = 20
# the conjugate model of tests/test_evidence.py: prior N(0, S0^2),
# y_i ~ N(theta, 1)
EVIDENCE_S0 = 2.0
EVIDENCE_Y = np.array([1.14, 0.72, 0.21, 1.95, 0.38, 1.52, -0.34, 0.91,
                       1.18, 0.43], np.float32)
# examples/function_space.py's GP latent: RBF length 0.25, 12 noisy point
# observations of sin(2πx)·e^{-x}
GP_ELL, GP_SIG = 0.25, 0.15


def evidence_model(dev):
    """(batched log prior, batched log-likelihood, quadrature log Z) of the
    conjugate model of ``tests/test_evidence.py``."""
    y = torch.from_numpy(EVIDENCE_Y).to(dev)
    s0 = EVIDENCE_S0

    def logprior(t):
        return (-0.5 * torch.sum(t * t, dim=-1) / s0 ** 2
                - 0.5 * float(np.log(2 * np.pi * s0 ** 2)))

    def loglike(t):
        return (torch.sum(-0.5 * (y - t[:, :1]) ** 2, dim=-1)
                - EVIDENCE_Y.size / 2 * float(np.log(2 * np.pi)))

    g = np.linspace(-12, 12, 200001)
    lp = (-0.5 * g ** 2 / s0 ** 2 - 0.5 * np.log(2 * np.pi * s0 ** 2)
          + np.sum(-0.5 * (EVIDENCE_Y[:, None] - g[None, :]) ** 2, axis=0)
          - EVIDENCE_Y.size / 2 * np.log(2 * np.pi))
    m = lp.max()
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return logprior, loglike, float(m + np.log(trapezoid(np.exp(lp - m), g)))


def gp_problem(p, dev):
    """The GP latent of ``examples/function_space.py`` on a grid of p points:
    (float32 prior factor, batched log-likelihood, the exact posterior mean
    of the discretized model (prior L·Lᵀ of the float32 factor,
    observations at the nearest grid points), float64)."""
    x_obs = np.linspace(0.05, 0.95, 12)
    rng = np.random.default_rng(3)
    y_obs = (np.sin(2 * np.pi * x_obs) * np.exp(-x_obs)
             + GP_SIG * rng.standard_normal(x_obs.size))
    grid = np.linspace(0.0, 1.0, p)
    kern = np.exp(-0.5 * ((grid[:, None] - grid[None, :]) / GP_ELL) ** 2)
    chol = np.linalg.cholesky(kern + 1e-6 * np.eye(p)).astype(np.float32)
    idx = np.abs(grid[:, None] - x_obs[None, :]).argmin(axis=0)
    prior = chol.astype(np.float64) @ chol.astype(np.float64).T
    k_oo = prior[np.ix_(idx, idx)] + GP_SIG ** 2 * np.eye(idx.size)
    exact = prior[:, idx] @ np.linalg.solve(k_oo, y_obs)
    idx_t = torch.from_numpy(idx).to(dev)
    y_t = torch.from_numpy(y_obs.astype(np.float32)).to(dev)

    def loglike(f):
        return -0.5 * torch.sum(((y_t - f[:, idx_t]) / GP_SIG) ** 2, dim=-1)

    return chol, loglike, exact


def chain_mean_z(samples, truth):
    """The grand mean of (S, C, P) ``samples`` (C independent chains)
    against ``truth`` (P,): the largest |deviation| in standard errors, the
    SE being the spread of the C per-chain means over √C (which holds each
    chain's autocorrelation)."""
    means = samples.astype(np.float64).mean(axis=0)  # (C, P)
    se = means.std(axis=0, ddof=1) / np.sqrt(means.shape[0])
    return float((np.abs(means.mean(axis=0) - truth) / se).max())


def stored(ok, label):
    """Fail if a storing run hit its chain's byte capacity."""
    if not ok:
        raise AssertionError(f"{label}: chain capacity hit")


def within_5se(label, *zs):
    """Fail if any of the deviations ``zs`` (in MC standard errors) passes
    5 (checked after the line that reports them is printed)."""
    if not max(zs) <= 5.0:
        raise AssertionError(f"{label}: {max(zs):.2f} MC standard errors "
                             "from the truth (bound 5)")


def population_engines(mt, card, out_dir):
    """Phase 10: parallel tempering (logp and power mode), pCN, elliptical
    slice and blocked Gibbs on the card, through the entry points a user
    calls, with no hand kernel on their path; each check fails the run."""
    from mcmcpp_tpu_torch import gibbs as tg
    from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint

    dev = torch.device("cuda")

    def fenced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) PT, logp mode: K = 16 geometric rungs of 2^17 walkers on the
    # flagship's 10-D Gaussian (2^21 walker-rung updates a step)
    dim, rho = 10, 0.5
    sigma = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    gauss = mt.equicorrelated_gaussian(dim, rho, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pt = mt.ParallelTemperingSampler(gauss, PT_WALKERS, dim, n_temps=PT_RUNGS,
                                     seed=0, batched=True, device="cuda")
    pt.init_ball(np.zeros(dim), 1.0)
    with counting_syncs() as syncs:
        state = pt.state
        for _ in range(20):
            state = pt.step(state)
        pt.state = state
    if syncs:
        raise AssertionError(f"PT: {len(syncs)} host syncs in 20 steps: "
                             f"{[str(w.message)[:200] for w in syncs]}")
    _, burn_s = fenced(lambda: pt.run_mcmc(PT_BURN, thin=PT_BURN))
    pt.chain.clear()
    ok, run_s = fenced(lambda: pt.run_mcmc(PT_STEPS, thin=PT_THIN))
    if not ok:
        raise AssertionError("PT: chain capacity hit")
    x = pt.get_samples()
    if x.shape != (PT_STEPS // PT_THIN, PT_WALKERS, dim) or not np.isfinite(
            x).all():
        raise AssertionError(f"PT: stored {x.shape}, finite rows expected")
    xt = torch.from_numpy(x).to(dev)
    ess = np.asarray(mt.analysis.effective_sample_size(xt))
    ess_sq = np.asarray(mt.analysis.effective_sample_size(
        (xt - xt.mean(dim=(0, 1))) ** 2))
    z, rel = moments_within("PT cold chain", x, ess, ess_sq, np.zeros(dim),
                            sigma)
    rates = pt.swap_acceptance
    if not (rates > 0.05).all():
        raise AssertionError(f"PT swap rates {rates}")
    updates = PT_RUNGS * PT_WALKERS
    print(f"  PT K={PT_RUNGS} W={PT_WALKERS} P={dim}: no host sync in 20 "
          "steps; "
          f"burn-in {PT_BURN} steps {updates * PT_BURN / burn_s:.6e} "
          f"walker-rung updates/s ({burn_s / PT_BURN * 1e3:.3f} ms a step), "
          f"storing {PT_STEPS} steps at thin {PT_THIN} "
          f"{updates * PT_STEPS / run_s:.6e} ({run_s:.3f} s); cold chain "
          f"within {z:.2f} MC standard errors of the truth (bound 5; "
          f"worst covariance entry {rel:.4f} relative, ESS min "
          f"{np.nanmin(ess):.0f}); swap rates {np.round(rates, 4).tolist()} "
          f"(bound > 0.05); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB [{card}]",
          flush=True)
    del pt, x, xt, state
    torch.cuda.empty_cache()

    # the separated-mode oracle of tests/test_tempering.py:46: modes at ±8
    # (σ = 0.5), K = 8 rungs down to β = 0.005, every walker started in the
    # left mode; the right mode's share of the cold chain within 5 SE of ½
    twin = mt.gaussian_mixture([[-8.0], [8.0]], scales=[0.5, 0.5],
                               device=dev)
    pm = mt.ParallelTemperingSampler(
        twin, MODES_WALKERS, 1, betas=np.geomspace(1.0, 0.005, 8), seed=1,
        batched=True, device="cuda")
    pm.init_ball(np.array([-8.0]), 0.5)
    _, modes_s = fenced(lambda: pm.run_mcmc(MODES_BURN, thin=MODES_BURN))
    pm.chain.clear()
    stored(pm.run_mcmc(MODES_STEPS, thin=10), "PT separated modes")
    right = (pm.get_samples() > 0).astype(np.float32)
    share = float(right.mean())
    ess = float(np.asarray(mt.analysis.effective_sample_size(
        torch.from_numpy(right).to(dev)))[0])
    se = np.sqrt(share * (1 - share) / ess)
    print(f"  PT separated modes (±8, K=8, W={MODES_WALKERS}): right-mode "
          "share "
          f"{share:.4f}, {abs(share - 0.5) / se:.2f} MC standard errors from "
          f"1/2 (ESS {ess:.0f}; bound 5); {MODES_BURN} steps in "
          f"{modes_s:.2f} s [{card}]", flush=True)
    if not abs(share - 0.5) <= 5 * se:
        raise AssertionError(f"PT separated modes: share {share}")
    del pm, right

    # (b) power mode on tests/test_evidence.py's conjugate model: K = 12
    # power ladder, 2^17 walkers a rung, the JAX test's bounds
    logprior, loglike, logz = evidence_model(dev)

    def power_pt(seed):
        return mt.ParallelTemperingSampler(
            loglike_fn=loglike, logprior_fn=logprior, n_walkers=PT_WALKERS,
            n_params=1, betas=mt.power_ladder(POWER_RUNGS), seed=seed,
            batched=True, device="cuda")

    pp = power_pt(0)
    pp.init_ball(np.zeros(1), 1.0, seed=1)
    pp.run_mcmc(POWER_BURN, thin=POWER_BURN)
    pp.reset_evidence()
    ok, power_s = fenced(lambda: pp.run_mcmc(POWER_STEPS, thin=10))
    stored(ok, "power PT")
    ss, ti = pp.log_evidence("stepping_stone"), pp.log_evidence("ti")
    post_prec = 1.0 / EVIDENCE_S0 ** 2 + EVIDENCE_Y.size
    cold = pp.get_samples(flat=True)[:, 0]
    print(f"  power PT K={POWER_RUNGS} W={PT_WALKERS}: log Z stepping stone "
          f"{ss:.5f}, "
          f"TI {ti:.5f}, quadrature {logz:.5f} (bounds 0.1, 0.5); cold "
          f"chain mean {cold.mean():.5f} vs {EVIDENCE_Y.sum() / post_prec:.5f}"
          f", sd {cold.std():.5f} vs {post_prec ** -0.5:.5f}; "
          f"{PT_WALKERS * POWER_RUNGS * POWER_STEPS / power_s:.6e} "
          f"walker-rung updates/s [{card}]", flush=True)
    if not (abs(ss - logz) < 0.1 and abs(ti - logz) < 0.5):
        raise AssertionError(f"power PT evidence {ss}, {ti} vs {logz}")
    del pp, cold

    # (c) pCN and elliptical slice on the GP latent at P = 1024, C = 4096
    chol, gp_like, exact = gp_problem(GP_P, dev)
    torch.cuda.reset_peak_memory_stats()
    pcn = mt.PCNSampler(gp_like, prior_mean=np.zeros(GP_P), prior_chol=chol,
                        beta=0.12, n_chains=GP_CHAINS, seed=0, batched=True,
                        device="cuda")
    pcn.init_prior(seed=1)
    pcn.tune(n_steps=400, target=0.3, window=20)
    # β ≈ 0.1 and acceptance ≈ 0.3 make the data-informed directions'
    # autocorrelation a few hundred steps: the burn-in is ten of them
    pcn.run(PCN_BURN, thin=PCN_BURN)  # one row: a 16.8 MB row a step
    # would fill the chain's 2 GiB in 128 steps
    pcn.chain.clear()
    n_pcn = PCN_STEPS
    ok, pcn_s = fenced(lambda: pcn.run(n_pcn, thin=n_pcn // 50))
    stored(ok, "pCN")
    z_pcn = chain_mean_z(pcn.get_samples(), exact)
    rmse = float(np.sqrt(np.mean((pcn.get_samples(flat=True).mean(axis=0)
                                  - exact) ** 2)))
    print(f"  pCN P={GP_P} C={GP_CHAINS}: tuned beta {pcn.beta:.4f}, "
          f"acceptance {pcn.acceptance_fraction:.4f}, {n_pcn / pcn_s:.2f} "
          f"steps/s ({GP_CHAINS * n_pcn / pcn_s:.6e} chain-steps/s), "
          f"posterior mean within {z_pcn:.2f} MC standard errors of the "
          f"closed form (bound 5; RMSE {rmse:.5f}), peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB [{card}]",
          flush=True)
    within_5se("pCN posterior mean", z_pcn)
    del pcn
    ess_s = mt.EllipticalSliceSampler(
        gp_like, prior_mean=np.zeros(GP_P), prior_chol=chol,
        n_chains=GP_CHAINS, seed=0, batched=True, device="cuda")
    ess_s.init_prior(seed=2)
    ess_s.run(ESS_BURN, thin=ESS_BURN)
    ess_s.chain.clear()
    before = dict(ess_s.counters)
    n_ess = ESS_STEPS
    ok, ess_t = fenced(lambda: ess_s.run(n_ess, thin=n_ess // 50))
    stored(ok, "elliptical slice")
    z_ess = chain_mean_z(ess_s.get_samples(), exact)
    iters = ess_s.counters["iterations"] - before["iterations"]
    n_syncs = ess_s.counters["syncs"] - before["syncs"]
    print(f"  elliptical slice P={GP_P} C={GP_CHAINS}: {iters / n_ess:.2f} "
          f"shrink iterations and {n_syncs / n_ess:.2f} host syncs a step "
          f"(a test every {mt.elliptical.CHECK_EVERY}), "
          f"{n_ess / ess_t:.2f} steps/s, "
          f"posterior mean within {z_ess:.2f} MC standard errors of the "
          f"closed form (bound 5) [{card}]", flush=True)
    within_5se("elliptical posterior mean", z_ess)
    del ess_s
    torch.cuda.empty_cache()

    # (d) blocked Gibbs: the hierarchical conjugate oracle of
    # tests/test_gibbs.py:48 at 2^14 chains (per-chain callables, vmapped)
    tau, sig, n = 2.0, 0.5, 12
    rng = np.random.default_rng(0)
    y_h = (1.2 + rng.normal(0, np.sqrt(1 + sig ** 2), n)).astype(np.float32)
    yh = torch.from_numpy(y_h).to(dev)

    def mu_logp(mu, o):
        return (-0.5 * mu[0] ** 2 / tau ** 2
                - 0.5 * torch.sum((yh - mu[0] - o["e"]) ** 2) / sig ** 2)

    def e_loglike(e, o):
        return -0.5 * torch.sum((yh - o["mu"][0] - e) ** 2) / sig ** 2

    def hierarchical(seed):
        return mt.BlockedGibbsSampler(
            [("mu", 1, tg.MALAKernel(mu_logp, step_size=0.15)),
             ("e", n, tg.EllipticalSliceKernel(e_loglike,
                                               prior_scale=np.ones(n)))],
            n_chains=GIBBS_CHAINS, seed=seed, device="cuda")

    gb = hierarchical(1)
    gb.init({"mu": np.zeros(1), "e": np.zeros(n)})
    gb.run(500, thin=500)  # burn-in: the mu-latent ridge relaxes in ~200
    gb.chain.clear()
    n_sweeps = 500
    ok, gibbs_s = fenced(lambda: gb.run(n_sweeps, thin=10))
    stored(ok, "Gibbs hierarchical")
    prec = 1.0 / tau ** 2 + n / (1.0 + sig ** 2)
    mean_true = float(y_h.sum()) / (1.0 + sig ** 2) / prec
    mu = gb.get_block("mu")
    z_mu = chain_mean_z(mu, np.array([mean_true]))
    z_var = chain_mean_z((mu - mean_true) ** 2, np.array([1.0 / prec]))
    latent = mu + gb.get_block("e")
    expected = mean_true + (y_h - mean_true) / (1.0 + sig ** 2)
    z_lat = chain_mean_z(latent, expected)
    print(f"  Gibbs hierarchical (MALA + elliptical slice) C={GIBBS_CHAINS}: "
          f"{GIBBS_CHAINS * n_sweeps / gibbs_s:.6e} chain-sweeps/s "
          f"({gibbs_s / n_sweeps * 1e3:.3f} ms a sweep); mu's mean "
          f"{z_mu:.2f}, variance {z_var:.2f}, the latent's means {z_lat:.2f} "
          f"MC standard errors from the closed form (bound 5) [{card}]",
          flush=True)
    within_5se("Gibbs hierarchical", z_mu, z_var, z_lat)
    # the sweep's syncs: none but the slice loop's own host tests
    ess_k = gb.blocks[1][2]
    before = ess_k.counters["syncs"]
    with counting_syncs() as syncs:
        state = gb.state
        for _ in range(GIBBS_SYNC_SWEEPS):
            state = gb.sweep(state)
        gb.state = state
    loop_syncs = ess_k.counters["syncs"] - before
    # the sweep's split: each block's kernel alone on the sweep's state,
    # wall time between fences (the slice loop syncs, so no queued timing)
    split = {}
    for name, _, kernel in gb.blocks:
        x = gb.state[name]
        others = {k: v for k, v in gb.state.items() if k != name}

        def go():
            for _ in range(GIBBS_SYNC_SWEEPS):
                tg._kernel_step(kernel, gb._step_gen, x, others)

        _, block_s = fenced(go)
        split[name] = block_s / GIBBS_SYNC_SWEEPS * 1e3
    print(f"  Gibbs hierarchical sweep: {len(syncs)} host syncs in "
          f"{GIBBS_SYNC_SWEEPS} sweeps, the slice loop's own count "
          f"{loop_syncs} (bound: no other); a block alone: mu (MALA) "
          f"{split['mu']:.3f} ms, e (elliptical slice) {split['e']:.3f} ms "
          f"[{card}]", flush=True)
    if len(syncs) > loop_syncs:
        raise AssertionError(
            f"Gibbs sweep: {len(syncs)} host syncs, {loop_syncs} of them the "
            f"slice loop's: {[str(w.message)[:200] for w in syncs]}")
    del gb, mu, latent, state

    # the mixture data augmentation of tests/test_gibbs.py:366 at 2^12
    # chains (categorical assignments + exact conjugate means) against a
    # quadrature of the means' marginal posterior (the z summed out; the
    # chains stay in the labelling they start in, mu_0 < mu_1)
    msig, mtau, n0, n1 = 0.7, 5.0, 35, 45
    rng = np.random.default_rng(0)
    y_m = np.concatenate([rng.normal(-2.0, msig, n0),
                          rng.normal(2.0, msig, n1)]).astype(np.float32)
    ym = torch.from_numpy(y_m).to(dev)

    def z_logits(o):
        return -0.5 * ((ym[:, None] - o["mu"][None, :]) / msig) ** 2

    def sample_mu(gen, o):
        onehot = torch.stack([1.0 - o["z"], o["z"]], dim=1)
        n_k = onehot.sum(0)
        s_k = (onehot * ym[:, None]).sum(0)
        p_k = 1.0 / mtau ** 2 + n_k / msig ** 2
        return (s_k / msig ** 2) / p_k + p_k ** -0.5 * torch.randn(
            (2,), generator=gen, device=ym.device)

    gm = mt.BlockedGibbsSampler(
        [("z", y_m.size, tg.CategoricalGibbsKernel(z_logits)),
         ("mu", 2, tg.ExactGibbsKernel(sample_mu))],
        n_chains=MIX_CHAINS, seed=1, device="cuda")
    gm.init({"z": np.zeros(y_m.size), "mu": np.array([-1.0, 1.0])})
    gm.run(100, thin=100)
    gm.chain.clear()
    ok, mix_s = fenced(lambda: gm.run(400, thin=4))
    stored(ok, "Gibbs mixture")
    g0 = np.linspace(y_m[:n0].mean() - 1.0, y_m[:n0].mean() + 1.0, 801)
    g1 = np.linspace(y_m[n0:].mean() - 1.0, y_m[n0:].mean() + 1.0, 801)
    yy = y_m.astype(np.float64)
    l0 = -0.5 * ((yy[None, :] - g0[:, None]) / msig) ** 2  # (G, n)
    l1 = -0.5 * ((yy[None, :] - g1[:, None]) / msig) ** 2
    lp = (-0.5 * g0[:, None] ** 2 / mtau ** 2 - 0.5 * g1[None, :] ** 2
          / mtau ** 2 + np.logaddexp(l0[:, None, :], l1[None, :, :]).sum(-1))
    w = np.exp(lp - lp.max())
    w /= w.sum()
    quad = np.array([(w.sum(1) * g0).sum(), (w.sum(0) * g1).sum()])
    mus = gm.get_block("mu")
    z_mix = chain_mean_z(mus, quad)
    print(f"  Gibbs mixture (categorical + exact) C={MIX_CHAINS}: "
          f"{MIX_CHAINS * 400 / mix_s:.6e} chain-sweeps/s; the means "
          f"{np.round(mus.reshape(-1, 2).mean(0), 5).tolist()} within "
          f"{z_mix:.2f} MC standard errors of the quadrature "
          f"{np.round(quad, 5).tolist()} (bound 5) [{card}]", flush=True)
    within_5se("Gibbs mixture means", z_mix)
    del gm, mus

    # (e) bitwise resume: 40 + 40 steps against 40, save, load, 40, for
    # power-mode PT at (b)'s width and the Gibbs sampler at (d)'s
    for label, make, begin, go in [
            ("power PT", power_pt,
             lambda s: s.init_ball(np.zeros(1), 1.0, seed=1),
             lambda s: s.run_mcmc(40, thin=10)),
            ("Gibbs", hierarchical,
             lambda s: s.init({"mu": np.zeros(1), "e": np.zeros(n)}),
             lambda s: s.run(40, thin=10))]:
        path = os.path.join(out_dir, "ck_" + label.replace(" ", "_"))
        a = make(3)
        begin(a)
        go(a)
        _, save_s = fenced(lambda: save_checkpoint(a, path))
        go(a)
        b = make(77)
        _, load_s = fenced(lambda: load_checkpoint(b, path))
        go(b)
        sa, sb = a.state, b.state
        if isinstance(sa, dict):
            same = all(torch.equal(sa[k], sb[k]) for k in sa)
        else:
            same = all(torch.equal(u, v) if isinstance(u, torch.Tensor)
                       else u == v for u, v in zip(sa, sb))
        same = same and np.array_equal(a.get_samples(), b.get_samples()) \
            and np.array_equal(a.chain.get_logp(), b.chain.get_logp()) \
            and a.chain.n_steps == 8
        if label == "power PT":
            same = same and a.log_evidence() == b.log_evidence()
        if not same:
            raise AssertionError(f"{label}: the resumed run differs from the "
                                 "uninterrupted one")
        print(f"  resume {label}: 40 + 40 steps == 40, load, 40 bitwise "
              f"(state, 8 rows); checkpoint of "
              f"{os.path.getsize(path + '.npz')} B in {save_s:.2f} s, loaded "
              f"in {load_s:.2f} s [{card}]", flush=True)
        del a, b


# phase 11: the evidence and variational engines at full width; the SMC
# ensemble mutation with FusedStretchMove runs the split kernels
EV_P = 10
SMC_PARTICLES, SMC_MCMC = 1 << 20, 10
SMC_HMC_PARTICLES, SMC_FLOW_PARTICLES = 1 << 16, 1 << 14
NESTED_LIVE, NESTED_BATCH, NESTED_MCMC = 4096, 1024, 30
SLICE_LIVE, SLICE_MCMC = 1024, 5
NEUTRA_FIT, NEUTRA_BATCH, NEUTRA_CHAINS = 2000, 1024, 4096
# ChEES's leapfrog count follows the harmonic-mean acceptance of all 4096
# chains, which the funnel's neck drives down: uncapped, a transition can
# take all 1024 leapfrogs (this step then runs past 13 minutes on an H100);
# the cap keeps ChEES an exact (shorter-trajectory) HMC
NEUTRA_WARM, NEUTRA_STEPS, NEUTRA_MAX_LEAPFROG = 100, 100, 32
ADVI_STEPS, SVGD_PARTICLES, SVGD_STEPS = 2000, 8192, 500
PATHS, MAP_STARTS = 256, 256
ROUND_TRIP_ROWS, ROUND_TRIP_FIT = 1 << 16, 200


def conjugate_model(p):
    """Prior N(0, 4I), likelihood N(1; θ, I) in ``p`` dimensions
    (``tests/test_smc_vi.py:28``): (log prior, log-likelihood, prior draws,
    log Z, the posterior's per-dimension mean and variance)."""
    s2 = 1.0 / (1.0 / 4.0 + 1.0)
    logz = p * (-0.5 * np.log(2 * np.pi * 5.0) - 0.5 / 5.0)

    def lp(t):
        return (-0.5 * torch.sum(t * t, -1) / 4.0
                - p / 2 * float(np.log(2 * np.pi * 4.0)))

    def ll(t):
        return (-0.5 * torch.sum((t - 1.0) ** 2, -1)
                - p / 2 * float(np.log(2 * np.pi)))

    def prior(gen, n):
        return 2.0 * torch.randn((n, p), generator=gen, device=gen.device)

    return lp, ll, prior, logz, s2, s2


def evidence_engines(mt, fs, rnd, card, out_dir):
    """Phase 11: SMC (four mutations, waste-free), nested sampling (both
    kernels), NeuTra, ADVI, SVGD, Pathfinder and MAP/Laplace on the card
    through the entry points a user calls, each with the JAX tests' bounds,
    and their bitwise resumes. The SMC ensemble mutation with
    FusedStretchMove runs the split kernels around the tempered logp: their
    launches on that path are counted and returned, and both kernels are
    held bit for bit against their plain versions on one stage's inputs.
    Returns ({kernel: launches on the SMC path}, the kernels' largest
    absolute difference from their plain versions there)."""
    import warnings as _warnings

    from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint
    from mcmcpp_tpu_torch.map_laplace import bfgs

    dev = torch.device("cuda")

    def fenced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def peak():
        return f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB"

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def within(label, got, want, atol):
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        if not err <= atol:
            raise AssertionError(f"{label}: off by {err:.4g} (bound {atol})")
        return f"{label} off by {err:.4f} (bound {atol})"

    def saved(sampler, name):
        path, secs = fenced(lambda: save_checkpoint(
            sampler, os.path.join(out_dir, name)))
        return path, f"{os.path.getsize(path)} bytes saved in {secs:.3f} s"

    def quiet(fn):
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            return fn()

    os.makedirs(out_dir, exist_ok=True)
    p = EV_P
    lp, ll, prior, logz, mean_t, var_t = conjugate_model(p)

    class Capturing(mt.FusedStretchMove):
        """FusedStretchMove that keeps the inputs of its first half-step."""

        captured = None

        def apply(self, active, active_logp, other, logp_fn, state, noise,
                  beta=1.0):
            if self.captured is None:
                self.captured = (active, active_logp, other, noise, logp_fn)
            return super().apply(active, active_logp, other, logp_fn, state,
                                 noise, beta)

    def smc(n, **kw):
        return mt.SMCSampler(lp, ll, prior, n, p, batched=True,
                             device="cuda", **kw)

    def smc_gates(label, s, secs, syncs, n_mcmc, atol_mean=0.08,
                  atol_var=0.1, atol_z=0.15):
        if float(s.state.beta) != 1.0:
            raise AssertionError(f"{label}: beta {float(s.state.beta)}")
        x = s.state.particles
        notes = [within("log Z", s.log_evidence, logz, atol_z),
                 within("mean", x.mean(0).cpu(), mean_t, atol_mean),
                 within("variance", x.var(0, correction=0).cpu(), var_t,
                        atol_var)]
        print(f"  SMC {label}: N={s.n} P={p}, {s.n_stages} stages in "
              f"{secs:.3f} s, {s.n * n_mcmc * s.n_stages / secs:.6e} "
              f"particle-mutation steps/s, {len(syncs) / s.n_stages:.2f} host "
              f"syncs per stage, peak {peak()}; " + "; ".join(notes)
              + f" [{card}]", flush=True)

    # (a) the ensemble mutation at 2^20 particles: FusedStretchMove's split
    # kernels on the tempered logp, each half-step 2^19 walkers. The first
    # run counts the launches and keeps a stage's inputs (and loads every
    # kernel of the path); the second, of the same seed, is timed and must
    # give the same bits
    fresh()
    mover = Capturing()
    first = smc(SMC_PARTICLES, n_mcmc=SMC_MCMC, mover=mover, seed=0)
    reset_launches(fs)
    first.run()
    launches = dict(fs.LAUNCHES)
    per_stage = 2 * SMC_MCMC * first.n_stages
    if launches != {"fused_stretch_wide": 0, "fused_stretch_half": 0,
                    "stretch_propose": per_stage,
                    "stretch_accept": per_stage}:
        raise AssertionError(f"SMC ensemble launched {launches}, expected "
                             f"{per_stage} of each split kernel")
    print(f"  split kernels on the SMC path: {launches} over "
          f"{first.n_stages} stages, {2 * SMC_MCMC} of each a stage",
          flush=True)
    act, lp_old, other, (shift, key), logp_fn = mover.captured
    u, ue = rnd.philox_unit_uniforms(key, act.shape[0], dev)
    k_prop, k_fac = fs.stretch_propose(act, other, shift, key)
    r_prop, r_fac = fs.stretch_propose_reference(act, other, shift, u)
    lp_new = logp_fn(r_prop)
    k_acc = fs.stretch_accept(act, r_prop, lp_old, lp_new, r_fac, key)
    r_acc = fs.stretch_accept_reference(act, r_prop, lp_old, lp_new, r_fac,
                                        ue)
    torch.cuda.synchronize()
    same = (torch.equal(k_prop, r_prop) and torch.equal(k_fac, r_fac)
            and all(torch.equal(a, b) for a, b in zip(k_acc, r_acc)))
    n_acc = int(r_acc[2].sum())
    if not same or not 0 < n_acc < act.shape[0]:
        raise AssertionError("SMC stage inputs: a split kernel differs from "
                             f"its plain version ({n_acc} accepts)")
    print(f"    stretch_propose and stretch_accept on a stage's inputs "
          f"(n={act.shape[0]}, P={p}, the tempered logp): equal to their "
          f"plain versions bit for bit, {n_acc} accepts", flush=True)
    smc_launches = {k: v for k, v in launches.items() if v}
    del mover, act, lp_old, other, logp_fn, u, ue, k_prop, k_fac, r_prop
    del r_fac, lp_new, k_acc, r_acc
    torch.cuda.reset_peak_memory_stats()
    s = smc(SMC_PARTICLES, n_mcmc=SMC_MCMC, mover=mt.FusedStretchMove(),
            seed=0)
    with counting_syncs() as syncs:
        _, secs = fenced(s.run)
    smc_gates("ensemble (FusedStretchMove)", s, secs, syncs, SMC_MCMC)
    if not all(torch.equal(x, y) for x, y in zip(s.state, first.state)):
        raise AssertionError("SMC: two runs of one seed differ")
    print("    a second run of the same seed: the same bits", flush=True)
    del first

    # (f) its resume, stage by stage: half the stages, save, load into a
    # sampler of another seed, the rest; bitwise against the run above
    half = max(1, s.n_stages // 2)
    a = smc(SMC_PARTICLES, n_mcmc=SMC_MCMC, mover=mt.FusedStretchMove(),
            seed=0)
    quiet(lambda: a.run(max_stages=half))
    path, note = saved(a, "smc.npz")
    b = load_checkpoint(smc(SMC_PARTICLES, n_mcmc=SMC_MCMC,
                            mover=mt.FusedStretchMove(), seed=7), path)
    b.run()
    if not (all(torch.equal(x, y) for x, y in zip(s.state, b.state))
            and b.beta_ladder == s.beta_ladder):
        raise AssertionError("SMC resume is not bitwise")
    print(f"  SMC resume after {half} of {s.n_stages} stages: bitwise equal "
          f"to the uninterrupted run; {note} [{card}]", flush=True)
    del s, a, b

    # waste-free (K = 7: M = 2^17 seeds a stage), the JAX test's bounds
    fresh()
    with counting_syncs() as syncs:
        s, secs = fenced(lambda: smc(SMC_PARTICLES, waste_free_k=7,
                                     mover=mt.FusedStretchMove(),
                                     seed=1).run())
    smc_gates("waste-free K=7", s, secs, syncs, 7 / 8, atol_z=0.2)
    del s

    # HMC mutation on TestHMCMutation's 10-D correlated model
    fresh()
    c = 0.5 * np.ones((p, p)) + 0.5 * np.eye(p)
    lam = torch.from_numpy(np.linalg.inv(c).astype(np.float32)).to(dev)
    logdet_c = float(np.linalg.slogdet(c)[1])
    marg = c + 4.0 * np.eye(p)
    y1 = np.ones(p)
    logz_c = float(-0.5 * y1 @ np.linalg.inv(marg) @ y1
                   - 0.5 * np.linalg.slogdet(marg)[1]
                   - p / 2 * np.log(2 * np.pi))
    post_cov = np.linalg.inv(np.linalg.inv(c) + np.eye(p) / 4.0)
    post_mean = post_cov @ (np.linalg.inv(c) @ y1)

    def ll_c(t):
        d = t - 1.0
        return (-0.5 * torch.sum((d @ lam) * d, -1)
                - p / 2 * float(np.log(2 * np.pi)) - 0.5 * logdet_c)

    def smc_hmc():
        return mt.SMCSampler(lp, ll_c, prior, SMC_HMC_PARTICLES, p, n_mcmc=3,
                             seed=0, mutation="hmc", batched=True,
                             device="cuda")

    quiet(lambda: smc_hmc().run(max_stages=1))  # loads the path's kernels
    torch.cuda.reset_peak_memory_stats()
    with counting_syncs() as syncs:
        s, secs = fenced(lambda: smc_hmc().run())
    x = s.state.particles
    notes = [within("log Z", s.log_evidence, logz_c, 0.35),
             within("mean", x.mean(0).cpu(), post_mean, 0.1),
             within("variance", x.var(0, correction=0).cpu(),
                    np.diag(post_cov), 0.15)]
    print(f"  SMC hmc (8 leapfrog steps): N={s.n} P={p}, {s.n_stages} "
          f"stages in {secs:.3f} s, {s.n * 3 * s.n_stages / secs:.6e} "
          f"particle-mutation steps/s, {len(syncs) / s.n_stages:.2f} host "
          f"syncs per stage, peak {peak()}; " + "; ".join(notes)
          + f" [{card}]", flush=True)
    del s, x

    # flow mutation on the bimodal case (tests/test_smc_vi.py:315)
    fresh()
    tau, sep, sig = 3.0, 3.0, 0.6
    m2 = torch.tensor([sep, 0.0], device=dev)
    v2 = tau ** 2 + sig ** 2
    logz_b = -np.log(2 * np.pi * v2) - sep ** 2 / (2 * v2)
    dnorm = float(np.log(2 * np.pi * sig ** 2))

    def lp_b(t):
        return (-0.5 * torch.sum(t * t, -1) / tau ** 2
                - float(np.log(2 * np.pi * tau ** 2)))

    def ll_b(t):
        a_ = -0.5 * torch.sum((t - m2) ** 2, -1) / sig ** 2 - dnorm
        b_ = -0.5 * torch.sum((t + m2) ** 2, -1) / sig ** 2 - dnorm
        return torch.logaddexp(a_, b_) - float(np.log(2.0))

    def prior_b(gen, n):
        return tau * torch.randn((n, 2), generator=gen, device=gen.device)

    def smc_flow():
        return mt.SMCSampler(lp_b, ll_b, prior_b, SMC_FLOW_PARTICLES, 2,
                             n_mcmc=5, seed=3, mutation="flow",
                             flow=mt.RealNVP(2, n_layers=4, hidden=32),
                             flow_fit_steps=200, batched=True, device="cuda")

    quiet(lambda: smc_flow().run(max_stages=1))
    torch.cuda.reset_peak_memory_stats()
    with counting_syncs() as syncs:
        s, secs = fenced(lambda: smc_flow().run())
    x = s.particles
    right = float(np.mean(x[:, 0] > 0))
    in_mode = float(np.mean(np.abs(np.abs(x[:, 0]) - 3.0) < 1.5))
    if not (0.3 < right < 0.7 and in_mode > 0.9
            and abs(s.log_evidence - logz_b) < 0.3):
        raise AssertionError(f"SMC flow: right {right}, in mode {in_mode}, "
                             f"log Z {s.log_evidence} vs {logz_b}")
    print(f"  SMC flow (RealNVP 4x32, 200 refit steps a stage): N={s.n} "
          f"P=2, {s.n_stages} stages in {secs:.3f} s, "
          f"{s.n * 5 * s.n_stages / secs:.6e} particle-mutation steps/s, "
          f"{len(syncs) / s.n_stages:.2f} host syncs per stage, peak "
          f"{peak()}; right-mode share {right:.4f} (bound 0.3-0.7), in a "
          f"mode {in_mode:.4f} (bound > 0.9), log Z off by "
          f"{abs(s.log_evidence - logz_b):.4f} (bound 0.3) [{card}]",
          flush=True)
    del s, x

    # (b) nested sampling on the same 10-D conjugate model
    for kernel, n_live, batch, n_mcmc in (
            ("stretch", NESTED_LIVE, NESTED_BATCH, NESTED_MCMC),
            ("slice", SLICE_LIVE, None, SLICE_MCMC)):
        fresh()

        def nested(seed=0):
            return mt.NestedSampler(lp, ll, prior, p, n_live=n_live,
                                    batch=batch, n_mcmc=n_mcmc, kernel=kernel,
                                    seed=seed, batched=True, device="cuda")

        nested(seed=1).run(max_iters=2)  # loads the path's kernels
        ns = nested()
        with counting_syncs() as syncs:
            r, secs = fenced(ns.run)
        tol = max(3.0 * r.logz_err, 0.15)
        note = within("log Z", r.logz, logz, tol)
        if kernel == "stretch" and r.n_calls != n_live + (
                r.n_iters * ns.batch * n_mcmc):
            raise AssertionError(f"nested n_calls {r.n_calls}")
        if r.n_calls <= n_live:
            raise AssertionError(f"nested slice n_calls {r.n_calls}")
        print(f"  nested {kernel}: n_live={n_live} batch={ns.batch} "
              f"n_mcmc={n_mcmc}, {r.n_iters} iterations in {secs:.3f} s = "
              f"{r.n_iters / secs:.2f} iterations/s, {r.n_calls} likelihood "
              f"calls = {r.n_calls / secs:.6e}/s, {len(syncs) / r.n_iters:.2f} "
              f"host syncs per iteration (the sampler's own count "
              f"{ns.host_syncs / r.n_iters:.2f}), peak {peak()}; {note} "
              f"(logz_err {r.logz_err:.4f}), n_calls identity holds "
              f"[{card}]", flush=True)
        if kernel == "stretch":
            # (f) resume: half the iterations, save, load, the rest
            a = nested()
            a.run(max_iters=r.n_iters // 2)
            path, note = saved(a, "nested.npz")
            b = load_checkpoint(nested(seed=5), path)
            r2 = b.run()
            if not all(np.array_equal(np.asarray(u_), np.asarray(v_))
                       for u_, v_ in zip(r, r2)):
                raise AssertionError("nested resume is not bitwise")
            print(f"  nested resume after {r.n_iters // 2} of {r.n_iters} "
                  f"iterations: bitwise equal result; {note} [{card}]",
                  flush=True)
            del a, b
        del ns

    # (c) NeuTra on Neal's funnel (10-D, σ_v = 3)
    fresh()
    funnel = mt.neal_funnel(p)

    def neutra(seed=0):
        return mt.NeuTra(funnel, p, flow=mt.RealNVP(p, n_layers=6, hidden=64),
                         seed=seed, batched=True, device="cuda")

    with counting_syncs() as syncs:
        nt, secs = fenced(lambda: neutra().fit(
            NEUTRA_FIT, batch=NEUTRA_BATCH, learning_rate=2e-3))
    print(f"  NeuTra fit: RealNVP 6x64, {NEUTRA_FIT} steps of batch "
          f"{NEUTRA_BATCH} in {secs:.3f} s = {NEUTRA_FIT / secs:.2f} fit "
          f"steps/s, {len(syncs)} host syncs, final ELBO "
          f"{nt.fit_result.final_elbo:.4f}, peak {peak()} [{card}]",
          flush=True)
    s = nt.make_sampler(mt.CheesHMCSampler, n_chains=NEUTRA_CHAINS,
                        max_leapfrog=NEUTRA_MAX_LEAPFROG)
    _, warm_s = fenced(lambda: s.warmup(NEUTRA_WARM))
    ok, run_s = fenced(lambda: s.run(NEUTRA_STEPS))
    from mcmcpp_tpu_torch.gradient.chees import n_leapfrog
    leaps = n_leapfrog(s.step_size, s.traj_length, 0.5,
                       NEUTRA_MAX_LEAPFROG)
    if not ok:
        raise AssertionError("NeuTra ChEES: chain capacity hit")
    z = s.get_samples()
    ess = np.asarray(mt.analysis.effective_sample_size(
        torch.from_numpy(z).to(dev)))
    v = nt.transform(z.reshape(-1, p))[:, 0]
    if not (abs(v.mean()) < 0.5 and abs(v.std() - 3.0) < 0.5):
        raise AssertionError(f"NeuTra funnel: v mean {v.mean()}, sd "
                             f"{v.std()}")
    print(f"  NeuTra + ChEES: C={NEUTRA_CHAINS}, warmup {NEUTRA_WARM} in "
          f"{warm_s:.2f} s, {NEUTRA_STEPS} steps in {run_s:.3f} s "
          f"({run_s / NEUTRA_STEPS * 1e3:.1f} ms a transition; step size "
          f"{s.step_size:.4g}, trajectory {s.traj_length:.4g}, {leaps} "
          f"leapfrogs at the mean jitter, cap {NEUTRA_MAX_LEAPFROG}), worst "
          f"z-space ESS {np.nanmin(ess):.0f} = {np.nanmin(ess) / run_s:.6e} "
          f"ESS/s; funnel v mean {v.mean():.4f} (bound |.| < 0.5), sd "
          f"{v.std():.4f} (bound |sd - 3| < 0.5), peak {peak()} [{card}]",
          flush=True)
    del s, z, v
    # (f) fit(1000), save, load, fit(1000, resume=True) against fit(2000)
    a = neutra().fit(NEUTRA_FIT // 2, batch=NEUTRA_BATCH, learning_rate=2e-3)
    path, note = saved(a, "neutra.npz")
    b = load_checkpoint(neutra(seed=5), path)
    b.fit(NEUTRA_FIT // 2, batch=NEUTRA_BATCH, learning_rate=2e-3,
          resume=True)
    if not all(torch.equal(x, y) for x, y in zip(nt.params, b.params)):
        raise AssertionError("NeuTra fit resume is not bitwise")
    print(f"  NeuTra fit resume ({NEUTRA_FIT // 2} + {NEUTRA_FIT // 2} "
          f"against {NEUTRA_FIT}): bitwise equal parameters; {note} "
          f"[{card}]", flush=True)
    del a, b, nt
    # IAF and SplineCoupling round trips on 2^16 rows, each flow trained
    # first, as tests/test_neutra.py:23 trains it (randomly perturbed
    # weights make the spline's quadratic inversion ill-conditioned in
    # float32, in the JAX package as here)
    # bounds (|z - f⁻¹(f(z))|, |logdet sum|): the JAX tests' float32 ones,
    # tests/test_neutra.py:110-111 (IAF) and :233-234 (spline)
    gen = torch.Generator(device=dev).manual_seed(11)
    for flow, (tol_z, tol_ld) in ((mt.IAF(p, hidden=64), (1e-4, 1e-4)),
                                  (mt.SplineCoupling(p, hidden=64),
                                   (5e-4, 2e-3))):
        mt.NeuTra(funnel, p, flow=flow, batched=True, device="cuda").fit(
            ROUND_TRIP_FIT, batch=NEUTRA_BATCH, learning_rate=2e-3)
        with torch.no_grad():
            z0 = torch.randn((ROUND_TRIP_ROWS, p), generator=gen, device=dev)
            (xf, ldf), fwd_s = fenced(lambda: flow(z0))
            (z1, ldi), inv_s = fenced(lambda: flow.inverse(xf))
        err_z = float((z1 - z0).abs().max())
        err_ld = float((ldf + ldi).abs().max())
        if not (err_z < tol_z and err_ld < tol_ld and float(
                ldf.abs().max()) > 1e-3):
            raise AssertionError(f"{type(flow).__name__} round trip: "
                                 f"{err_z}, {err_ld}")
        print(f"  {type(flow).__name__} round trip on {ROUND_TRIP_ROWS} "
              f"rows after {ROUND_TRIP_FIT} fit steps: |z - f⁻¹(f(z))| "
              f"{err_z:.3e} (bound {tol_z:g}), |logdet sum| {err_ld:.3e} "
              f"(bound {tol_ld:g}), forward {fwd_s * 1e3:.2f} ms, "
              f"inverse {inv_s * 1e3:.2f} ms [{card}]", flush=True)

    # (d) ADVI (full rank) and SVGD on the flagship's 10-D Gaussian
    fresh()
    sigma = 0.5 * np.ones((p, p)) + 0.5 * np.eye(p)
    gauss = mt.equicorrelated_gaussian(p, 0.5, device=dev)
    with counting_syncs() as syncs:
        # the default learning rate (1e-2): the 2-D test's 0.05 leaves the
        # last iterate jittering past the bounds in 10-D
        vi, secs = fenced(lambda: mt.ADVI(
            gauss, p, full_rank=True, n_mc=32, batched=True,
            device="cuda").fit(ADVI_STEPS))
    notes = [within("mean", vi.mean, np.zeros(p), 0.1),
             within("covariance", vi.cov, sigma, 0.15)]
    print(f"  ADVI full rank: {ADVI_STEPS} steps in {secs:.3f} s = "
          f"{ADVI_STEPS / secs:.2f} steps/s, {len(syncs)} host syncs, peak "
          f"{peak()}; " + "; ".join(notes) + f" [{card}]", flush=True)
    del vi
    fresh()
    sv = mt.SVGD(gauss, SVGD_PARTICLES, p, batched=True, device="cuda")
    sv.init()
    with counting_syncs() as syncs:
        res, secs = fenced(lambda: sv.fit(SVGD_STEPS))
    x = sv.get_samples()
    hist = res.grad_norm_history.cpu().numpy()
    cov_off = float(np.abs(np.cov(x.T) - sigma).max())
    note = within("mean", x.mean(0), np.zeros(p), 0.1)
    if not hist[-1] < 0.5 * hist[:20].mean():
        raise AssertionError(f"SVGD: |phi| {hist[:3]} ... {hist[-3:]}")
    print(f"  SVGD: N={SVGD_PARTICLES} P={p}, {SVGD_STEPS} steps in "
          f"{secs:.3f} s = {SVGD_STEPS / secs:.2f} steps/s ((N, N) kernel "
          f"{SVGD_PARTICLES ** 2 * 4 / 1e6:.0f} MB, median over "
          f"{SVGD_PARTICLES ** 2} distances), {len(syncs)} host syncs, peak "
          f"{peak()}; {note}; covariance off by {cov_off:.4f} (not gated: "
          f"the median-heuristic kernel narrows the cloud in 10-D); |phi| "
          f"{hist[0]:.4f} -> {hist[-1]:.4f} [{card}]", flush=True)
    del sv, res, x
    # the JAX test's own case (tests/test_svgd.py: 2-D, ρ = 0.8, 512
    # particles, 800 steps) with its bounds
    cov2 = np.array([[1.0, 0.8], [0.8, 1.0]])
    g2 = mt.GaussianTarget.from_cov(cov2, device=dev)
    sv = mt.SVGD(g2, 512, 2, batched=True, device="cuda").init()
    sv.fit(800)
    x = sv.get_samples()
    notes = [within("mean", x.mean(0), np.zeros(2), 0.1),
             within("covariance", np.cov(x.T), cov2, 0.15)]
    print("  SVGD 2-D (tests/test_svgd.py's case): " + "; ".join(notes)
          + f" [{card}]", flush=True)
    del sv, x

    # (e) Pathfinder and MAP/Laplace: the German-credit-shaped logistic
    # regression (N = 1000, P = 25, synthetic) and the 10-D Gaussian
    logit = mt.logistic_regression(n_data=1000, dim=25, seed=0, device=dev)
    for label, target, q in (("logistic N=1000 P=25", logit, 25),
                             ("gaussian P=10", gauss, p)):
        fresh()
        mt.multi_pathfinder(target, 8, np.zeros(q), maxiter=5, batched=True,
                            device="cuda")  # loads the path's kernels
        with counting_syncs() as syncs:
            mp, secs = fenced(lambda: mt.multi_pathfinder(
                target, PATHS, np.zeros(q), batched=True, device="cuda"))
        if not np.isfinite(mp.draws).all():
            raise AssertionError(f"pathfinder {label}: non-finite draws")
        print(f"  multi_pathfinder {label}: {PATHS} paths in {secs:.3f} s "
              f"= {PATHS / secs:.2f} paths/s, {len(syncs)} host syncs "
              f"({len(syncs) / 60:.2f} per L-BFGS iteration), pareto k "
              f"{mp.pareto_k:.3f}, draws mean |.| "
              f"{np.abs(mp.draws.mean(0)).max():.4f}, peak {peak()} "
              f"[{card}]", flush=True)
        fresh()
        starts = torch.randn((MAP_STARTS, q), generator=gen, device=dev)
        res, secs = fenced(lambda: bfgs(target, starts, maxiter=500))
        mr, map_s = fenced(lambda: mt.find_map(target, starts, batched=True,
                                               device="cuda"))
        lap = mt.laplace(target, map_result=mr, batched=True, device="cuda")
        print(f"  BFGS {label}: {MAP_STARTS} starts, "
              f"{int(res.nit.max())} iterations at most (median "
              f"{int(res.nit.float().median())}), {int(res.success.sum())} "
              f"converged, "
              f"{res.host_syncs} host syncs, {secs:.3f} s; find_map "
              f"{map_s:.3f} s, best converged {bool(mr.converged)}, Laplace "
              f"log evidence {float(lap.log_evidence):.4f}, peak {peak()} "
              f"[{card}]", flush=True)
        if q == p:
            # exact on a Gaussian: mean 0, covariance Σ, log evidence
            # logp(0) + P/2 log 2π + ½ log|Σ| with logp(0) = 0
            log_ev = 0.5 * p * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(
                sigma)[1]
            errs = (float(lap.mean.abs().max()),
                    float(np.abs(lap.covariance.cpu().numpy() / sigma
                                 - 1.0).max()),
                    abs(float(lap.log_evidence) / log_ev - 1.0))
            if not (errs[0] < 1e-4 and errs[1] < 1e-4 and errs[2] < 1e-4):
                raise AssertionError(f"Laplace on the Gaussian: {errs}")
            print(f"    Laplace exact on the Gaussian: mean |.| "
                  f"{errs[0]:.2e}, covariance {errs[1]:.2e} relative, log "
                  f"evidence {errs[2]:.2e} relative (bounds 1e-4)",
                  flush=True)
    return smc_launches


# phase 12: the DSL, the GP models and the rest of the analysis layer. (a)
# a hierarchical Bayesian logistic regression at the German-credit shape
# (phase 9 (b)'s data) in the DSL; (b) eight schools through the ported
# example; (c) the GPs at their users' widths; (d) the analysis layer at full
# width. The JAX package's numbers of (b): 512 chains of its ChEES on the
# CPU, 1000 warmup + 4000 steps at thin 2 (R-hat 1.00014), means and MC
# standard errors from its own effective_sample_size; the quadrature of the
# marginal posterior p(mu, tau | y) (theta integrated out) gives 6.4722 and
# 4.7467 (tests/test_torch_examples.py::jax_eight_schools_reference prints
# them all)
DSL_N, DSL_P = 1000, 25
DSL_CHAINS, DSL_WARM, DSL_STEPS = 1 << 14, 300, 200
DSL_WALKERS, DSL_ENSEMBLE_STEPS = 1 << 20, 20
SCHOOLS_CHAINS = 4096
SCHOOLS_JAX = {"mu": (6.477221, 0.004168), "tau": (4.758599, 0.004111)}
GP_N, HSGP_N, HSGP_M = 4096, 1 << 17, 64
# RBF grams whose float32 Cholesky escalates the jitter on the CPU, and the
# level JAX's gram_cholesky picks there (tests/test_torch_gp.py measures the
# same levels with both packages): (points, lengthscale, base jitter, level)
GP_ESCALATING = {
    "48-point grid, l=0.8, jitter 1e-8": (np.linspace(0, 1, 48), 0.8, 1e-8,
                                          2),
    "24 points twice, l=0.8, jitter 1e-8": (
        np.repeat(np.linspace(0, 1, 48)[:24], 2), 0.8, 1e-8, 2),
    "256-point grid, l=0.3, jitter 1e-6": (np.linspace(0, 1, 256), 0.3,
                                           1e-6, 1),
}
AN_STEPS, AN_WALKERS, AN_P = 2000, 1 << 14, 10
SBC_SIMS, SBC_CHAINS, SBC_WARM, SBC_STEPS = 32, 1024, 60, 10
# eight schools: ChEES takes ~30 leapfrogs a transition there, each a
# vmapped DSL logp and its autograd backward, host-bound at ~2.7 ms (83 ms a
# transition on the H100); one check of run_until_converged after 150 steps
# (R-hat and the means are the gates, not its tau-stability rule; at 200 +
# 250 steps R-hat read 1.0042 against 1.01, the means 0.17-0.67 SE)
SCHOOLS_WARM, SCHOOLS_MAX, SCHOOLS_CHECK = 150, 150, 150
# the eight-schools example's posterior predictive thins to this many draws
SCHOOLS_PREDICTIVE = 1000
# a Truncated Gamma observe site with a sampled concentration: its
# normalizer's gradient runs through gammainc's a-derivative
TRUNC_N, TRUNC_LOW = 1000, 0.5


def dsl_logistic(mt, dev):
    """(DSL model, the same posterior written by hand in torch (batched),
    the data target): scale ~ HalfNormal(1), w | scale ~ N(0, scale² I),
    y ~ Bernoulli(logits = X w) on phase 9 (b)'s synthetic data."""
    import torch.nn.functional as F

    from mcmcpp_tpu_torch import dsl

    logit = mt.logistic_regression(n_data=DSL_N, dim=DSL_P, seed=0,
                                   device=dev)
    x_t = logit.x_t
    y = np.asarray(logit.extras["y"], np.float64)
    model = (dsl.Model()
             .param("scale", dsl.HalfNormal(1.0))
             .param("w", lambda p: dsl.Normal(0.0, p["scale"]),
                    shape=(DSL_P,), transform=dsl.Identity())
             .observe("y", lambda p: dsl.Bernoulli(logits=x_t @ p["w"]), y))
    half_log_2pi = 0.5 * np.log(2.0 * np.pi)

    def hand(t):
        u = t[:, 0]
        scale = torch.exp(u)
        w = t[:, 1:]
        lp = (np.log(2.0) - 0.5 * scale * scale - half_log_2pi + u
              - 0.5 * torch.sum(w * w, dim=-1) / (scale * scale)
              - DSL_P * (u + half_log_2pi))
        return lp + torch.sum(F.logsigmoid(logit.sign_t * (t[:, 1:]
                                                           @ x_t.T)), dim=-1)

    return model, hand, logit


def dsl_truncated_gamma():
    """A DSL model whose observe site is a Gamma truncated below with a
    sampled concentration: alpha ~ LogNormal(1, 0.5), rate ~ HalfNormal(2),
    y ~ Gamma(alpha, rate) on [TRUNC_LOW, inf), on TRUNC_N draws of
    Gamma(3, 1.5) above the bound (seed 4)."""
    from mcmcpp_tpu_torch import dsl

    y = np.random.default_rng(4).gamma(3.0, 1.0 / 1.5, 4 * TRUNC_N)
    y = y[y > TRUNC_LOW][:TRUNC_N]
    return (dsl.Model()
            .param("alpha", dsl.LogNormal(1.0, 0.5))
            .param("rate", dsl.HalfNormal(2.0))
            .observe("y", lambda p: dsl.Truncated(
                dsl.Gamma(p["alpha"], p["rate"]), low=TRUNC_LOW), y))


def chees_fit(mt, logp, dim, chains, n_warm, n_steps, seed, card, label):
    """ChEES on a batched logp: warmup, then ``n_steps`` stored; prints
    transitions/s and host syncs per step; returns (samples (S, C, P),
    seconds of the stored steps, syncs per step)."""
    s = mt.CheesHMCSampler(logp, chains, dim, seed=seed, device="cuda")
    s.init_ball(torch.zeros(dim, device="cuda"), 0.1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.warmup(n_warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with counting_syncs() as syncs:
        t0 = time.perf_counter()
        if not s.run(n_steps):
            raise AssertionError(f"{label}: chain capacity hit")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    x = s.get_samples()
    if x.shape != (n_steps, chains, dim) or not np.isfinite(x).all():
        raise AssertionError(f"{label}: stored samples {x.shape}")
    print(f"  {label}: C={chains} P={dim}, warmup {n_warm} in {warm_s:.2f} "
          f"s, {n_steps} steps in {run_s:.3f} s: "
          f"{chains * n_steps / run_s:.6e} transitions/s, "
          f"{len(syncs) / n_steps:.3f} host syncs per step, step "
          f"{float(torch.as_tensor(s.step_size).mean()):.4f}, trajectory "
          f"{s.traj_length:.3f} [{card}]", flush=True)
    return x, run_s, len(syncs) / n_steps


def dsl_gp_analysis(mt, fs, rnd, card, out_dir):
    """Phase 12: the DSL, the GP models and the rest of the analysis layer on
    the card. (a) the DSL's logp and gradient against the same posterior
    written by hand, ChEES on both, and the ensemble sampler with
    FusedStretchMove on the DSL's vmapped logp, whose split kernels are
    counted and held bit for bit against their plain versions; (b) eight
    schools through the ported example against the JAX package's long run;
    (c) the exact GP's log marginal and gradient against float64
    numpy/scipy, gram_cholesky's jitter level against JAX's, the HSGP's
    marginal and gradient at 2^17 points; (d) global_stats on a 1.3 GB
    chain against the local functions, ksd, bridge sampling, the scores and
    sbc_model. Returns {kernel: launches on the DSL path}."""
    import scipy.linalg as sla

    from mcmcpp_tpu_torch.analysis import global_stats as gs
    from mcmcpp_tpu_torch.examples import hierarchical
    from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad
    from mcmcpp_tpu_torch.models import gp, hsgp

    dev = torch.device("cuda")
    an = mt.analysis

    def fenced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- (a) the DSL on the logistic regression -----------------------------
    model, hand, logit = dsl_logistic(mt, dev)
    logp, dim, constrain = model.build()
    vlogp = torch.func.vmap(logp)
    q = 0.3 * torch.randn((DSL_CHAINS, dim), device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    (lp_d, g_d), t_d = fenced(lambda: logp_and_grad(vlogp, q))
    (lp_h, g_h), t_h = fenced(lambda: logp_and_grad(hand, q))
    for _ in range(3):  # warm, then time 20 calls of each
        logp_and_grad(vlogp, q)
        logp_and_grad(hand, q)
    _, t_d = fenced(lambda: [logp_and_grad(vlogp, q) for _ in range(20)])
    _, t_h = fenced(lambda: [logp_and_grad(hand, q) for _ in range(20)])
    err_lp = float(((lp_d - lp_h).abs() / lp_h.abs()).max())
    err_g = float(((g_d - g_h).abs().max(dim=1).values
                   / g_h.abs().max(dim=1).values).max())
    print(f"  DSL logistic regression (N={DSL_N}, {DSL_P} coefficients and a "
          f"HalfNormal scale, dim {dim}) at {DSL_CHAINS} random theta: logp "
          f"within {err_lp:.3e} and its gradient within {err_g:.3e} relative "
          f"of the hand-written torch posterior (bound 1e-5); logp_and_grad "
          f"{t_d / 20 * 1e3:.3f} ms (DSL, vmapped) against {t_h / 20 * 1e3:.3f}"
          f" ms (hand-written) [{card}]", flush=True)
    if not (err_lp <= 1e-5 and err_g <= 1e-5):
        raise AssertionError("the DSL's logp or gradient differs from the "
                             "hand-written posterior")

    # the Truncated Gamma site: its gradient in the concentration runs the
    # incomplete gamma's a-derivative, whose series stops once the whole
    # vmapped batch has converged; timed against every term run
    from mcmcpp_tpu_torch.ops import special

    tlogp, tdim, _ = dsl_truncated_gamma().build()
    vtlogp = torch.func.vmap(tlogp)
    qt = (torch.tensor([np.log(3.0), np.log(1.5)], dtype=torch.float32,
                       device=dev)
          + 0.3 * torch.randn((DSL_CHAINS, tdim), device=dev,
                              generator=torch.Generator(dev).manual_seed(5)))
    (lp_t, g_t), _ = fenced(lambda: logp_and_grad(vtlogp, qt))
    lp_ref, g_ref = logp_and_grad(torch.func.vmap(tlogp), qt[:64].cpu().double())
    e_tv = float(((lp_t[:64].cpu().double() - lp_ref).abs()
                  / lp_ref.abs()).max())
    e_tg = float(((g_t[:64].cpu().double() - g_ref).abs().max(dim=1).values
                  / g_ref.abs().max(dim=1).values).max())
    _, t_stop = fenced(lambda: [logp_and_grad(vtlogp, qt) for _ in range(5)])
    all_done = special._all_done
    special._all_done = lambda live, term: False
    try:
        logp_and_grad(vtlogp, qt)
        _, t_full = fenced(lambda: [logp_and_grad(vtlogp, qt)
                                    for _ in range(2)])
    finally:
        special._all_done = all_done
    print(f"  DSL Truncated Gamma site (N={TRUNC_N}, sampled concentration "
          f"and rate) at {DSL_CHAINS} random theta: logp within {e_tv:.2e} "
          f"and gradient within {e_tg:.2e} relative of the same logp in "
          f"float64 on the host (64 rows; bounds 1e-4, 1e-3); "
          f"logp_and_grad {t_stop / 5 * 1e3:.3f} ms, with every series and "
          f"fraction term run {t_full / 2 * 1e3:.3f} ms [{card}]",
          flush=True)
    if not (torch.isfinite(g_t).all() and e_tv <= 1e-4 and e_tg <= 1e-3):
        raise AssertionError("the Truncated Gamma DSL logp or its gradient "
                             "differs from its float64 value")
    del qt, lp_t, g_t
    fits = {}
    for label, fn, seed in [("DSL", vlogp, 11), ("hand-written", hand, 12)]:
        x, run_s, _ = chees_fit(mt, fn, dim, DSL_CHAINS, DSL_WARM,
                                DSL_STEPS, seed, card, f"ChEES on the "
                                f"{label} logistic posterior")
        rhat = an.potential_scale_reduction(x, rank_normalized=False)
        xt = torch.from_numpy(x).to(dev)
        ess = np.asarray(an.effective_sample_size(xt))
        flat = xt.reshape(-1, dim).double()
        fits[label] = (flat.mean(0).cpu().numpy(), flat.var(0).cpu().numpy(),
                       ess, rhat)
        print(f"    R-hat max {rhat.max():.5f} (bound 1.01), worst ESS "
              f"{np.nanmin(ess):.0f}", flush=True)
        if not rhat.max() < 1.01:
            raise AssertionError(f"ChEES on the {label} posterior: R-hat "
                                 f"{rhat.max()}")
        del x, xt, flat
    (m_d, v_d, e_d, _), (m_h, v_h, e_h, _) = fits["DSL"], fits["hand-written"]
    z = np.abs(m_d - m_h) / np.sqrt(v_d / e_d + v_h / e_h)
    print(f"    DSL and hand-written posterior means within {z.max():.2f} MC "
          "standard errors (bound 5)", flush=True)
    within_5se("DSL against hand-written means", float(z.max()))

    class Capturing(mt.FusedStretchMove):
        """FusedStretchMove that keeps the inputs of its first half-step."""

        captured = None

        def apply(self, active, active_logp, other, logp_fn, state, noise,
                  beta=1.0):
            if self.captured is None:
                self.captured = (active, active_logp, other, noise, logp_fn)
            return super().apply(active, active_logp, other, logp_fn, state,
                                 noise, beta)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mover = Capturing()
    s = mt.EnsembleSampler(logp, DSL_WALKERS, dim, mover=mover, seed=0,
                           device="cuda")
    s.init_ball(np.zeros(dim), 0.1)
    reset_launches(fs)
    (_, secs) = fenced(lambda: s.run_mcmc(DSL_ENSEMBLE_STEPS, store=False))
    launches = dict(fs.LAUNCHES)
    want = 2 * DSL_ENSEMBLE_STEPS
    if launches != {"fused_stretch_wide": 0, "fused_stretch_half": 0,
                    "stretch_propose": want,
                    "stretch_accept": want}:
        raise AssertionError(f"the DSL ensemble launched {launches}, expected "
                             f"{want} of each split kernel")
    act, lp_old, other, (shift, key), logp_fn = mover.captured
    u, ue = rnd.philox_unit_uniforms(key, act.shape[0], dev)
    k_prop, k_fac = fs.stretch_propose(act, other, shift, key)
    r_prop, r_fac = fs.stretch_propose_reference(act, other, shift, u)
    lp_new = logp_fn(r_prop)
    k_acc = fs.stretch_accept(act, r_prop, lp_old, lp_new, r_fac, key)
    r_acc = fs.stretch_accept_reference(act, r_prop, lp_old, lp_new, r_fac,
                                        ue)
    torch.cuda.synchronize()
    same = (torch.equal(k_prop, r_prop) and torch.equal(k_fac, r_fac)
            and all(torch.equal(a, b) for a, b in zip(k_acc, r_acc)))
    n_acc = int(r_acc[2].sum())
    if not same or not 0 < n_acc < act.shape[0]:
        raise AssertionError("DSL half-step inputs: a split kernel differs "
                             f"from its plain version ({n_acc} accepts)")
    acc = float(np.mean(s.acceptance_fraction))
    print(f"  EnsembleSampler + FusedStretchMove on the DSL's vmapped logp, "
          f"W={DSL_WALKERS} P={dim}: {DSL_ENSEMBLE_STEPS} steps in "
          f"{secs:.3f} s = {DSL_WALKERS * DSL_ENSEMBLE_STEPS / secs:.6e} "
          f"walker-updates/s, acceptance {acc:.3f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; split "
          f"kernels {launches}; on one half-step's inputs (n={act.shape[0]}"
          f") stretch_propose and stretch_accept equal their plain versions "
          f"bit for bit, {n_acc} accepts [{card}]", flush=True)
    dsl_launches = {k: v for k, v in launches.items() if v}
    del mover, s, act, lp_old, other, logp_fn, u, ue, k_prop, k_fac, r_prop
    del r_fac, lp_new, k_acc, r_acc, q, lp_d, g_d, lp_h, g_h
    torch.cuda.empty_cache()

    # -- (b) eight schools through the ported example ------------------------
    (out, secs) = fenced(lambda: hierarchical.run(
        chains=SCHOOLS_CHAINS, warmup=SCHOOLS_WARM, max_steps=SCHOOLS_MAX,
        check_every=SCHOOLS_CHECK, device="cuda"))
    rep, draws, sch = out["report"], out["draws"], out["sampler"]
    steps = draws["mu"].shape[0] // SCHOOLS_CHAINS
    notes = []
    zs = []
    for name, (jmean, jse) in SCHOOLS_JAX.items():
        v = draws[name].reshape(steps, SCHOOLS_CHAINS)
        ess = float(an.effective_sample_size(torch.from_numpy(v[:, :, None])
                                             .to(dev))[0])
        se = v.std() / np.sqrt(ess)
        z = abs(v.mean() - jmean) / np.sqrt(se ** 2 + jse ** 2)
        zs.append(z)
        notes.append(f"{name} {v.mean():.5f} (JAX {jmean}; {z:.2f} SE, ESS "
                     f"{ess:.0f})")
    print(f"  eight schools (the ported example), {SCHOOLS_CHAINS} chains: "
          f"{rep.reason}, {rep.steps_run} steps, R-hat max "
          f"{np.max(rep.rhat):.5f} (bound 1.01), {secs:.1f} s; "
          + "; ".join(notes) + f" [{card}]", flush=True)
    if not np.max(rep.rhat) < 1.01:
        raise AssertionError(f"eight schools: R-hat {np.max(rep.rhat)} "
                             f"({rep.reason})")
    within_5se("eight schools against the JAX package's run", *zs)
    # the posterior predictive, as the example's main takes it (thinned to
    # SCHOOLS_PREDICTIVE draws) and on every stored draw: y_rep - theta is
    # N(0, sigma^2) noise, whose mean and variance are held to 5 standard
    # errors
    flat, model = out["flat"], out["model"]
    constrain = model.build()[2]
    gen = torch.Generator(dev).manual_seed(1)
    pp, zs = [], []
    for take in (flat[::max(1, len(flat) // SCHOOLS_PREDICTIVE)], flat):
        (y_rep, secs) = fenced(
            lambda: model.posterior_predictive(gen, take)["y"])
        resid = (y_rep - constrain(take)["theta"]) / hierarchical.SIGMA
        n = len(take)
        zs += [float(np.max(np.abs(resid.mean(0)) * np.sqrt(n))),
               float(np.max(np.abs(resid.var(0) - 1.0) / np.sqrt(2.0 / n)))]
        pp.append(f"{n} draws in {secs * 1e3:.1f} ms (y_rep - theta: mean "
                  f"{zs[-2]:.2f} SE from 0, variance {zs[-1]:.2f} SE from "
                  "sigma^2)")
    print("  eight schools posterior predictive: " + "; ".join(pp)
          + f" [{card}]", flush=True)
    within_5se("eight schools posterior predictive", *zs)
    del out, draws, sch, flat, model, y_rep, resid
    torch.cuda.empty_cache()

    # -- (c) the Gaussian processes ------------------------------------------
    rng = np.random.default_rng(12)
    xs = np.sort(rng.uniform(0.0, 10.0, GP_N))
    ys = np.sin(xs) + 0.1 * rng.standard_normal(GP_N)
    ell0, noise = 0.7, 0.1
    ell = torch.tensor(ell0, dtype=torch.float64, device=dev,
                       requires_grad=True)
    xs_t = torch.from_numpy(xs).to(dev)
    ys_t = torch.from_numpy(ys).to(dev)

    def marginal():
        lm = gp.gp_log_marginal(gp.RBF(ell, 1.0) + gp.WhiteNoise(1e-6), xs_t,
                                ys_t, noise)
        (g,) = torch.autograd.grad(lm, ell)
        return lm.detach(), g

    marginal()
    (lm, g), t_gp = fenced(marginal)
    d2 = (xs[:, None] - xs[None, :]) ** 2
    k_rbf = np.exp(-0.5 * d2 / ell0 ** 2)
    k = k_rbf + (1e-6 + noise ** 2 + 1e-6) * np.eye(GP_N)
    t0 = time.perf_counter()
    cf = sla.cho_factor(k, lower=True)
    alpha = sla.cho_solve(cf, ys)
    want = (-0.5 * ys @ alpha - np.sum(np.log(np.diag(cf[0])))
            - GP_N / 2 * np.log(2 * np.pi))
    dk = k_rbf * d2 / ell0 ** 3
    kinv = sla.cho_solve(cf, np.eye(GP_N))
    dwant = 0.5 * alpha @ dk @ alpha - 0.5 * np.sum(kinv * dk)
    ref_s = time.perf_counter() - t0
    e_v = abs(float(lm) - want) / abs(want)
    e_g = abs(float(g) - dwant) / abs(dwant)
    print(f"  gp_log_marginal, RBF + white noise, N={GP_N} float64: "
          f"{float(lm):.6f} and d/d(lengthscale) {float(g):.6f}, {e_v:.2e} "
          f"and {e_g:.2e} relative from numpy/scipy float64 (bounds 1e-9, "
          f"1e-6); {t_gp * 1e3:.2f} ms on the card (value and gradient), "
          f"{ref_s:.2f} s for the host reference [{card}]", flush=True)
    if not (e_v <= 1e-9 and e_g <= 1e-6):
        raise AssertionError("gp_log_marginal differs from numpy/scipy")
    for label, (pts, lscale, jitter, level) in GP_ESCALATING.items():
        kk = gp.RBF(lscale, 1.0).gram(torch.tensor(pts[:, None],
                                                   dtype=torch.float32,
                                                   device=dev))
        (got, secs) = fenced(lambda: int(gp.jitter_level(kk, jitter)))
        chol = gp.gram_cholesky(gp.RBF(lscale, 1.0),
                                torch.tensor(pts[:, None],
                                             dtype=torch.float32,
                                             device=dev), jitter=jitter)
        recon = float((chol @ chol.T - kk - jitter * 10.0 ** got
                       * torch.eye(len(pts), device=dev)).abs().max())
        print(f"  gram_cholesky, {label}: jitter level {got} (JAX on the CPU: "
              f"{level}), factor reproduces the Gram to {recon:.2e}, level "
              f"picked in {secs * 1e3:.2f} ms [{card}]", flush=True)
        if got != level or not recon <= 1e-4:
            raise AssertionError(f"gram_cholesky {label}: level {got}, JAX "
                                 f"picks {level}")
    xh = rng.uniform(-5.0, 5.0, HSGP_N)
    yh = (np.sin(xh) + 0.1 * rng.standard_normal(HSGP_N)).astype(np.float32)
    (basis, secs_basis) = fenced(lambda: hsgp.HSGP(xh, m=HSGP_M, c=1.5,
                                                   kernel="matern52",
                                                   device="cuda"))
    yh_t = torch.from_numpy(yh).to(dev)
    hyper = torch.tensor([np.log(0.8), 0.0, np.log(0.1)], device=dev,
                         requires_grad=True)

    def hmarg():
        lm = hsgp.hsgp_log_marginal(basis, torch.exp(hyper[0]),
                                    torch.exp(hyper[1]), yh_t,
                                    torch.exp(hyper[2]))
        (g,) = torch.autograd.grad(lm, hyper)
        return lm.detach(), g

    hmarg()
    (hl, hg), t_h = fenced(hmarg)
    phi = basis.phi.double().cpu().numpy()

    def np_hmarg(h):
        s = (hsgp.spectral_density("matern52",
                                   basis.sqrt_lam.double().cpu(),
                                   float(np.exp(h[0])),
                                   float(np.exp(h[1]))).numpy() + 1e-6)
        sn2 = float(np.exp(h[2])) ** 2 + 1e-6
        a = sn2 * np.diag(1.0 / s) + phi.T @ phi
        c = np.linalg.cholesky(a)
        py = phi.T @ yh.astype(np.float64)
        w = sla.cho_solve((c, True), py)
        quad = (yh.astype(np.float64) @ yh - py @ w) / sn2
        logdet = (2 * np.sum(np.log(np.diag(c))) + np.sum(np.log(s))
                  + (HSGP_N - HSGP_M) * np.log(sn2))
        return -0.5 * (quad + logdet + HSGP_N * np.log(2 * np.pi))

    h0 = hyper.detach().double().cpu().numpy()
    hwant = np_hmarg(h0)
    hdwant = np.array([(np_hmarg(h0 + 1e-5 * e) - np_hmarg(h0 - 1e-5 * e))
                       / 2e-5 for e in np.eye(3)])
    e_v = abs(float(hl) - hwant) / abs(hwant)
    e_g = float(np.max(np.abs(hg.double().cpu().numpy() - hdwant))
                / np.max(np.abs(hdwant)))
    print(f"  HSGP (Matern 5/2, m={HSGP_M}) at N={HSGP_N}, float32: basis in "
          f"{secs_basis * 1e3:.1f} ms; hsgp_log_marginal {float(hl):.3f} "
          f"{e_v:.2e} relative from float64 numpy (bound 1e-4), its gradient "
          f"in (log l, log var, log noise) {e_g:.2e} relative from float64 "
          f"central differences (bound 1e-2); {t_h * 1e3:.2f} ms for value "
          f"and gradient [{card}]", flush=True)
    if not (e_v <= 1e-4 and e_g <= 1e-2):
        raise AssertionError("hsgp_log_marginal differs from float64 numpy")
    del basis, phi
    torch.cuda.empty_cache()

    # -- (d) the analysis layer at full width ---------------------------------
    gen = torch.Generator(dev).manual_seed(21)
    phis = torch.linspace(0.2, 0.9, AN_P, device=dev)
    chain = torch.empty((AN_STEPS, AN_WALKERS, AN_P), device=dev)
    chain[0] = torch.randn((AN_WALKERS, AN_P), device=dev, generator=gen)
    innov = torch.sqrt(1 - phis ** 2)
    for t in range(1, AN_STEPS):
        chain[t] = phis * chain[t - 1] + innov * torch.randn(
            (AN_WALKERS, AN_P), device=dev, generator=gen)
    n_all = AN_STEPS * AN_WALKERS
    rows = []
    for label, glob, loc, rtol in [
            ("autocorr_time", lambda: gs.global_autocorr_time(chain),
             lambda: an.autocorr_time(chain), 0.0),
            ("covariance_matrix", lambda: gs.global_covariance_matrix(chain),
             lambda: an.covariance_matrix(chain), 1e-4),
            ("split R-hat", lambda: gs.global_split_rhat(chain),
             lambda: an.potential_scale_reduction(chain,
                                                  rank_normalized=False),
             1e-10),
            ("bulk ESS", lambda: gs.global_ess_bulk(chain, max_knots=n_all),
             lambda: an.ess_bulk(chain), 1e-9),
            ("tail ESS", lambda: gs.global_ess_tail(chain, max_knots=n_all),
             lambda: an.ess_tail(chain), 1e-9)]:
        g_v, g_s = fenced(glob)
        l_v, l_s = fenced(loc)
        g_v, l_v = np.asarray(g_v, np.float64), np.asarray(l_v, np.float64)
        # an unclosed ACT window gives NaN on both sides, or it fails
        nan = np.isnan(l_v)
        err = (float(np.max(np.abs(g_v - l_v)[~nan]
                            / np.maximum(np.abs(l_v[~nan]), 1e-300)))
               if (np.isnan(g_v) == nan).all() and not nan.all()
               else float("inf"))
        rows.append(f"{label} {err:.1e} ({g_s:.2f} s global, {l_s:.2f} s "
                    "local)")
        if not err <= rtol:
            raise AssertionError(f"global {label} differs from the local "
                                 f"function by {err} (bound {rtol})")
    print(f"  global_stats on a ({AN_STEPS}, {AN_WALKERS}, {AN_P}) float32 "
          f"chain on the card ({chain.numel() * 4 / 1e9:.2f} GB) against the "
          f"local functions, largest relative difference: " + "; ".join(rows)
          + f" [{card}]", flush=True)
    del chain
    torch.cuda.empty_cache()

    xk = torch.randn((1 << 14, AN_P), device=dev, generator=gen)

    def score_fn(t):
        return -0.5 * torch.sum(t * t, dim=-1)

    (k_exact, secs) = fenced(lambda: an.ksd(xk, score_fn=score_fn))
    k_wide = an.ksd(1.3 * xk, score_fn=score_fn)
    k_shift = an.ksd(xk + 0.3, score_fn=score_fn)
    print(f"  ksd on {xk.shape[0]} x {AN_P} draws: exact {k_exact:.5f}, "
          f"over-dispersed (1.3x) {k_wide:.5f}, shifted (+0.3) "
          f"{k_shift:.5f} (each must be > 5x exact); {secs * 1e3:.1f} ms "
          f"[{card}]", flush=True)
    if not (k_wide > 5 * k_exact and k_shift > 5 * k_exact):
        raise AssertionError("ksd does not rank exact draws first")
    del xk

    # bridge sampling on the 10-D conjugate Gaussian: theta ~ N(0, 4 I),
    # y_i ~ N(theta, I), i = 1..4
    yb = rng.normal(1.0, 1.0, size=(4, AN_P))
    ybt = torch.tensor(yb, dtype=torch.float32, device=dev)

    def logpost(t):
        return (-0.5 * (t * t).sum(-1) / 4.0
                - AN_P / 2 * np.log(2 * np.pi * 4.0)
                - 0.5 * ((ybt[None] - t[:, None, :]) ** 2).sum((1, 2))
                - 4 * AN_P / 2 * np.log(2 * np.pi))

    cov = 4.0 * np.ones((4, 4)) + np.eye(4)
    logz = sum(-0.5 * yb[:, d] @ np.linalg.solve(cov, yb[:, d])
               - 0.5 * np.linalg.slogdet(cov)[1] - 2 * np.log(2 * np.pi)
               for d in range(AN_P))
    prec = 0.25 + 4
    exact = (yb.sum(0) / prec + prec ** -0.5
             * rng.standard_normal((1 << 14, AN_P)))
    (br, secs) = fenced(lambda: an.bridge_log_evidence(
        logpost, torch.from_numpy(exact).to(dev), seed=1))
    print(f"  bridge_log_evidence, 10-D conjugate Gaussian, {1 << 14} exact "
          f"draws: {br.logz:.4f} against {logz:.4f} (bound 0.05), "
          f"{br.n_iter} iterations, relative ESS {br.rel_ess:.3f}, "
          f"{secs:.2f} s [{card}]", flush=True)
    if not (br.converged and abs(br.logz - logz) <= 0.05):
        raise AssertionError("bridge sampling misses the closed form")

    xs_c = rng.standard_normal((1000, 1024)).astype(np.float32)
    ob = rng.standard_normal(1000).astype(np.float32)
    (crps, secs_c) = fenced(lambda: an.crps_ensemble(
        torch.from_numpy(xs_c).to(dev), torch.from_numpy(ob).to(dev)))
    # float64 numpy from the definition (all pairwise differences) on the
    # first 100 locations
    x64 = xs_c[:100].astype(np.float64)
    pair = np.abs(x64[:, :, None] - x64[:, None, :]).sum((1, 2)) / (
        1024 * 1023)
    want_c = np.abs(x64 - ob[:100, None]).mean(1) - 0.5 * pair
    e_c = float(np.max(np.abs(crps[:100].cpu().numpy() - want_c)
                       / np.abs(want_c)))
    xe = rng.standard_normal((4096, AN_P)).astype(np.float32)
    oe = rng.standard_normal(AN_P).astype(np.float32)
    (es, secs_e) = fenced(lambda: an.energy_score(
        torch.from_numpy(xe).to(dev), torch.from_numpy(oe).to(dev)))
    xe64 = xe.astype(np.float64)
    pair = sum(np.linalg.norm(xe64[j] - xe64, axis=1).sum()
               for j in range(4096)) / (4096 * 4095)
    want_e = np.linalg.norm(xe64 - oe, axis=1).mean() - 0.5 * pair
    e_e = abs(float(es) - want_e) / abs(want_e)
    print(f"  crps_ensemble (1000 locations x 1024 draws) {e_c:.2e} and "
          f"energy_score (4096 x {AN_P}) {e_e:.2e} relative from float64 "
          f"numpy (bounds 1e-5, 1e-4); {secs_c * 1e3:.2f} and "
          f"{secs_e * 1e3:.2f} ms [{card}]", flush=True)
    if not (e_c <= 1e-5 and e_e <= 1e-4):
        raise AssertionError("a scoring rule differs from float64 numpy")

    from mcmcpp_tpu_torch.dsl import Model, Normal

    def build_model(sim):
        y = np.zeros(8) if sim is None else sim["y"]
        return (Model().param("theta", Normal(0.0, 1.5))
                .observe("y", lambda p: Normal(p["theta"], 1.0), y))

    def fit(g, lp, d):
        seed = int(torch.randint(1 << 30, (), generator=g, device=g.device))
        s = mt.CheesHMCSampler(torch.func.vmap(lp), SBC_CHAINS, d, seed=seed,
                               device="cuda")
        s.init_ball(torch.zeros(d, device=dev), 0.5)
        s.warmup(SBC_WARM)
        s.run(SBC_STEPS)
        return s.state.position  # the chains' last states: L = 1024

    (res, secs) = fenced(lambda: an.sbc_model(build_model, fit, SBC_SIMS,
                                              seed=5, device="cuda"))
    ranks, n_draws = res
    stat, pval = an.sbc_uniformity(ranks, n_draws)
    print(f"  sbc_model, conjugate normal model, {SBC_SIMS} simulations each "
          f"fit by ChEES at {SBC_CHAINS} chains ({SBC_WARM} + {SBC_STEPS} "
          f"steps, L = {n_draws}): chi2 {stat[0]:.2f}, p {pval[0]:.4f} (must "
          f"not reject at 0.01); {secs:.1f} s [{card}]", flush=True)
    if not pval[0] > 0.01:
        raise AssertionError(f"sbc_model rejects uniformity: p={pval[0]}")
    return dsl_launches


def dsl_launch_count(mt, card):
    """Phase 12 (a)'s launches per logp-and-gradient evaluation, DSL against
    hand-written, and the Truncated Gamma model's, under the profiler: after
    phase 7, as no timing may follow a profiler window in this process."""
    from mcmcpp_tpu_torch.gradient.hmc import logp_and_grad

    dev = torch.device("cuda")
    model, hand, _ = dsl_logistic(mt, dev)
    logp, dim, _ = model.build()
    vlogp = torch.func.vmap(logp)
    q = 0.3 * torch.randn((DSL_CHAINS, dim), device=dev)
    tlogp, tdim, _ = dsl_truncated_gamma().build()
    qt = (torch.tensor([np.log(3.0), np.log(1.5)], dtype=torch.float32,
                       device=dev)
          + 0.3 * torch.randn((DSL_CHAINS, tdim), device=dev))
    out = []
    for label, fn, q in [("DSL", vlogp, q), ("hand-written", hand, q),
                         ("DSL Truncated Gamma", torch.func.vmap(tlogp), qt)]:
        logp_and_grad(fn, q)
        rows = device_rows_per_step(lambda: logp_and_grad(fn, q), 1)
        n = sum(c for c, _ in rows.values())
        us = sum(u for _, u in rows.values())
        out.append(f"{label} {n:g} launches, {us:.1f} us of device time")
    print(f"  launches per logp-and-gradient evaluation at {DSL_CHAINS} "
          f"chains (the logistic posterior of phase 12 (a), and its "
          f"Truncated Gamma model): "
          + "; ".join(out) + f" [{card}]", flush=True)


# phase 13: the time-series layer at its users' widths, on synthetic data
# made from fixed seeds. (a) Kalman: a local-linear-trend + weekly-seasonal
# model (D = 8, E = 1) over T = 2^16 steps (180 years of a daily series,
# 7.5 of an hourly one), 5% of them missing: the parallel filter, the
# gradient, the smoother and FFBS over all of it, the sequential filter (a
# loop of ~40 launches a step) over the first TS_SEQ_T steps; the
# LGSSKernel Gibbs loop at 1024 chains on the state-space example's local
# level. (b) an HMM with K = 8 Gaussian regimes over HMM_T = 2^14 steps
# (every pass but the parallel forward is a loop over T: the length is cut,
# the widths are not), its Gibbs loop at 1024 chains over TS_HMM_GIBBS_T.
# (c) the particle filters on the state-space example's stochastic-
# volatility model over T = 1000 daily returns: single filters at 2^18
# particles, the smoother and the forecast; PMMH at 256 chains × 1024
# particles over the first PMMH_T returns (a PMMH step is T filter steps);
# PGAS at 256 × 64. (d) the RBPF on the regime-switching example (2^14
# particles, T = 1000), (e) IF2 on the ssm_mle example (2^16 particles,
# T = 150, 30 passes), (f) IBIS on the streaming example (2^16 particles,
# 2000 rows in batches of 5) and SMC² (1024 θ × 1024 x-particles, T = 200),
# (g) the EnKF and ETKF on Lorenz-96 (D = 40, 1024 members, T = 1000; the
# ETKF, an (N, N) eigh a step, over the example's T = 400), (h)
# the UKF/URTS and EKI/EKS cases of tests/test_ukf.py and tests/test_eks.py
# (the EKS ensemble 2^14), (i) the bitwise resumes of PMMH, IBIS and SMC² at
# those widths.
TS_T, TS_SEQ_T = 1 << 16, 1 << 12
TS_DRAWS = 256
TS_GIBBS_CHAINS, TS_GIBBS_SWEEPS = 1024, 50
HMM_K, HMM_T, HMM_PATHS = 8, 1 << 14, 1024
TS_HMM_GIBBS_T, HMM_GIBBS_SWEEPS = 4096, 10
SV_T = 1000
PF_N, PF_SEEDS = 1 << 18, 8
GUIDED_N, GUIDED_SEEDS = 1 << 14, 8
PMMH_CHAINS, PMMH_N, PMMH_T = 256, 1024, 200
PMMH_TUNE, PMMH_WINDOW, PMMH_STEPS = 25, 25, 25
SMOOTH_N, SMOOTH_J, FORECAST_H = 1 << 14, 1024, 30
PGAS_CHAINS, PGAS_N, PGAS_SWEEPS = 256, 64, 10
RBPF_N, RBPF_T = 1 << 14, 1000
IF2_N, IF2_T, IF2_ITERS = 1 << 16, 150, 30
IBIS_N, IBIS_ROWS, IBIS_BATCH = 1 << 16, 2000, 5
SMC2_M, SMC2_NX, SMC2_T = 1024, 1024, 200
ENKF_N, ENKF_T, ETKF_T = 1024, 1000, 400
EKS_J = 1 << 14
RESUME_STEPS = 3


def ts_fenced(fn):
    """(result, wall seconds, host seconds to enqueue) of ``fn()`` between
    two device fences."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, enqueue


def ts_peak():
    return f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB"


def ts_check(label, ok, detail):
    if not ok:
        raise AssertionError(f"{label}: {detail}")


def block_syncs(gb):
    """Host syncs of one sweep, and of each block's kernel alone (a dict)."""
    from mcmcpp_tpu_torch import gibbs as tg

    with counting_syncs() as syncs:
        gb.state = gb.sweep(gb.state)
    per = {}
    for name, _, kernel in gb.blocks:
        others = {n: v for n, v in gb.state.items() if n != name}
        with counting_syncs() as s:
            tg._kernel_step(kernel, gb._step_gen, gb.state[name], others)
        per[name] = len(s)
    return len(syncs), per


def simulate_lgss(p, t_n, rng, missing):
    """Draws (x (T, D), y (T,)) from a time-invariant LGSS on the host in
    float64, from x_1 = 0, NaN where a step is missing."""
    a, q, h, r = (p.A.double().cpu().numpy(), p.Q.double().cpu().numpy(),
                  p.H.double().cpu().numpy(), p.R.double().cpu().numpy())
    d = a.shape[0]
    lq = np.linalg.cholesky(q + 1e-12 * np.eye(d))
    x = np.zeros((t_n, d))
    noise = rng.standard_normal((t_n, d)) @ lq.T
    for t in range(1, t_n):
        x[t] = a @ x[t - 1] + noise[t]
    y = (x @ h.T)[:, 0] + np.sqrt(r[0, 0]) * rng.standard_normal(t_n)
    y[rng.random(t_n) < missing] = np.nan
    return x, y


def ts_kalman(mt, card):
    """(a): both filters at T = 2^16, the gradient, FFBS, the smoother,
    the forecast and the LGSSKernel Gibbs loop."""
    from mcmcpp_tpu_torch.examples import state_space as ss
    from mcmcpp_tpu_torch.models import lgss as tl

    dev = torch.device("cuda")

    def model(dtype, scales):
        sl, ssl, sg, so = scales
        comp = [tl.local_linear_trend(sl, ssl, dtype=dtype, device=dev),
                tl.seasonal(7, sg, dtype=dtype, device=dev)]
        return tl.structural(comp, so, p0_scale=100.0, dtype=dtype)

    # a slowly drifting slope keeps the level within ~100 over 2^16 steps,
    # so float32 keeps the innovations' digits
    scales = (0.05, 1e-5, 0.02, 0.5)
    p = model(torch.float32, scales)
    rng = np.random.default_rng(1301)
    x_true, y = simulate_lgss(p, TS_T, rng, 0.05)
    ys = torch.tensor(y, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    tl.kalman_filter(p, ys[:64])  # first-use library set-up
    with counting_syncs() as syncs:
        par, par_s, _ = ts_fenced(lambda: tl.kalman_filter(p, ys))
    n_sync = len(syncs)
    # the sequential filter (a loop of ~40 launches a step) over the first
    # TS_SEQ_T steps, against the parallel one over the same
    short = ys[:TS_SEQ_T]
    seq, seq_s, seq_enq = ts_fenced(
        lambda: tl.kalman_filter(p, short, method="sequential"))
    par_short = tl.kalman_filter(p, short)
    p64 = model(torch.float64, scales)
    ref = tl.kalman_filter(p64, ys.double())
    ref_short = tl.kalman_filter(p64, short.double())
    scale = float(ref.means.abs().max())
    err_par = float((par.means.double() - ref.means).abs().max()) / scale
    err_seq = float((seq.means.double() - ref_short.means).abs().max()) / scale
    ll_ref = float(ref.loglik)
    rel_par = abs(float(par.loglik) - ll_ref) / abs(ll_ref)
    rel_seq = abs(float(seq.loglik) - float(ref_short.loglik)) / abs(
        float(ref_short.loglik))
    ps_err = float((par_short.means - seq.means).abs().max()) / scale
    print(f"  (a) Kalman D=8 T={TS_T} (5% missing): parallel {par_s:.3f} s "
          f"({n_sync} host syncs), sequential over the first {TS_SEQ_T} "
          f"steps {seq_s:.3f} s ({seq_s / TS_SEQ_T * 1e6:.1f} us a step, "
          f"{seq_enq / TS_SEQ_T * 1e6:.1f} us of host enqueue); float32 "
          f"against float64: means "
          f"{err_par:.3e} (parallel), {err_seq:.3e} (sequential) of the "
          f"state scale {scale:.1f}, parallel vs sequential {ps_err:.3e} "
          f"(bound 1e-3); loglik {float(par.loglik):.3f} / "
          f"{float(seq.loglik):.3f} against {ll_ref:.3f} (relative "
          f"{rel_par:.2e} / {rel_seq:.2e}, bound 1e-4); {ts_peak()} [{card}]",
          flush=True)
    ts_check("Kalman parallel vs sequential", ps_err < 1e-3 and
             rel_par < 1e-4 and rel_seq < 1e-4, (ps_err, rel_par, rel_seq))
    ts_check("Kalman parallel: host syncs", n_sync == 0, n_sync)

    # the gradient in the four noise scales: autograd against a central
    # difference, both in float64 on the card
    th = torch.tensor(scales, dtype=torch.float64, device=dev,
                      requires_grad=True)
    (grad,), grad_s, _ = ts_fenced(lambda: torch.autograd.grad(
        tl.lgss_loglik(model(torch.float64, th), ys.double()), th))
    fd = []
    for i in range(4):  # a step of 1e-4 of each scale (they span 1e-5..0.5)
        e = torch.zeros(4, dtype=torch.float64, device=dev)
        e[i] = 1e-4 * scales[i]
        fd.append(float(tl.lgss_loglik(model(torch.float64, th.detach() + e),
                                       ys.double())
                        - tl.lgss_loglik(model(torch.float64,
                                               th.detach() - e),
                                         ys.double())) / (2e-4 * scales[i]))
    g = grad.cpu().numpy()
    rel_g = float(np.max(np.abs(g - fd) / np.maximum(np.abs(fd), 1.0)))
    print(f"  (a) lgss_loglik gradient in the 4 noise scales (float64): "
          f"{np.round(g, 2).tolist()} in {grad_s:.3f} s, against a central "
          f"difference {rel_g:.2e} relative (bound 1e-4)", flush=True)
    ts_check("lgss_loglik gradient", rel_g < 1e-4, (g, fd))

    # FFBS: 256 parallel draws from one filter against the RTS smoother
    (m_s, p_s), rts_s, _ = ts_fenced(lambda: tl.rts_smoother(p, filtered=par))
    z = torch.randn((TS_DRAWS, TS_T, 8), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    # the dummy seasonal's noise-free rows make the backward conditionals
    # exactly singular: the nugget the reference provides for them
    draws, ffbs_s, _ = ts_fenced(
        lambda: tl.ffbs_sample(None, p, filtered=par, z=z, jitter=1e-5))
    # the MC standard error from the draws' own spread (the nugget widens it
    # in the near-deterministic seasonal rows, around the same mean)
    tol = 5.0 * draws.std(0) / np.sqrt(TS_DRAWS) + 1e-4 * scale
    dev_ = (draws.mean(0) - m_s).abs()
    grid = dev_[::64] / tol[::64]
    worst = float(grid.max())
    print(f"  (a) rts_smoother {rts_s:.3f} s ({rts_s / TS_T * 1e6:.1f} us a "
          f"step); ffbs_sample parallel (jitter 1e-5), {TS_DRAWS} draws, "
          f"{ffbs_s:.3f} s: "
          f"draw means within {worst:.3f} of the 5 MC SE band around the "
          f"smoother (every 64th step, {grid.numel()} entries; bound 1); "
          f"{ts_peak()}", flush=True)
    ts_check("FFBS against the smoother", worst < 1.0, worst)
    del z, draws
    # the 30-step forecast against float64's from the float64 filter
    _, _, om, o_cov = tl.forecast(p, filtered=par, horizon=30)
    _, _, om64, o_cov64 = tl.forecast(p64, filtered=ref, horizon=30)
    o_sd, o_sd64 = torch.sqrt(o_cov[:, 0, 0]), torch.sqrt(o_cov64[:, 0, 0])
    e_f = max(float((om.double() - om64).abs().max()) / float(o_sd64[0]),
              float(((o_sd.double() - o_sd64) / o_sd64).abs().max()))
    print(f"  (a) forecast 30 steps: predictive sd {float(o_sd[0]):.4f} → "
          f"{float(o_sd[-1]):.4f}, float32 against float64 {e_f:.2e} (of the "
          f"first step's sd; bound 1e-3)", flush=True)
    ts_check("forecast", e_f < 1e-3 and float(o_sd[-1]) > float(o_sd[0]),
             (e_f, o_sd))

    # LGSSKernel + the inverse-gamma variance at 1024 chains
    x_ll, y_ll = ss.local_level_data()
    torch.cuda.reset_peak_memory_stats()
    gb = ss.local_level_sampler(y_ll, TS_GIBBS_CHAINS, dev)
    n_sync, per = block_syncs(gb)
    ok, run_s, _ = ts_fenced(lambda: gb.run(TS_GIBBS_SWEEPS))
    ts_check("LGSSKernel Gibbs storage", ok, ok)
    xs = gb.get_block("x")[TS_GIBBS_SWEEPS // 4:]
    rmse = float(np.sqrt(((xs.mean((0, 1)) - x_ll) ** 2).mean()))
    print(f"  (a) LGSSKernel + inverse-gamma Gibbs, {TS_GIBBS_CHAINS} chains "
          f"(local level, T=80): {TS_GIBBS_SWEEPS / run_s:.2f} sweeps/s, "
          f"{n_sync} host syncs a sweep (by block: {per}), trajectory RMSE "
          f"{rmse:.3f} (bound "
          f"0.7), {ts_peak()}", flush=True)
    ts_check("LGSSKernel Gibbs", rmse < 0.7, rmse)


def ts_hmm(mt, card):
    """(b): K = 8 Gaussian regimes over T = 2^16; the Gibbs loop."""
    from mcmcpp_tpu_torch.models import hmm as th

    dev = torch.device("cuda")
    k = HMM_K
    rng = np.random.default_rng(1302)
    gamma = np.full((k, k), 0.02 / (k - 1))
    np.fill_diagonal(gamma, 0.98)
    means = 1.5 * (np.arange(k) - (k - 1) / 2)
    z = np.zeros(HMM_T, int)
    z[0] = rng.integers(k)
    u = rng.random(HMM_T)
    cum = np.cumsum(gamma, 1)
    for t in range(1, HMM_T):
        z[t] = min(int(np.searchsorted(cum[z[t - 1]], u[t])), k - 1)
    ys = means[z] + 0.5 * rng.standard_normal(HMM_T)
    log_obs = th.gaussian_emission_logpdf(
        torch.tensor(ys, dtype=torch.float32, device=dev), means,
        np.full(k, 0.5))
    log_pi = torch.full((k,), -np.log(k), device=dev)
    log_gamma = torch.log(torch.tensor(gamma, dtype=torch.float32,
                                       device=dev))
    torch.cuda.reset_peak_memory_stats()
    seq, seq_s, seq_enq = ts_fenced(lambda: th.hmm_forward(
        log_pi, log_gamma, log_obs, method="sequential"))
    par, par_s, _ = ts_fenced(lambda: th.hmm_forward(
        log_pi, log_gamma, log_obs, method="parallel"))
    rel = abs(float(par.loglik) - float(seq.loglik)) / abs(float(seq.loglik))
    (post, _), sm_s, _ = ts_fenced(lambda: th.hmm_smoother(
        log_pi, log_gamma, log_obs))
    acc_sm = float((post.argmax(1).cpu().numpy() == z).mean())
    (path, _), vit_s, _ = ts_fenced(lambda: th.viterbi(log_pi, log_gamma,
                                                       log_obs))
    acc_v = float((path.cpu().numpy() == z).mean())
    gen = torch.Generator(device=dev).manual_seed(3)
    paths, samp_s, _ = ts_fenced(lambda: th.hmm_sample_posterior(
        gen, log_pi, log_gamma, log_obs, n_paths=HMM_PATHS))
    freq = torch.stack([(paths[:, ::64] == j).float().mean(0)
                        for j in range(k)], 1)
    marg = torch.exp(post[::64])
    band = 5 * torch.sqrt(marg * (1 - marg) / HMM_PATHS) + 2e-3
    worst = float(((freq - marg).abs() / band).max())
    print(f"  (b) HMM K={k} T={HMM_T}: forward sequential {seq_s:.3f} s "
          f"({seq_s / HMM_T * 1e6:.1f} us a step, "
          f"{seq_enq / HMM_T * 1e6:.1f} us of host enqueue), parallel "
          f"{par_s:.3f} s; loglik {float(seq.loglik):.2f} / "
          f"{float(par.loglik):.2f} (relative {rel:.2e}, bound 1e-5); "
          f"smoother {sm_s:.3f} s (state accuracy {acc_sm:.4f}), Viterbi "
          f"{vit_s:.3f} s ({acc_v:.4f}; bounds 0.9); {HMM_PATHS} posterior "
          f"paths {samp_s:.3f} s, their state frequencies within "
          f"{worst:.3f} of the 5 SE band around the smoother (every 64th "
          f"step; bound 1); {ts_peak()} [{card}]", flush=True)
    ts_check("HMM forward agreement", rel < 1e-5, rel)
    ts_check("HMM decoding", acc_sm > 0.9 and acc_v > 0.9, (acc_sm, acc_v))
    ts_check("HMM posterior paths", worst < 1.0, worst)

    # HMMKernel + Dirichlet rows, 1024 chains over the first
    # TS_HMM_GIBBS_T steps
    t_g = TS_HMM_GIBBS_T

    def rows(gen, others):
        zz = others["z"].long()
        idx = zz[:, :-1] * k + zz[:, 1:]
        counts = torch.zeros((zz.shape[0], k * k), device=dev)
        counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=counts.dtype))
        g = torch._standard_gamma(counts.reshape(-1, k, k) + 1.0,
                                  generator=gen)
        return torch.log(g / torch.sum(g, -1, keepdim=True)).reshape(
            -1, k * k)

    torch.cuda.reset_peak_memory_stats()
    gb = mt.BlockedGibbsSampler(
        [("z", t_g, th.HMMKernel(log_obs[:t_g], log_pi.cpu().numpy(),
                                 lambda o: o["lgam"].reshape(k, k),
                                 method="parallel")),
         ("lgam", k * k, mt.ExactGibbsKernel(rows, batched=True))],
        n_chains=TS_GIBBS_CHAINS, seed=0, device="cuda")
    gb.init({"z": rng.integers(0, k, t_g).astype(np.float32),
             "lgam": np.full(k * k, -np.log(k), np.float32)})
    n_sync, per = block_syncs(gb)
    ok, run_s, _ = ts_fenced(lambda: gb.run(HMM_GIBBS_SWEEPS))
    ts_check("HMMKernel Gibbs storage", ok, ok)
    zs = gb.get_block("z")[HMM_GIBBS_SWEEPS // 2:]
    acc = float((np.rint(zs).astype(int) == z[:t_g]).mean())
    diag = float(np.exp(gb.get_block("lgam")[HMM_GIBBS_SWEEPS // 2:]
                        .reshape(-1, k, k)[:, np.arange(k), np.arange(k)])
                 .mean())
    print(f"  (b) HMMKernel (parallel forward) + Dirichlet rows Gibbs, "
          f"{TS_GIBBS_CHAINS} chains × T={t_g}: "
          f"{HMM_GIBBS_SWEEPS / run_s:.3f} sweeps/s, {n_sync} "
          f"host syncs a sweep (by block: {per}); state accuracy {acc:.4f} "
          f"(bound 0.9), mean "
          f"sticky diagonal {diag:.4f} (truth 0.98, bound 0.05); "
          f"{ts_peak()}", flush=True)
    ts_check("HMMKernel Gibbs", acc > 0.9 and abs(diag - 0.98) < 0.05,
             (acc, diag))


def sv_with_density(ss):
    """The state-space example's SV model with its transition density (the
    smoother and PGAS need it)."""
    phi, sig = 0.95, 0.3
    base = ss.sv_model(phi, sig)

    def trans_logpdf(x_next, x, t, th):
        mu = th[..., None, :1]
        zz = (x_next - mu - phi * (x - mu))[..., 0] / sig
        return -0.5 * zz * zz - np.log(sig) - 0.5 * np.log(2 * np.pi)

    return base._replace(trans_logpdf=trans_logpdf)


def ts_particles(mt, card):
    """(c): the filters, PMMH, the smoother, the forecast and PGAS on the
    stochastic-volatility model; the fully adapted filter against
    Kalman."""
    from mcmcpp_tpu_torch import particle as tp
    from mcmcpp_tpu_torch.examples import state_space as ss
    from mcmcpp_tpu_torch.models import lgss as tl

    dev = torch.device("cuda")
    x_true, ys = ss.sv_data(SV_T)
    ssm = sv_with_density(ss)
    mu = torch.tensor([-1.0], device=dev)
    torch.cuda.reset_peak_memory_stats()
    mt.particle_filter(0, ssm, mu, ys[:8], PF_N, device="cuda")
    ys_dev = torch.tensor(ys, device=dev)  # the syncs counted are the loop's
    with counting_syncs() as syncs:
        res, pf_s, pf_enq = ts_fenced(lambda: mt.particle_filter(
            100, ssm, mu, ys_dev, PF_N, device="cuda"))
    n_sync = len(syncs)
    # the spread over PF_SEEDS independent filters, run as one batch (the
    # hooks broadcast over it: θ (PF_SEEDS, 1))
    lls = tp.run_filter(
        torch.Generator(device=dev).manual_seed(101),
        tp.Hooks(ssm, mu.expand(PF_SEEDS, 1), (PF_SEEDS,), batched=True),
        tp.as_series(ys_dev), PF_N, stats=False).loglik.cpu().numpy()
    corr = float(np.corrcoef(res.filter_means.cpu().numpy()[:, 0],
                             x_true)[0, 1])
    print(f"  (c) bootstrap particle_filter, SV T={SV_T}, N={PF_N}: "
          f"{pf_s:.3f} s ({pf_s / SV_T * 1e6:.1f} us a step, "
          f"{pf_enq / SV_T * 1e6:.1f} us of host enqueue, {n_sync} host "
          f"syncs); loglik over {PF_SEEDS} seeds {lls.mean():.3f} ± "
          f"{lls.std(ddof=1):.3f}; filtered log-variance corr with the truth "
          f"{corr:.3f} (bound 0.5); {ts_peak()} [{card}]", flush=True)
    ts_check("bootstrap filter", np.isfinite(lls).all() and corr > 0.5
             and n_sync == 0, (lls, corr, n_sync))

    # the fully adapted filter on the local level against Kalman
    sq, sr, m0, p0 = 0.35, 0.3, 1.0, 2.0
    q, r = sq ** 2, sr ** 2
    prec = 1.0 / q + 1.0 / r
    post_sd, pred_sd = np.sqrt(1.0 / prec), np.sqrt(q + r)
    rng = np.random.default_rng(1303)
    xl = m0 + np.sqrt(p0) * rng.standard_normal() + np.cumsum(
        np.r_[0.0, sq * rng.standard_normal(SV_T - 1)])
    yl = (xl + sr * rng.standard_normal(SV_T)).astype(np.float32)
    exact = float(tl.lgss_loglik(tl.lgss_params(
        A=1.0, b=0.0, Q=q, H=1.0, c=0.0, R=r, m0=m0, P0=p0,
        dtype=torch.float64, device=dev), yl))

    def norm_lp(zz, s):
        return -0.5 * zz * zz - np.log(s) - 0.5 * np.log(2 * np.pi)

    # GUIDED_SEEDS independent filters as one batch (hooks on any leading
    # axes; the first draw's batch given)
    fa = mt.StateSpaceModel(
        init_sample=lambda g, n, th: m0 + np.sqrt(p0) * torch.randn(
            (GUIDED_SEEDS, n, 1), generator=g, device=g.device),
        trans_sample=lambda g, x, t, th: x + sq * torch.randn(
            x.shape, generator=g, device=g.device),
        obs_logpdf=lambda y, x, t, th: norm_lp((y[0] - x[..., 0]) / sr, sr),
        trans_logpdf=lambda xn, x, t, th: norm_lp((xn - x)[..., 0] / sq, sq),
        lookahead_logpdf=lambda y, x, t, th: norm_lp(
            (y[0] - x[..., 0]) / pred_sd, pred_sd),
        prop_sample=lambda g, x, y, t, th: (x / q + y[0] / r) / prec
        + post_sd * torch.randn(x.shape, generator=g, device=g.device),
        prop_logpdf=lambda xn, x, y, t, th: norm_lp(
            (xn[..., 0] - (x[..., 0] / q + y[0] / r) / prec) / post_sd,
            post_sd))
    fa_ll = tp.run_filter(
        torch.Generator(device=dev).manual_seed(7),
        tp.Hooks(fa, None, (GUIDED_SEEDS,), batched=True),
        tp.as_series(yl), GUIDED_N, auxiliary=True,
        stats=False).loglik.double().cpu().numpy()
    ratio = np.exp(fa_ll - exact)
    se = max(ratio.std(ddof=1) / np.sqrt(GUIDED_SEEDS), 1e-6)
    print(f"  (c) fully adapted (guided + exact lookahead) filter, local "
          f"level T={SV_T}, N={GUIDED_N}, {GUIDED_SEEDS} seeds: loglik "
          f"{fa_ll.mean():.4f} ± {fa_ll.std(ddof=1):.4f} against Kalman "
          f"{exact:.4f}; mean likelihood ratio {ratio.mean():.4f} (within "
          f"max(4 SE, 0.02) = {max(4 * se, 0.02):.4f} of 1)", flush=True)
    ts_check("fully adapted filter", abs(ratio.mean() - 1) < max(4 * se,
                                                                 0.02),
             (ratio.mean(), se))

    # PMMH on the SV mean at 256 chains × 1024 particles
    torch.cuda.reset_peak_memory_stats()
    pm = mt.PMMHSampler(ssm, ys[:PMMH_T],
                        log_prior=lambda th: -0.5 * th[..., 0] ** 2,
                        n_params=1, n_particles=PMMH_N, proposal_scale=0.3,
                        n_chains=PMMH_CHAINS, seed=0, batched=True,
                        device="cuda")
    pm.init(np.zeros((PMMH_CHAINS, 1), np.float32))
    with counting_syncs() as syncs:
        pm.state = pm.step(pm.state, pm._prop_chol)
    n_sync = len(syncs)
    _, tune_s, _ = ts_fenced(lambda: pm.tune(PMMH_TUNE, window=PMMH_WINDOW))
    ok, run_s, run_enq = ts_fenced(lambda: pm.run(PMMH_STEPS))
    ts_check("PMMH storage", ok, ok)
    draws = pm.get_samples(burn_in=PMMH_STEPS // 4, flat=True)[:, 0]
    acc = float(pm.acceptance_fraction.mean())
    print(f"  (c) PMMH {PMMH_CHAINS} chains × {PMMH_N} particles, T="
          f"{PMMH_T}: tune {PMMH_TUNE} steps {tune_s:.2f} s, "
          f"{PMMH_STEPS} stored steps {run_s:.2f} s "
          f"({PMMH_STEPS / run_s:.3f} steps/s, "
          f"{run_s / PMMH_STEPS / PMMH_T * 1e6:.1f} us a filter step, host "
          f"enqueue {run_enq / PMMH_STEPS / PMMH_T * 1e6:.1f} us), {n_sync} "
          f"host syncs a step; mu posterior {draws.mean():.3f} ± "
          f"{draws.std():.3f} (truth -1, bound 0.8), acceptance {acc:.3f}; "
          f"{ts_peak()}", flush=True)
    ts_check("PMMH", abs(draws.mean() + 1.0) < 0.8 and 0.02 < acc < 0.95
             and n_sync == 0, (draws.mean(), acc, n_sync))
    del pm

    # the smoother against the filter, and the forecast
    torch.cuda.reset_peak_memory_stats()
    sm, sm_s, _ = ts_fenced(lambda: mt.particle_smoother(
        5, ssm, mu, ys, SMOOTH_N, SMOOTH_J, device="cuda"))
    filt = mt.particle_filter(5, ssm, mu, ys, SMOOTH_N,
                              return_particles=True, device="cuda")
    rmse_s = float(np.sqrt(((sm.smoothed_means.cpu().numpy()[:, 0]
                             - x_true) ** 2).mean()))
    rmse_f = float(np.sqrt(((filt.filter_means.cpu().numpy()[:, 0]
                             - x_true) ** 2).mean()))
    xs_f, _ = mt.particle_forecast(6, ssm, mu, filt.particles[-1],
                                   filt.log_weights[-1], SV_T, FORECAST_H,
                                   device="cuda")
    m_last = float(torch.exp(filt.log_weights[-1]) @ filt.particles[-1][:, 0])
    want = -1.0 + 0.95 ** FORECAST_H * (m_last + 1.0)
    got = float(xs_f[-1, :, 0].mean())
    f_se = float(xs_f[-1, :, 0].std()) / np.sqrt(SMOOTH_N)
    print(f"  (c) particle_smoother J={SMOOTH_J} N={SMOOTH_N}: {sm_s:.2f} s, "
          f"RMSE to the latent {rmse_s:.4f} against the filter's {rmse_f:.4f}"
          f"; particle_forecast {FORECAST_H} steps: mean {got:.4f} against "
          f"{want:.4f} ({abs(got - want) / f_se:.2f} MC SE, bound 5); "
          f"{ts_peak()}", flush=True)
    ts_check("particle smoother", rmse_s < rmse_f, (rmse_s, rmse_f))
    ts_check("particle forecast", abs(got - want) < 5 * f_se + 1e-3,
             (got, want))
    del sm, filt, xs_f

    # PGAS at 256 chains × 64 particles
    torch.cuda.reset_peak_memory_stats()
    gb = mt.BlockedGibbsSampler(
        [("x", SV_T, mt.ParticleGibbsKernel(ssm, ys, n_particles=PGAS_N,
                                            theta_fn=mu))],
        n_chains=PGAS_CHAINS, seed=0, device="cuda")
    gb.init({"x": np.full(SV_T, -1.0, np.float32)})
    ok, pg_s, _ = ts_fenced(lambda: gb.run(PGAS_SWEEPS))
    ts_check("PGAS storage", ok, ok)
    xs = gb.get_block("x")[PGAS_SWEEPS // 2:]
    corr = float(np.corrcoef(xs.mean((0, 1)), x_true)[0, 1])
    print(f"  (c) ParticleGibbsKernel {PGAS_CHAINS} chains × {PGAS_N} "
          f"particles, T={SV_T}: {PGAS_SWEEPS / pg_s:.3f} sweeps/s "
          f"({pg_s / PGAS_SWEEPS / SV_T * 1e6:.1f} us a step); posterior "
          f"mean path corr with the truth {corr:.3f} (bound 0.5); "
          f"{ts_peak()}", flush=True)
    ts_check("PGAS", corr > 0.5, corr)


def ts_rbpf_if2(mt, card):
    """(d) the RBPF on the regime-switching example; (e) IF2 on ssm_mle."""
    from mcmcpp_tpu_torch.examples import regime_switching as rs
    from mcmcpp_tpu_torch.examples import ssm_mle

    dev = torch.device("cuda")
    zs, ys = rs.simulate(RBPF_T, seed=7)
    torch.cuda.reset_peak_memory_stats()
    rs.track(ys[:8], zs[:8], RBPF_N, dev)
    (acc, res), rb_s, _ = ts_fenced(lambda: rs.track(ys, zs, RBPF_N, dev))
    print(f"  (d) rao_blackwell_filter N={RBPF_N} T={RBPF_T}: {rb_s:.3f} s "
          f"({rb_s / RBPF_T * 1e6:.1f} us a step); regime-classification "
          f"accuracy {acc:.4f} (bound 0.7), loglik {float(res.loglik):.2f}, "
          f"min ESS {float(res.ess.min()):.0f}; {ts_peak()} [{card}]",
          flush=True)
    ts_check("RBPF", acc > 0.7, acc)

    ys = ssm_mle.simulate(IF2_T)
    mle = ssm_mle.kalman_mle(ys)
    torch.cuda.reset_peak_memory_stats()
    r, if2_s, _ = ts_fenced(lambda: mt.if2(
        0, ssm_mle.if2_model(), ys, n_particles=IF2_N,
        theta0=np.array([0.5, 0.0], np.float32), sigma0=0.05,
        n_iters=IF2_ITERS, cooling=0.9, device="cuda"))
    est = r.theta.cpu().numpy()
    err = np.abs(est - mle)
    print(f"  (e) IF2 N={IF2_N} T={IF2_T} {IF2_ITERS} passes: {if2_s:.2f} s "
          f"({IF2_ITERS * IF2_T / if2_s:.1f} steps/s); estimate "
          f"{np.round(est, 4).tolist()} against the Kalman MLE "
          f"{np.round(mle, 4).tolist()}: |da| {err[0]:.4f} (bound 0.05), "
          f"|dlog_sr| {err[1]:.4f} (bound 0.10); {ts_peak()}", flush=True)
    ts_check("IF2", err[0] < 0.05 and err[1] < 0.10, err)


def smc2_local_level(mt, dev, m, nx, seed=0, max_chunk_steps=32):
    """tests/test_smc2.py's local level with θ = log σ_r, its hooks
    taking the M filters as one batch."""
    sq, m0, p0 = 0.35, 1.0, 2.0

    def obs(y, x, t, th):
        log_s = th[..., None, :1][..., 0]
        zz = (y[0] - x[..., 0]) / torch.exp(log_s)
        return -0.5 * zz * zz - log_s - 0.5 * np.log(2 * np.pi)

    ssm = mt.StateSpaceModel(
        lambda g, n, th: m0 + np.sqrt(p0) * torch.randn(
            (th.shape[0], n, 1), generator=g, device=g.device),
        lambda g, x, t, th: x + sq * torch.randn(x.shape, generator=g,
                                                 device=g.device), obs)
    return mt.SMC2Sampler(
        ssm, lambda th: -0.5 * th[:, 0] ** 2 - 0.5 * np.log(2 * np.pi),
        lambda g, n: torch.randn((n, 1), generator=g, device=g.device),
        n_theta=m, n_params=1, n_particles=nx, seed=seed, batched=True,
        max_chunk_steps=max_chunk_steps, device=dev)


def smc2_data(t_n, seed=11):
    rng = np.random.default_rng(seed)
    x = 1.0 + np.sqrt(2.0) * rng.standard_normal() + np.cumsum(
        np.r_[0.0, 0.35 * rng.standard_normal(t_n - 1)])
    return (x + 0.6 * rng.standard_normal(t_n)).astype(np.float32)


def ts_online(mt, card):
    """(f): IBIS (chunked against per-stage, bitwise) and SMC²."""
    from mcmcpp_tpu_torch.examples import streaming
    from mcmcpp_tpu_torch.models import lgss as tl

    dev = torch.device("cuda")
    ys = streaming.make_stream(IBIS_ROWS // 2)
    runs = {}
    for chunk in (32, None):
        torch.cuda.reset_peak_memory_stats()
        s = streaming.m1_sampler(IBIS_N, IBIS_BATCH, dev,
                                 max_chunk_steps=chunk)
        half = IBIS_ROWS // 2
        _, s1, _ = ts_fenced(lambda: s.update(ys[:half]))
        bf_mid = s.log_evidence - streaming.m0_logz(ys[:half])
        _, s2, _ = ts_fenced(lambda: s.update(ys[half:]))
        bf_end = s.log_evidence - streaming.m0_logz(ys)
        runs[chunk] = (s, s1 + s2, bf_mid, bf_end, ts_peak())
    a, b = runs[32][0], runs[None][0]
    same = all(torch.equal(x, y) for x, y in zip(a.state, b.state)) and \
        a.log_evidence_trace == b.log_evidence_trace
    stages = IBIS_ROWS // IBIS_BATCH
    s, secs, bf_mid, bf_end, peak = runs[32]
    print(f"  (f) IBIS N={IBIS_N}, {IBIS_ROWS} rows in batches of "
          f"{IBIS_BATCH}: {stages / secs:.1f} stages/s grouped by 32 "
          f"({stages / runs[None][1]:.1f} per stage), host syncs "
          f"{a.host_syncs / stages:.3f} a stage ({b.host_syncs / stages:.3f} "
          f"per stage), {a.n_resamples} resample-move events; grouped == "
          f"per-stage bitwise: {same}; log Bayes factor at the switch "
          f"{bf_mid:.2f} (bound < 1), at the end {bf_end:.2f} (bound > 3); "
          f"{peak} [{card}]", flush=True)
    ts_check("IBIS grouped == per-stage", same, same)
    ts_check("IBIS Bayes factor", bf_mid < 1.0 and bf_end > 3.0,
             (bf_mid, bf_end))
    del runs, a, b, s

    yl = smc2_data(SMC2_T)
    grid = torch.linspace(-2.5, 1.5, 401, dtype=torch.float64, device=dev)

    def exact_ll(th):
        return tl.lgss_loglik(tl.lgss_params(
            A=1.0, b=0.0, Q=0.35 ** 2, H=1.0, c=0.0, R=torch.exp(th) ** 2,
            m0=1.0, P0=2.0, dtype=torch.float64, device=dev),
            torch.tensor(yl, dtype=torch.float64, device=dev))

    ll = torch.stack([exact_ll(g) for g in grid]).cpu().numpy()
    g = grid.cpu().numpy()
    logpost = ll - 0.5 * g ** 2 - 0.5 * np.log(2 * np.pi)
    mx = logpost.max()
    logz_true = float(mx + np.log(np.sum(np.exp(logpost - mx)))
                      + np.log(g[1] - g[0]))
    torch.cuda.reset_peak_memory_stats()
    s = smc2_local_level(mt, dev, SMC2_M, SMC2_NX, seed=3)
    _, secs, _ = ts_fenced(lambda: s.update(yl))
    mean, cov = s.moments()
    print(f"  (f) SMC² {SMC2_M} θ × {SMC2_NX} x-particles, T={SMC2_T}: "
          f"{SMC2_T / secs:.2f} stages/s, host syncs "
          f"{s.host_syncs / SMC2_T:.3f} a stage, {s.n_resamples} "
          f"rejuvenations (last acceptance "
          f"{s.last_rejuvenation_accept:.3f}); log evidence "
          f"{s.log_evidence:.3f} against the exact {logz_true:.3f} (bound "
          f"1.0); θ posterior {mean[0]:.3f} ± {np.sqrt(cov[0, 0]):.3f}; "
          f"{ts_peak()}", flush=True)
    ts_check("SMC² evidence", abs(s.log_evidence - logz_true) < 1.0,
             (s.log_evidence, logz_true))


def ts_gaussian_filters(mt, card):
    """(g) EnKF and ETKF on Lorenz-96; (h) UKF/URTS and EKI/EKS."""
    from mcmcpp_tpu_torch.examples import data_assimilation as da
    from mcmcpp_tpu_torch.models import lgss as tl

    dev = torch.device("cuda")
    truth, ys, h_idx = da.simulate_truth(ENKF_T, seed=1)
    model = da.build_model(truth[0], h_idx, dev)
    clim = float(truth.std())
    for variant, t_n in (("stochastic", ENKF_T), ("etkf", ETKF_T)):
        torch.cuda.reset_peak_memory_stats()
        mt.ensemble_kalman_filter(0, model, ys[:8], ENKF_N, variant=variant,
                                  device="cuda")
        with counting_syncs() as syncs:
            res, secs, enq = ts_fenced(lambda: mt.ensemble_kalman_filter(
                0, model, ys[:t_n], ENKF_N, inflation=1.05, variant=variant,
                device="cuda"))
        warm = t_n // 4
        rmse = float(np.sqrt(np.mean((res.means.cpu().numpy()[warm:]
                                      - truth[warm:t_n]) ** 2)))
        print(f"  (g) EnKF {variant} Lorenz-96 D={da.D} N={ENKF_N} "
              f"T={t_n}: {t_n / secs:.1f} steps/s "
              f"({secs / t_n * 1e3:.3f} ms a step, host enqueue "
              f"{enq / t_n * 1e3:.3f} ms), {len(syncs)} host syncs; "
              f"analysis RMSE {rmse:.4f} (bounds < 1.2 and < 0.6 × "
              f"climatology {clim:.3f}); {ts_peak()} [{card}]", flush=True)
        ts_check(f"EnKF {variant}", rmse < 1.2 and rmse < 0.6 * clim,
                 (rmse, clim))

    # UKF and URTS on tests/test_ukf.py's linear case against Kalman
    a2 = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
    h2 = np.array([[1.0, 0.0]], np.float32)
    q2 = 0.3 * np.eye(2, dtype=np.float32)
    r2 = np.array([[0.25]], np.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2)
    ys = np.empty((60, 1), np.float32)
    for t in range(60):
        if t > 0:
            x = a2 @ x + rng.multivariate_normal(np.zeros(2), q2)
        ys[t] = h2 @ x + np.sqrt(r2[0, 0]) * rng.standard_normal()
    t_ = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    model = mt.UKFModel(f=lambda xx, t: xx @ t_(a2).T,
                        h=lambda xx, t: xx @ t_(h2).T, Q=t_(q2), R=t_(r2),
                        m0=torch.zeros(2, device=dev),
                        P0=torch.eye(2, device=dev))
    r, ukf_s, _ = ts_fenced(lambda: mt.unscented_kalman_filter(model, ys))
    exact = tl.kalman_filter(tl.lgss_params(a2, np.zeros(2), q2, h2,
                                            np.zeros(1), r2, np.zeros(2),
                                            np.eye(2), device=dev), ys,
                             method="sequential")
    (ms, _), urts_s, _ = ts_fenced(lambda: mt.unscented_rts_smoother(
        model, filtered=r))
    ems, _ = tl.rts_smoother(tl.lgss_params(a2, np.zeros(2), q2, h2,
                                            np.zeros(1), r2, np.zeros(2),
                                            np.eye(2), device=dev),
                             filtered=exact)
    e_m = float((r.means - exact.means).abs().max())
    e_s = float((ms - ems).abs().max())
    e_ll = abs(float(r.loglik) - float(exact.loglik)) / abs(float(
        exact.loglik))
    print(f"  (h) UKF T=60 {ukf_s * 1e3:.1f} ms, URTS {urts_s * 1e3:.1f} ms: "
          f"against Kalman/RTS means {e_m:.2e} (bound 2e-4), smoothed "
          f"{e_s:.2e} (bound 5e-4), loglik {e_ll:.2e} relative (bound 1e-4)",
          flush=True)
    ts_check("UKF/URTS", e_m < 2e-4 and e_s < 5e-4 and e_ll < 1e-4,
             (e_m, e_s, e_ll))

    # EKI and EKS on tests/test_eks.py's linear problem, J = 2^14
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    gamma = 0.25 * np.eye(5, dtype=np.float32)
    y = (a @ np.array([0.5, -1.0, 2.0], np.float32)
         + 0.5 * rng.standard_normal(5)).astype(np.float32)
    c0 = 4.0 * np.eye(3, dtype=np.float32)
    gi = np.linalg.inv(gamma)
    post_cov = np.linalg.inv(a.T @ gi @ a + np.linalg.inv(c0))
    post_mean = post_cov @ (a.T @ gi @ y)
    at = torch.tensor(a, device=dev)
    fwd = lambda th: th @ at.T  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    eki, eki_s, _ = ts_fenced(lambda: mt.ensemble_kalman_inversion(
        2, fwd, y, gamma, np.zeros(3), c0, n_ensemble=EKS_J, n_iters=40,
        device="cuda"))
    eks, eks_s, _ = ts_fenced(lambda: mt.ensemble_kalman_sampler(
        3, fwd, y, gamma, np.zeros(3), c0, n_ensemble=EKS_J, device="cuda"))
    e_eki = float(np.abs(eki.theta.cpu().numpy() - post_mean).max())
    e_eks = float(np.abs(eks.mean.cpu().numpy() - post_mean).max())
    ratio = np.diag(eks.cov.cpu().numpy()) / np.diag(post_cov)
    print(f"  (h) EKI J={EKS_J} 40 iterations {eki_s:.2f} s: mean off the "
          f"posterior mean by {e_eki:.4f} (bound 0.15); EKS J={EKS_J} 800 "
          f"iterations {eks_s:.2f} s ({800 / eks_s:.1f} it/s): mean "
          f"{e_eks:.4f} (bound 0.15), variance ratios "
          f"{np.round(ratio, 3).tolist()} (bounds 0.6–1.6); {ts_peak()}",
          flush=True)
    ts_check("EKI", e_eki < 0.15, e_eki)
    ts_check("EKS", e_eks < 0.15 and ((ratio > 0.6) & (ratio < 1.6)).all(),
             (e_eks, ratio))


def ts_resumes(mt, card, out_dir):
    """(i): PMMH, IBIS and SMC² saved, loaded into fresh samplers and
    continued, bit for bit against the uninterrupted run."""
    from mcmcpp_tpu_torch.examples import state_space as ss
    from mcmcpp_tpu_torch.examples import streaming
    from mcmcpp_tpu_torch.io import load_checkpoint, save_checkpoint

    dev = torch.device("cuda")
    os.makedirs(out_dir, exist_ok=True)

    def timed_save(s, name):
        path = os.path.join(out_dir, name)
        _, save_s, _ = ts_fenced(lambda: save_checkpoint(s, path))
        return path, save_s

    def report(label, path, save_s, load_s, same):
        print(f"  (i) {label} resume: {os.path.getsize(path)} bytes, save "
              f"{save_s:.3f} s, load {load_s:.3f} s; continuation bitwise: "
              f"{same} [{card}]", flush=True)
        ts_check(f"{label} resume", same, same)

    _, ys = ss.sv_data(SV_T)

    def pmmh(seed):
        return mt.PMMHSampler(sv_with_density(ss), ys[:PMMH_T],
                              log_prior=lambda th: -0.5 * th[..., 0] ** 2,
                              n_params=1, n_particles=PMMH_N,
                              proposal_scale=0.3, n_chains=PMMH_CHAINS,
                              seed=seed, batched=True, device="cuda")

    a = pmmh(0)
    a.init(np.zeros((PMMH_CHAINS, 1), np.float32))
    a.run(RESUME_STEPS)
    path, save_s = timed_save(a, "ts_pmmh.npz")
    b = pmmh(9)
    _, load_s, _ = ts_fenced(lambda: load_checkpoint(b, path))
    a.run(RESUME_STEPS)
    b.run(RESUME_STEPS)
    same = all(torch.equal(x, y) for x, y in zip(a.state, b.state)) and \
        np.array_equal(a.get_samples(), b.get_samples())
    report(f"PMMH {PMMH_CHAINS}×{PMMH_N}", path, save_s, load_s, same)
    del a, b

    stream = streaming.make_stream(IBIS_ROWS // 2)
    a = streaming.m1_sampler(IBIS_N, IBIS_BATCH, dev)
    a.update(stream[:1000])
    path, save_s = timed_save(a, "ts_ibis.npz")
    b = streaming.m1_sampler(IBIS_N, IBIS_BATCH, dev, seed=9)
    _, load_s, _ = ts_fenced(lambda: load_checkpoint(b, path))
    a.update(stream[1000:1200])
    b.update(stream[1000:1200])
    same = all(torch.equal(x, y) for x, y in zip(a.state, b.state)) and \
        a.log_evidence_trace == b.log_evidence_trace
    report(f"IBIS N={IBIS_N}", path, save_s, load_s, same)
    del a, b

    yl = smc2_data(SMC2_T)
    a = smc2_local_level(mt, dev, SMC2_M, SMC2_NX)
    a.update(yl[:100])
    path, save_s = timed_save(a, "ts_smc2.npz")
    b = smc2_local_level(mt, dev, SMC2_M, SMC2_NX, seed=9)
    _, load_s, _ = ts_fenced(lambda: load_checkpoint(b, path))
    a.update(yl[100:120])
    b.update(yl[100:120])
    same = all(torch.equal(x, y) for x, y in zip(a.state, b.state)) and \
        a.log_evidence_trace == b.log_evidence_trace
    report(f"SMC² {SMC2_M}×{SMC2_NX}", path, save_s, load_s, same)


def time_series(mt, card, out_dir):
    """Phase 13: the time-series layer at its users' widths; every check
    fails the run."""
    for part in (ts_kalman, ts_hmm, ts_particles, ts_rbpf_if2, ts_online,
                 ts_gaussian_filters):
        t0 = time.perf_counter()
        part(mt, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"  [{part.__name__}: {time.perf_counter() - t0:.1f} s]",
              flush=True)
    t0 = time.perf_counter()
    ts_resumes(mt, card, out_dir)
    print(f"  [ts_resumes: {time.perf_counter() - t0:.1f} s]", flush=True)


def time_series_launch_count(mt, card):
    """Phase 13's launches per time step under the profiler (after phase 7,
    as no timing may follow a profiler window in this process): a
    bootstrap filter step at 2^18 particles, a PMMH filter step (256 chains
    × 1024 particles, batched hooks), a sequential Kalman step (D = 8), an
    SMC² stage's x-system advance (1024 × 1024) and a sequential HMM step
    (K = 8)."""
    from mcmcpp_tpu_torch.examples import state_space as ss
    from mcmcpp_tpu_torch.models import hmm as th
    from mcmcpp_tpu_torch.models import lgss as tl

    dev = torch.device("cuda")
    steps = 50
    _, ys = ss.sv_data(steps + 1)
    ssm = sv_with_density(ss)
    mu = torch.tensor([-1.0], device=dev)
    pm = mt.PMMHSampler(ssm, ys, log_prior=lambda th: -0.5 * th[..., 0] ** 2,
                        n_params=1, n_particles=PMMH_N, n_chains=PMMH_CHAINS,
                        batched=True, device="cuda")
    pm.init(np.zeros((PMMH_CHAINS, 1), np.float32))
    comp = [tl.local_linear_trend(0.05, 1e-5, device=dev),
            tl.seasonal(7, 0.02, device=dev)]
    p = tl.structural(comp, 0.5, p0_scale=100.0)
    yk = torch.randn(steps + 1, device=dev)
    s2 = smc2_local_level(mt, dev, SMC2_M, SMC2_NX)
    s2.update(smc2_data(2))
    s2.target_ess = 0.0  # the advance alone
    yl = torch.tensor(smc2_data(steps + 2)[:, None], device=dev)
    lo = torch.randn((steps + 1, HMM_K), device=dev)
    lg = torch.log(torch.full((HMM_K, HMM_K), 1.0 / HMM_K, device=dev))
    lp = torch.full((HMM_K,), -np.log(HMM_K), device=dev)

    def smc2_stages():
        st = s2.state
        for t in range(2, steps + 2):
            st, _, _, _ = s2.stage(st, yl, t)

    cases = [
        ("bootstrap filter step (N=2^18)",
         lambda: mt.particle_filter(0, ssm, mu, ys, PF_N, device="cuda")),
        (f"PMMH filter step ({PMMH_CHAINS}×{PMMH_N})",
         lambda: pm.step(pm.state, pm._prop_chol)),
        ("sequential Kalman step (D=8)",
         lambda: tl.kalman_filter(p, yk, method="sequential")),
        (f"SMC² stage advance ({SMC2_M}×{SMC2_NX})", smc2_stages),
        ("sequential HMM forward step (K=8)",
         lambda: th.hmm_forward(lp, lg, lo, method="sequential")),
    ]
    out = []
    for label, fn in cases:
        fn()
        rows = device_rows_per_step(fn, steps)
        n = sum(c for c, _ in rows.values())
        us = sum(u for _, u in rows.values())
        out.append(f"{label} {n:.1f} launches, {us:.1f} us of device time")
    print("  launches per time step (50 steps profiled): " + "; ".join(out)
          + f" [{card}]", flush=True)


# phase 14: the eight later example programs at their default widths (the
# chains, walkers, particles, live points, dims and data of the JAX
# programs), the native chain arena against numpy at the flagship's row, and
# numpy inputs on the card (F1). The programs are host-bound on the card (a
# NUTS leaf of the DP mixture's 16 chains ~8 ms, a Gibbs sweep of
# gp_hyperparams' 32 chains ~0.14 s), so their steps are cut, never their
# widths: gp_latent, tempering_and_dsl and gradient_inference at their
# --quick steps (gp_latent 4000 -> 400 steps; NUTS 400 + 1000 -> 100 + 250
# and PT 4000 -> 1000; warmup 400, 1000 -> 500 steps, ADVI 2000 -> 1000);
# function_space 2000 -> 500 steps; bayesian_workflow 500 + 1000 -> 10 + 15
# a NUTS or MEADS run and NeuTra's fit 1500 -> 40; gp_hyperparams 800 + 2400
# -> 30 + 60 sweeps and dp_mixture 600 + 1500 -> 4 + 4 transitions. Their
# gates are held where the cut run keeps the program's own (every program
# but the last two); gp_hyperparams and dp_mixture print theirs (a DP
# mixture of 8 transitions is a --quick run, which skips the gates in both
# packages; the Gibbs chain's 90 sweeps are not the 3200 its bounds are set
# for)
EX_BW = (10, 15, 40)
EX_GPH = (30, 60)
EX_DP = (4, 4)
EX_RUNS = [
    ("evidence", ["--device", "cuda"], True),
    ("gp_latent", ["--quick", "--device", "cuda"], True),
    ("tempering_and_dsl", ["--quick", "--device", "cuda"], True),
    ("gradient_inference", ["--quick", "--device", "cuda"], True),
    ("function_space", ["--steps", "300", "--device", "cuda"], True),
]
# (b) rows of the flagship stored by both backends: burn-in, then steps at
# thin 10 (4 rows of 92.3 MB float32 or 46.1 MB bf16)
NATIVE_BURN, NATIVE_STEPS = 20, 40


def captured(fn):
    """(fn's result, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def example_programs(mt, card):
    """Phase 14 (a): run the eight programs in this process; each prints its
    wall time and the lines that carry its gate values."""
    from mcmcpp_tpu_torch.examples import (
        bayesian_workflow,
        dp_mixture,
        gp_hyperparams,
    )
    import importlib

    def show(label, secs, text, keep):
        lines = [ln for ln in text.splitlines() if ln.strip()]
        print(f"  {label}: {secs:.1f} s [{card}]", flush=True)
        for ln in lines[-keep:]:
            print(f"    {ln}")

    for name, args, gated in EX_RUNS:
        mod = importlib.import_module(f"mcmcpp_tpu_torch.examples.{name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, text = captured(lambda: mod.main(args))
        torch.cuda.synchronize()
        show(f"{name} {' '.join(args)}", time.perf_counter() - t0, text, 8)
        if gated and rc != 0:
            raise AssertionError(f"example {name} failed its gates:\n{text}")

    t0 = time.perf_counter()
    failed, text = captured(lambda: bayesian_workflow.run(
        10, *EX_BW, device="cuda"))
    show(f"bayesian_workflow (warmup, steps, fit) = {EX_BW}",
         time.perf_counter() - t0, text, 14)
    if failed:
        raise AssertionError(f"bayesian_workflow failed: {failed}\n{text}")

    t0 = time.perf_counter()
    out, text = captured(lambda: gp_hyperparams.run(
        False, "cuda", burn=EX_GPH[0], keep=EX_GPH[1]))
    show(f"gp_hyperparams 32 chains, {EX_GPH[0]} + {EX_GPH[1]} sweeps",
         time.perf_counter() - t0, text, 3)
    print(f"    gates not held at this cut (3200 sweeps): failed "
          f"{out['failed']}")
    if not (np.isfinite(out["h"]).all() and out["rmse"] < 1.0):
        raise AssertionError(f"gp_hyperparams: rmse {out['rmse']}")

    t0 = time.perf_counter()
    out, text = captured(lambda: dp_mixture.run(
        400, quick=True, device="cuda", warmup=EX_DP[0], steps=EX_DP[1]))
    show(f"dp_mixture n=400, 16 chains, {EX_DP[0]} + {EX_DP[1]} transitions",
         time.perf_counter() - t0, text, 4)
    print(f"    gates (outside --quick: L1 < 0.15 and 3 active): L1 "
          f"{out['l1']:.3f}, {out['active']} active")
    if not (np.isfinite(out["l1"]) and abs(out["w_mean"].sum() - 1) < 1e-4):
        raise AssertionError(f"dp_mixture: {out['l1']}, {out['w_mean']}")


# phase 14 (a) runs in a process of its own beside phases 6-13 (host-bound
# program runs that would add ~270 s to the script's time on the card);
# the parent prints what it printed and takes the launches it counted
EXAMPLES_JSON = os.path.join("build", "examples_child.json")
_CHILDREN = []


def examples_child(out_path):
    """``chip_smoke.py --examples-child PATH``: phase 14 (a), the eight
    programs, with their output, the stretch-kernel launches they made and
    any failure written to PATH as JSON. Exit code 0 if they passed."""
    import contextlib
    import io
    import traceback

    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch.ops import fused_stretch as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launches(fs)
    result, buf = {"ok": False, "error": ""}, io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            example_programs(mt, card_line())
        result["ok"] = True
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()[-6000:]
    result.update(output=buf.getvalue(), launches=dict(fs.LAUNCHES))
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0 if result["ok"] else 1


def start_examples(root):
    """Start phase 14 (a)'s process; its errors go to a log beside it."""
    path = os.path.join(root, EXAMPLES_JSON)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    err = open(path + ".err", "w")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--examples-child", path],
        cwd=root, stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    _CHILDREN.append(child)
    _EXAMPLES_CHILD.append(child)
    return child, path


def finish_examples(child, path, timeout_s=900):
    """Wait for phase 14 (a)'s process, print its output and return the
    stretch-kernel launches it counted; fail if it failed."""
    try:
        rc = child.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise AssertionError(f"the example programs ran past {timeout_s} s")
    if not os.path.exists(path):
        with open(path + ".err") as f:
            raise AssertionError(f"the example programs' process exited {rc} "
                                 f"with no result:\n{f.read()[-4000:]}")
    with open(path) as f:
        result = json.load(f)
    print(result["output"], end="", flush=True)
    if rc != 0 or not result["ok"]:
        raise AssertionError(f"the example programs failed (exit {rc}):\n"
                             f"{result['error']}")
    return result["launches"]


def native_arena(mt, card):
    """Phase 14 (b): the flagship's rows stored by the native arena and by
    numpy, float32 and bf16, bit for bit; the seconds inside
    ``Chain.append``. Returns the float32 rows (numpy, before compaction)
    for (c)."""
    from mcmcpp_tpu_torch import native

    # the sanitized C++ test runs in the CPU tests: the g++ beside a card may
    # have no ASAN runtime to link
    t0 = time.perf_counter()
    lib = native.build()
    print(f"  native arena {lib.name} built with g++ in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    flagship = mt.equicorrelated_gaussian(P_FULL, 0.5, device="cuda")
    rows = None
    for label, dtype, store in [("float32", np.float32, None),
                                ("bfloat16", "bfloat16", torch.bfloat16)]:
        got = {}
        for backend in ("numpy", "native"):
            chain = mt.Chain(W_FULL, P_FULL, dtype=dtype, backend=backend,
                             max_bytes=8 << 30)
            if chain.backend != backend:
                raise AssertionError(f"asked {backend}, runs {chain.backend}")
            s = mt.EnsembleSampler(flagship, W_FULL, P_FULL,
                                   mover=mt.FusedStretchMove(), seed=0,
                                   batched=True, device="cuda",
                                   store_dtype=store, chain=chain)
            s.init_ball(np.zeros(P_FULL), 0.5)
            s.run_mcmc(NATIVE_BURN, store=False)
            secs = []
            append = chain.append

            def timed(pos, logp, _append=append, _into=secs):
                t0 = time.perf_counter()
                ok = _append(pos, logp)
                _into.append(time.perf_counter() - t0)
                return ok

            chain.append = timed
            if not s.run_mcmc(NATIVE_STEPS, thin=10):
                raise AssertionError("chain capacity hit")
            chain.append = append
            got[backend] = chain
            print(f"  {label} rows ({chain.nbytes // chain.n_steps / 1e6:.1f}"
                  f" MB a "
                  f"row), {backend}: {len(secs)} appends, "
                  f"{np.mean(secs) * 1e3:.1f} ms a row inside Chain.append "
                  f"({', '.join(f'{x * 1e3:.1f}' for x in secs)}) [{card}]",
                  flush=True)
            del s
        a, b = got["native"], got["numpy"]
        if rows is None:
            rows = b.get()
        same = (np.array_equal(a.get(held=True), b.get(held=True))
                and np.array_equal(a.get_logp(held=True),
                                   b.get_logp(held=True))
                and all(np.array_equal(x, y) for x, y in zip(
                    a.iter_steps(burn_in=1), b.iter_steps(burn_in=1))))
        a.compact(burn_in=1, thin=2)
        b.compact(burn_in=1, thin=2)
        same = same and a.n_steps == b.n_steps == 2 and np.array_equal(
            a.get(held=True), b.get(held=True)) and np.array_equal(
                a.get_logp(held=True), b.get_logp(held=True))
        if not same:
            raise AssertionError(f"{label}: the native arena's rows differ "
                                 "from numpy's")
        print(f"  {label}: native == numpy bit for bit on get, get_logp, "
              "iter_steps and compact", flush=True)
    return rows


def numpy_on_the_card(mt, x, card):
    """Phase 14 (c): ``autocorr_time`` on a numpy flagship chain lands on
    the card (timed beside ``device="cpu"``); ``run_until_converged`` takes
    the ACT on the sampler's device and passes phase 8's gate."""
    from mcmcpp_tpu_torch.analysis import autocorr

    if not (isinstance(x, np.ndarray) and x.shape[0] >= 4):
        raise AssertionError(f"(c) needs 4 numpy rows or more, got {x.shape}")
    seen = []
    real = autocorr._norm_autocov_fft

    def recording(series):
        seen.append(series.device.type)
        return real(series)

    autocorr._norm_autocov_fft = recording
    try:
        secs = {}
        for label, kw in [("card", {}), ("cpu", {"device": "cpu"}),
                          ("card again", {})]:
            seen.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tau = mt.analysis.autocorr_time(x, **kw)
            torch.cuda.synchronize()
            secs[label] = (time.perf_counter() - t0, tau, set(seen))
        if secs["card"][2] != {"cuda"} or secs["cpu"][2] != {"cpu"}:
            raise AssertionError(f"autocorr_time ran on {secs}")
        # the ESS family on the same numpy chain runs its FFT on the card too
        seen.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ess = mt.analysis.effective_sample_size(x)
        torch.cuda.synchronize()
        ess_s = time.perf_counter() - t0
        if set(seen) != {"cuda"}:
            raise AssertionError(f"effective_sample_size ran on {seen}")
        print(f"  effective_sample_size of the numpy chain: on the card "
              f"{ess_s:.3f} s, ess {np.asarray(ess)[:3].tolist()}... "
              f"[{card}]", flush=True)
        np.testing.assert_allclose(secs["card"][1], secs["cpu"][1], rtol=1e-4)
        nan = "; NaN: a walker that holds still over the rows has a 0/0 " \
            "autocorrelation, as in the JAX package" if np.isnan(
                secs["card"][1]).any() else ""
        print(f"  autocorr_time of a numpy {x.shape} float32 chain: on the "
              f"card {secs['card'][0]:.3f} s (again {secs['card again'][0]:.3f}"
              f" s), device='cpu' {secs['cpu'][0]:.3f} s, tau "
              f"{secs['card'][1][:3].tolist()}...{nan} [{card}]", flush=True)
        sc = mt.EnsembleSampler(mt.skewed_gaussian(0.13, device="cuda"), 320,
                                2, mover=mt.FusedStretchMove(), seed=42,
                                batched=True, device="cuda")
        sc.init_ball(np.zeros(2), scale=0.3)
        sc.run_mcmc(1000, store=False)
        seen.clear()
        t0 = time.perf_counter()
        rep = mt.run_until_converged(sc, max_steps=16000, check_every=2000,
                                     thin=4, rhat_threshold=1.01,
                                     mess_rule=True)
        print(f"  run_until_converged: {rep.reason} after {rep.steps_run} "
              f"steps, {rep.checks} checks, tau {rep.tau.tolist()}, ACT on "
              f"{sorted(set(seen))} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if not (rep.converged and set(seen) == {"cuda"}
                and np.all(rep.tau > 0) and np.all(rep.tau < 20)
                and np.all(rep.rhat < 1.01)):
            raise AssertionError(f"run_until_converged: {rep}, {seen}")
    finally:
        autocorr._norm_autocov_fft = real


# phase 15: the sharded ensemble. (a) The three kernels over R = 4 row shards
# of the flagship half (n = 2^20, P = 10): each shard's launch takes its rows'
# offset row0 and the whole other half (m = 2^20). (b) ShardedEnsembleSampler
# in an NCCL process group of one against EnsembleSampler on the same seed,
# bit for bit: the flagship with the fused kernel and with StretchMove (roll),
# the funnel with the split kernels, the slice move on the skewed Gaussian
# (W = 320). (c) actime and inner_benchmark with --sharded in that group.
SHARD_R = 4
SHARD_BURN, SHARD_STEPS, SHARD_THIN = 20, 40, 10


def sharded_kernels(fs, rnd, flagship, funnel, card, blocker):
    """Phase 15 (a). Returns {kernel: (max_abs_err, ms without the offset,
    ms with it)}: ms is one call on the whole half, one launch without the
    offset and R launches of n/R rows with it."""
    dev = torch.device("cuda")
    n, p = 1 << 20, P_FULL
    m = n // SHARD_R
    starts = range(0, n, m)
    out = {}

    def over_shards(fn):
        parts = [fn(r0, slice(r0, r0 + m)) for r0 in starts]
        return tuple(torch.cat([q[k] for q in parts])
                     for k in range(len(parts[0])))

    # the fused kernel on the flagship
    args, key, _ = half_inputs(rnd, p, n, 15, lp_fn=flagship)
    act, lp, other, shift = args
    whole = fs.fused_stretch_half(*args, key=key, logp_fn=flagship)
    sharded = over_shards(lambda r0, rows: fs.fused_stretch_half(
        act[rows], lp[rows], other, shift, key=key, logp_fn=flagship,
        row0=r0))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(whole, sharded)):
        raise AssertionError("fused_stretch_half over 4 row shards differs "
                             "from one launch")
    errs = []
    for r0 in starts:
        rows = slice(r0, r0 + m)
        u, ue = rnd.philox_unit_uniforms(key, m, dev, row0=r0)
        shard_args = (act[rows], lp[rows], other, shift)
        r_out = fs.fused_stretch_half_reference(*shard_args, u, ue,
                                                logp_fn=flagship, row0=r0)
        _, _, log_ratio = fs.stretch_proposal(*shard_args, u,
                                              logp_fn=flagship, row0=r0)
        errs.append(compare_half(
            f"fused shard row0={r0} of m={n}",
            tuple(t[rows] for t in sharded), r_out, log_ratio, ue))
    last = n - m  # the last shard: its offset is the largest
    out["fused_stretch_half"] = (max(errs), offset_times(
        lambda: fs.fused_stretch_half(*args, key=key, logp_fn=flagship),
        lambda: fs.fused_stretch_half(
            act[last:], lp[last:], other[:m], shift, key=key,
            logp_fn=flagship),
        lambda r0: fs.fused_stretch_half(
            act[r0:r0 + m], lp[r0:r0 + m], other, shift, key=key,
            logp_fn=flagship, row0=r0),
        starts, blocker))
    del args, act, lp, other, shift, whole, sharded

    # the split kernels around the funnel's torch logp
    args, key, (u_all, ue_all) = half_inputs(rnd, p, n, 16, lp_fn=funnel)
    act, lp, other, shift = args
    whole = fs.fused_stretch_half(*args, key=key, logp_fn=funnel)
    sharded = over_shards(lambda r0, rows: fs.fused_stretch_half(
        act[rows], lp[rows], other, shift, key=key, logp_fn=funnel,
        row0=r0))
    prop = over_shards(lambda r0, rows: fs.stretch_propose(
        act[rows], other, shift, key, row0=r0))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(whole, sharded)):
        raise AssertionError("the split half-step over 4 row shards differs "
                             "from one")
    whole_prop = fs.stretch_propose(act, other, shift, key)
    plain_prop = fs.stretch_propose_reference(act, other, shift, u_all)
    lp_new = funnel(whole_prop[0]).contiguous()
    acc = over_shards(lambda r0, rows: fs.stretch_accept(
        act[rows], whole_prop[0][rows], lp[rows], lp_new[rows],
        whole_prop[1][rows], key, row0=r0))
    plain_acc = fs.stretch_accept_reference(act, whole_prop[0], lp, lp_new,
                                            whole_prop[1], ue_all)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(prop, plain_prop))
            and all(torch.equal(a, b) for a, b in zip(acc, plain_acc))
            and all(torch.equal(a, b) for a, b in zip(prop, whole_prop))):
        raise AssertionError("a split kernel over 4 row shards is not its "
                             "plain version bit for bit")
    n_acc = int(plain_acc[2].sum())
    if not 0 < n_acc < n:
        raise AssertionError(f"split shards: {n_acc} accepts, need a mix")
    print(f"  split kernels over {SHARD_R} row shards: propose and accept "
          f"equal their plain versions and one launch bit for bit, "
          f"{n_acc} accepts", flush=True)
    y, fac = whole_prop
    out["stretch_propose"] = (0.0, offset_times(
        lambda: fs.stretch_propose(act, other, shift, key),
        lambda: fs.stretch_propose(act[last:], other[:m], shift, key),
        lambda r0: fs.stretch_propose(act[r0:r0 + m], other, shift, key,
                                      row0=r0),
        starts, blocker))
    out["stretch_accept"] = (0.0, offset_times(
        lambda: fs.stretch_accept(act, y, lp, lp_new, fac, key),
        lambda: fs.stretch_accept(act[last:], y[last:], lp[last:],
                                  lp_new[last:], fac[last:], key),
        lambda r0: fs.stretch_accept(
            act[r0:r0 + m], y[r0:r0 + m], lp[r0:r0 + m], lp_new[r0:r0 + m],
            fac[r0:r0 + m], key, row0=r0),
        starts, blocker))
    bounds, shard_bounds = kernel_bounds(n, p), kernel_bounds(m, p)
    for name, (err, t) in out.items():
        print(f"  {name} P=10: 2^18 rows in one launch {t['shard']:.4f} ms "
              f"without the offset, {t['shard_offset']:.4f} ms with it "
              f"(row0 = 3·2^18, m = 2^20; bound {shard_bounds[name][0]:.4f} "
              f"ms); the 2^20-row half in {SHARD_R} such launches "
              f"{t['half_4']:.4f} ms against {t['half']:.4f} ms in one "
              f"(bound {bounds[name][0]:.4f} ms, {bounds[name][1]}); in "
              f"turns, {t['iters']} calls each; max abs err {err:.3e} "
              f"[{card}]", flush=True)
    return out


def offset_times(half, shard, shard_at, starts, blocker):
    """ms of a kernel on the whole half in one launch (``half``), on one
    shard of it without the offset (``shard``: its rows as a half of their
    own) and with it (``shard_at(row0)``, the last shard), and of the half
    as R offset launches: each pair in turns on the card. 20 calls a
    reading keep the R-launch version's enqueue (~35 µs a launch) inside
    the blocker's 6 ms, so that the device's time is read."""
    iters = 20
    (t_half, t_4), _, _ = in_turns(
        [half, lambda: [shard_at(r0) for r0 in starts]], iters, blocker)
    (t_shard, t_offset), _, _ = in_turns(
        [shard, lambda: shard_at(starts[-1])], iters, blocker)
    return {"half": t_half, "half_4": t_4, "shard": t_shard,
            "shard_offset": t_offset, "iters": iters}


def sharded_runs(mt, fs, flagship, funnel, skewed, card):
    """Phase 15 (b): the sharded runs first (their kernel launches counted:
    the sharded path's), then the unsharded ones on the same seeds, bit for
    bit; then the flagship's rate both ways, in turns. Returns the sharded
    path's launches."""
    cases = [("flagship fused", flagship, mt.FusedStretchMove, W_FULL,
              P_FULL),
             ("funnel fused (split kernels)", funnel, mt.FusedStretchMove,
              W_FULL, P_FULL),
             ("flagship stretch roll", flagship, mt.StretchMove, W_FULL,
              P_FULL),
             ("skewed slice", skewed, mt.EnsembleSliceMove, 320, 2)]

    def run(cls, target, mover, w, p):
        s = cls(target, w, p, mover=mover(), seed=0, batched=True,
                device="cuda")
        s.init_ball(np.zeros(p), 0.5)
        s.run_mcmc(SHARD_BURN, store=False)
        if not s.run_mcmc(SHARD_STEPS, thin=SHARD_THIN):
            raise AssertionError("chain capacity hit")
        got = (s.current_positions.cpu(),
               torch.cat([s.state.logp_red, s.state.logp_black]).cpu(),
               s.get_samples(), s.get_log_probs(), s.accepted_steps,
               s.acceptance_fraction, s.per_walker_accepted)
        del s
        torch.cuda.empty_cache()
        return got

    reset_launches(fs)
    sharded = {label: run(mt.ShardedEnsembleSampler, *rest)
               for label, *rest in cases}
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    print(f"  kernel launches on the sharded path: {launches}", flush=True)
    for label, *rest in cases:
        want = run(mt.EnsembleSampler, *rest)
        got = sharded.pop(label)
        same = [torch.equal(g, w) if isinstance(g, torch.Tensor)
                else np.array_equal(g, w) for g, w in zip(got, want)]
        if not all(same):
            raise AssertionError(f"{label}: sharded != unsharded "
                                 f"(positions, logps, rows, row logps, "
                                 f"accepts, fraction, per walker: {same})")
        print(f"  {label} W={rest[2]}: ShardedEnsembleSampler == "
              f"EnsembleSampler bit for bit ({SHARD_BURN} + {SHARD_STEPS} "
              f"steps at thin {SHARD_THIN}: positions, logps, "
              f"{got[2].shape[0]} stored rows, acceptance {got[5]:.4f})",
              flush=True)
    from mcmcpp_tpu_torch.parallel import distributed
    from mcmcpp_tpu_torch.sampler import run_nostore

    readings = {}
    samplers = {cls: cls(flagship, W_FULL, P_FULL,
                         mover=mt.FusedStretchMove(), seed=0, batched=True,
                         device="cuda")
                for cls in (mt.EnsembleSampler, mt.ShardedEnsembleSampler)}
    for s in samplers.values():
        s.init_ball(np.zeros(P_FULL), 0.5)
        s.state = run_nostore(s.state, s._step_fn, 20)

    def steps(n):
        s.state = run_nostore(s.state, s._step_fn, n)

    for cls in (mt.EnsembleSampler, mt.ShardedEnsembleSampler,
                mt.ShardedEnsembleSampler, mt.EnsembleSampler):
        s = samplers[cls]
        (_, wall_s), enqueue_s = fenced_steps(steps, 100)
        readings.setdefault(cls.__name__, []).append((wall_s, enqueue_s))
    print("  flagship steps, 100 a reading, in turns (unsharded, sharded, "
          "sharded, unsharded): " + "; ".join(
              f"{k} " + ", ".join(
                  f"{100 * W_FULL / w:.6e} walker-updates/s ({w * 1e4:.1f} "
                  f"us a step, the host enqueues for {e * 1e4:.1f})"
                  for w, e in v) for k, v in readings.items())
          + f" [{card}]", flush=True)
    del samplers, s
    torch.cuda.empty_cache()
    # one all-gather of the flagship half alone: its device time, and the
    # host's time to enqueue it (a collective that waited for the device
    # would show the blocker's 6 ms here)
    half = torch.randn((W_FULL // 2, P_FULL), device="cuda")
    buf = torch.empty_like(half)
    blocker = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    group = torch.distributed.distributed_c10d._get_default_group()
    (ms, ms_base), _, (host_us, host_base_us) = in_turns(
        [lambda: distributed.all_gather_rows(buf, half),
         lambda: group._allgather_base(buf, half).wait()], 20, blocker)
    if not torch.equal(buf, half):
        raise AssertionError("the all-gather of a group of one is not a copy")
    print(f"  one all-gather of {half.numel() * 4 / 1e6:.1f} MB in the group "
          f"of one: {ms:.4f} ms of device time a call (20 calls, in turns), "
          f"the host enqueues one in {host_us:.1f} us; the process group's "
          f"own _allgather_base, without torch.distributed's Python layer: "
          f"{ms_base:.4f} ms, {host_base_us:.1f} us [{card}]", flush=True)
    del half, buf, blocker
    torch.cuda.empty_cache()
    return launches


# phase 16: the engines with mesh= at phases 9-11's widths, few steps
SE_CHAINS, SE_P = 1024, 10
SE_PT_RUNGS, SE_PT_WALKERS = 16, 1 << 17
SE_POWER_WALKERS = 1 << 14
SE_GIBBS_CHAINS = 1 << 14
SE_GP_P, SE_GP_CHAINS = 1024, 4096
SE_SMC_PARTICLES = 1 << 20
SE_NESTED_LIVE, SE_NESTED_BATCH = 4096, 1024


def sharded_engines(mt, fs, card):
    """Phase 16: every engine with ``mesh=`` sharded over the NCCL group
    of one (``make_walker_mesh()``; PT also on ``make_ladder_mesh(1)``)
    against the same engine unsharded on the same seeds, by ``torch.equal``.
    The sharded runs go first, the split kernels' launches counted over
    them (SMC's ensemble mutation: the sharded engines' path); then the
    unsharded runs; then each engine's steps timed both ways, in turns,
    from a fence: the host's microseconds until the steps' calls return (a
    step that waits for the device waits inside them), the device
    timeline's microseconds between CUDA events around them (idle time
    included), and the collectives a sharded step calls. Returns the path's
    launches."""
    import torch.distributed as dist

    dev = torch.device("cuda")
    walkers = mt.make_walker_mesh()
    gauss = mt.equicorrelated_gaussian(SE_P, 0.5, device=dev)
    data = torch.randn((1000, SE_P), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    chol, gp_like, _ = gp_problem(SE_GP_P, dev)

    def prior(t):
        return -0.125 * torch.sum(t * t, dim=-1)

    def kw(mesh):
        return {"device": "cuda"} if mesh is None else {"mesh": mesh}

    def gradient(cls, warm, steps, **extra):
        def build(mesh):
            s = cls(gauss, SE_CHAINS, SE_P, seed=0, **extra, **kw(mesh))
            s.init_ball(np.zeros(SE_P), 0.5)
            s.warmup(warm)
            stored(s.run(steps), cls.__name__)
            return s, lambda n: s.run(n, thin=n)

        def result(s):
            return (s.get_samples(), s.get_log_probs(), s.state.position,
                    torch.as_tensor(s.step_size),
                    s.inv_mass if isinstance(s.inv_mass, torch.Tensor)
                    else torch.zeros(()), s.last_mean_accept)

        return build, result

    def sgld(mesh):
        s = mt.SGLDSampler(prior, lambda t, b: -0.5 * torch.sum(
            (b[None] - t[:, None]) ** 2, (-1, -2)), data, SE_CHAINS, SE_P,
            batch_size=100, step_size=2e-5, seed=0, **kw(mesh))
        s.init_ball(np.zeros(SE_P), 0.1)
        stored(s.run(50), "sgld")
        return s, lambda n: s.run(n, thin=n)

    def mclmc(mesh):
        s = mt.MCLMCSampler(gauss, SE_CHAINS, SE_P, seed=0, **kw(mesh))
        s.init_ball(np.zeros(SE_P), 0.5)
        s.tune(100, rounds=2)
        stored(s.run(20), "mclmc")
        return s, lambda n: s.run(n, thin=n)

    def pt(ladder=False, power=False):
        def build(mesh):
            if mesh is not None and ladder:
                mesh = mt.make_ladder_mesh(1)
            if power:
                s = mt.ParallelTemperingSampler(
                    loglike_fn=gauss, logprior_fn=prior,
                    n_walkers=SE_POWER_WALKERS, n_params=SE_P,
                    betas=mt.power_ladder(12), seed=0, batched=True,
                    **kw(mesh))
            else:
                s = mt.ParallelTemperingSampler(
                    gauss, SE_PT_WALKERS, SE_P, n_temps=SE_PT_RUNGS, seed=0,
                    batched=True, **kw(mesh))
            s.init_ball(np.zeros(SE_P), 1.0)
            stored(s.run_mcmc(10, thin=5), "pt")
            return s, lambda n: s.run_mcmc(n, thin=n)

        def result(s):
            out = (s.get_samples(), s.get_log_probs(), s.state.red,
                   s.swap_acceptance)
            return out + ((s.log_evidence("stepping_stone"),) if power
                          else ())

        return build, result

    def gibbs(mesh):
        s = mt.BlockedGibbsSampler(
            [("x", 2, mt.MALAKernel(
                lambda x, o: -0.5 * torch.sum(x * x, -1), 0.5, batched=True)),
             ("z", 3, mt.EllipticalSliceKernel(
                 lambda z, o: -0.5 * torch.sum(
                     (z - torch.sum(o["x"], -1, keepdim=True)) ** 2, -1),
                 prior_scale=np.ones(3), batched=True))],
            SE_GIBBS_CHAINS, seed=0, batched=True,
            logp_fn=lambda v: -0.5 * torch.sum(v["z"] ** 2, -1), **kw(mesh))
        s.init({"x": np.zeros(2), "z": np.zeros(3)})
        stored(s.run(10), "gibbs")
        return s, lambda n: s.run(n, thin=n)

    def gp(cls):
        def build(mesh):
            s = cls(gp_like, np.zeros(SE_GP_P), prior_chol=chol,
                    n_chains=SE_GP_CHAINS, seed=0, batched=True, **kw(mesh))
            s.init_prior()
            stored(s.run(10), cls.__name__)
            return s, lambda n: s.run(n, thin=n)

        return build

    def smc(mesh):
        s = mt.SMCSampler(prior, gauss, lambda g, n: 2.0 * torch.randn(
            (n, SE_P), generator=g, device=dev), SE_SMC_PARTICLES, SE_P,
            n_mcmc=2, mover=mt.FusedStretchMove(), seed=0, batched=True,
            **kw(mesh))
        s.run(max_stages=30)

        def stages(n):
            for _ in range(n):
                s.state = s.apply_stage(s.state, s.draw_stage_noise())

        return s, stages

    def nested(mesh):
        s = mt.NestedSampler(prior, gauss, lambda g, n: 2.0 * torch.randn(
            (n, SE_P), generator=g, device=dev), SE_P,
            n_live=SE_NESTED_LIVE, batch=SE_NESTED_BATCH, n_mcmc=10, seed=0,
            batched=True, **kw(mesh))
        s.run(max_iters=10)
        return s, lambda n: s.run(dlogz=1e-12, max_iters=n)

    def sampled(s):
        return (s.get_samples(), s.chain.get_logp(), s.state["z"]
                if isinstance(s.state, dict) else s.state.position)

    cases = [
        ("hmc", *gradient(mt.HMCSampler, 20, 20, n_leapfrog=8)),
        ("nuts", *gradient(mt.NUTSSampler, 10, 5, max_depth=5)),
        ("chees", *gradient(mt.CheesHMCSampler, 20, 20)),
        ("meads", *gradient(mt.MEADSSampler, 20, 20)),
        ("sgld", sgld, sampled),
        ("mclmc", mclmc, lambda s: sampled(s) + (s.step_size,
                                                s.decoherence_length)),
        ("pt walker layout", *pt()),
        ("pt ladder layout", *pt(ladder=True)),
        ("power pt", *pt(power=True)),
        ("gibbs", gibbs, sampled),
        ("pcn", gp(mt.PCNSampler), lambda s: (
            s.get_samples(), s.get_log_likes(), s.acceptance_fraction)),
        ("elliptical", gp(mt.EllipticalSliceSampler), lambda s: (
            s.get_samples(), s.get_log_likes(), s.state.loglike)),
        ("smc fused", smc, lambda s: (s.state.particles, s.state.log_like,
                                      s.log_evidence, s.beta_ladder)),
        ("nested", nested, lambda s: (s.result.logz, s.result.samples,
                                      s.result.logl, s.result.n_calls)),
    ]

    def equal(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b

    reset_launches(fs)
    sharded = {}
    for label, build, result in cases:
        t0 = time.perf_counter()
        s, steps = build(walkers)
        sharded[label] = (s, steps, result(s), time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    print(f"  kernel launches on the sharded engines' path: {launches}",
          flush=True)
    if launches.get("fused_stretch_half"):
        raise AssertionError("the sharded engines' path launched the fused "
                             "kernel")
    for name in ("stretch_propose", "stretch_accept"):
        if not launches.get(name):
            raise AssertionError(f"SMC's sharded mutation did not launch "
                                 f"{name}")

    calls, originals = count_collectives()

    def per_step(fn, n):
        return per_step_timing(fn, n, calls)

    try:
        for label, build, result in cases:
            s_sh, steps_sh, got, build_sh = sharded.pop(label)
            t0 = time.perf_counter()
            s_un, steps_un = build(None)
            want = result(s_un)
            build_un = time.perf_counter() - t0
            same = [equal(g, w) for g, w in zip(got, want)]
            if not all(same):
                raise AssertionError(f"{label}: sharded != unsharded "
                                     f"({same})")
            n = 4 if label in ("nuts", "smc fused", "nested") else 10
            readings = {}
            for name, fn in (("unsharded", steps_un), ("sharded", steps_sh),
                             ("sharded", steps_sh), ("unsharded", steps_un)):
                readings.setdefault(name, []).append(per_step(fn, n))
            un, sh = readings["unsharded"], readings["sharded"]
            print(f"  {label}: sharded == unsharded by torch.equal "
                  f"({len(same)} results; built and run in {build_sh:.1f} s "
                  f"sharded, {build_un:.1f} s unsharded); a step, in turns "
                  f"(device-timeline us, host us to enqueue): unsharded "
                  + ", ".join(f"{d:.1f} / {h:.1f}" for d, h, _ in un)
                  + "; sharded "
                  + ", ".join(f"{d:.1f} / {h:.1f}" for d, h, _ in sh)
                  + f"; collectives a step: sharded {sh[0][2]:g}, unsharded "
                  f"{un[0][2]:g} [{card}]", flush=True)
            del s_sh, s_un, steps_sh, steps_un
            torch.cuda.empty_cache()
        # what one gather costs the host, alone: the layout's row gather of
        # HMC's (C,) accept probabilities and of PT's (K, H, P) half
        for what, x, fn in [
                ("gather_rows of a (1024,) vector",
                 torch.rand(SE_CHAINS, device=dev), walkers.gather_rows),
                (f"gather of a ({SE_PT_RUNGS}, {SE_PT_WALKERS // 2}, {SE_P}) "
                 "half on dim 1", torch.rand((SE_PT_RUNGS, SE_PT_WALKERS // 2,
                                              SE_P), device=dev),
                 lambda v: walkers.gather(v, dim=1))]:
            for _ in range(5):
                fn(x)
            torch.cuda.synchronize()
            calls[0] = 0
            t0 = time.perf_counter()
            for _ in range(100):
                fn(x)
            host_us = (time.perf_counter() - t0) * 1e4
            torch.cuda.synchronize()
            print(f"  one {what}: {host_us:.1f} us of host time a call "
                  f"(100 calls, {calls[0] / 100:g} collective each) [{card}]",
                  flush=True)
    finally:
        for fn, f in originals.items():
            setattr(dist, fn, f)
    return launches


# phase 17: the variational and time-series engines with mesh= at phases 11
# and 13's widths (the engines' own N, chains, members and paths), their T,
# steps and passes cut
VT_ADVI_STEPS, VT_SVGD_STEPS, VT_PATH_ITERS = 20, 5, 15
VT_NEUTRA_FIT, VT_NEUTRA_STEPS = 20, 3
VT_PF_T, VT_PMMH_T, VT_PMMH_STEPS = 100, 50, 3
VT_RBPF_T, VT_IF2_PASSES, VT_IBIS_ROWS = 200, 2, 200
VT_SMC2_T, VT_ENKF_T, VT_EKS_ITERS = 20, 50, 10


def sharded_vi_ts(mt, fs, card):
    """Phase 17: the variational and time-series engines with ``mesh=``
    sharded over the NCCL group of one (``make_walker_mesh()``) against the
    same engines unsharded on the same seeds, by ``torch.equal``: in a
    group of one the hooks draw from the caller's generator and the
    gradient sums do no arithmetic, so every result is the unsharded
    one's. The sharded runs go first, the stretch kernels' launches
    counted over them (none expected: no engine here runs the stretch
    move); then the unsharded runs; then each engine's unit of work (a fit
    or filter step, a stage, an iteration, a call) timed both ways in
    turns, from a fence: the host's and the device timeline's microseconds
    a unit and the collectives a sharded unit calls. Returns the path's
    launches."""
    import torch.distributed as dist

    from mcmcpp_tpu_torch.examples import data_assimilation as da
    from mcmcpp_tpu_torch.examples import regime_switching as rs
    from mcmcpp_tpu_torch.examples import ssm_mle
    from mcmcpp_tpu_torch.examples import state_space as ss
    from mcmcpp_tpu_torch.examples import streaming

    dev = torch.device("cuda")
    walkers = mt.make_walker_mesh()
    p = EV_P
    gauss = mt.equicorrelated_gaussian(p, 0.5, device=dev)

    def kw(mesh):
        return {"device": "cuda"} if mesh is None else {"mesh": mesh}

    def advi(mesh):
        a = mt.ADVI(gauss, p, full_rank=True, n_mc=SVGD_PARTICLES, seed=0,
                    batched=True, **kw(mesh)).fit(VT_ADVI_STEPS)
        return a, lambda n: a.fit(n)

    def svgd(mesh):
        s = mt.SVGD(gauss, SVGD_PARTICLES, p, batched=True, **kw(mesh))
        s.init(seed=1)
        s.fit(VT_SVGD_STEPS)
        return s, lambda n: s.fit(n)

    logit = mt.logistic_regression(n_data=1000, dim=25, seed=0, device=dev)

    def pathfinder(mesh):
        def call(n=1):
            for _ in range(n):
                r = mt.multi_pathfinder(logit, PATHS, np.zeros(25),
                                        maxiter=VT_PATH_ITERS, batched=True,
                                        **kw(mesh))
            return r

        return call(), call

    funnel = mt.neal_funnel(p)

    def neutra(mesh):
        nt = mt.NeuTra(funnel, p, flow=mt.RealNVP(p, n_layers=6, hidden=64),
                       seed=0, batched=True, **kw(mesh))
        nt.fit(VT_NEUTRA_FIT, batch=NEUTRA_BATCH, learning_rate=2e-3)
        s = nt.make_sampler(mt.HMCSampler, NEUTRA_CHAINS, n_leapfrog=4)
        stored(s.run(VT_NEUTRA_STEPS), "neutra hmc")
        return (nt, s), lambda n: nt.fit(n, batch=NEUTRA_BATCH,
                                         learning_rate=2e-3, resume=True)

    _, sv_ys = ss.sv_data(SV_T)
    sv = sv_with_density(ss)
    mu = torch.tensor([-1.0], device=dev)

    def bootstrap(mesh):
        def call(n=VT_PF_T):
            return mt.particle_filter(100, sv, mu, sv_ys[:n], PF_N,
                                      **kw(mesh))

        return call(), call

    def pmmh(mesh):
        pm = mt.PMMHSampler(sv, sv_ys[:VT_PMMH_T],
                            log_prior=lambda th: -0.5 * th[..., 0] ** 2,
                            n_params=1, n_particles=PMMH_N,
                            proposal_scale=0.3, n_chains=PMMH_CHAINS, seed=0,
                            batched=True, **kw(mesh))
        pm.init(np.zeros((PMMH_CHAINS, 1), np.float32))
        stored(pm.run(VT_PMMH_STEPS), "pmmh")
        return pm, lambda n: pm.run(n, thin=n)

    _, rs_ys = rs.simulate(VT_RBPF_T, seed=7)

    def rbpf(mesh):
        def call(n=VT_RBPF_T):
            return mt.rao_blackwell_filter(0, rs.build_model(rs.SIG_R, dev),
                                           rs_ys[:n], RBPF_N, **kw(mesh))

        return call(), call

    mle_ys = ssm_mle.simulate(IF2_T)

    def if2(mesh):
        def call(n=VT_IF2_PASSES):
            return mt.if2(0, ssm_mle.if2_model(), mle_ys, n_particles=IF2_N,
                          theta0=np.array([0.5, 0.0], np.float32),
                          sigma0=0.05, n_iters=n, cooling=0.9, **kw(mesh))

        return call(), call

    stream = streaming.make_stream(VT_IBIS_ROWS * 4)

    def ibis(mesh):
        s = mt.IBISSampler(
            log_prior_fn=lambda t: -0.5 * t[0] ** 2 / streaming.TAU ** 2,
            loglike_point_fn=lambda t, y: -0.5 * (y - t[0]) ** 2
            - 0.5 * np.log(2 * np.pi),
            prior_sample_fn=lambda g, n: streaming.TAU * torch.randn(
                (n, 1), generator=g, device=g.device),
            n_particles=IBIS_N, n_params=1, batch_size=IBIS_BATCH, seed=0,
            **kw(mesh))
        s.update(stream[:VT_IBIS_ROWS])
        rows = [VT_IBIS_ROWS]

        def stages(n):
            s.update(stream[rows[0]:rows[0] + n * IBIS_BATCH])
            rows[0] += n * IBIS_BATCH

        return s, stages

    smc2_ys = smc2_data(VT_SMC2_T * 4)

    def smc2(mesh):
        base = smc2_local_level(mt, dev, SMC2_M, SMC2_NX, seed=3)
        s = mt.SMC2Sampler(base.ssm, base.log_prior_fn, base.prior_sample_fn,
                           SMC2_M, 1, n_particles=SMC2_NX, seed=3,
                           batched=True, **kw(mesh))
        s.update(smc2_ys[:VT_SMC2_T])
        rows = [VT_SMC2_T]

        def stages(n):
            s.update(smc2_ys[rows[0]:rows[0] + n])
            rows[0] += n

        return s, stages

    truth, da_ys, h_idx = da.simulate_truth(VT_ENKF_T, seed=1)
    da_model = da.build_model(truth[0], h_idx, dev)

    def enkf(variant):
        def build(mesh):
            def call(n=VT_ENKF_T):
                return mt.ensemble_kalman_filter(
                    0, da_model, da_ys[:n], ENKF_N, inflation=1.05,
                    variant=variant, **kw(mesh))

            return call(), call

        return build

    rng = np.random.default_rng(0)
    a_mat = rng.standard_normal((5, 3)).astype(np.float32)
    y_obs = (a_mat @ np.array([0.5, -1.0, 2.0], np.float32)
             + 0.5 * rng.standard_normal(5)).astype(np.float32)
    at = torch.tensor(a_mat, device=dev)

    def eki_eks(fn):
        def build(mesh):
            def call(n=VT_EKS_ITERS):
                return fn(2, lambda th: th @ at.T, y_obs,
                          0.25 * np.eye(5, dtype=np.float32), np.zeros(3),
                          4.0 * np.eye(3, dtype=np.float32),
                          n_ensemble=EKS_J, n_iters=n, **kw(mesh))

            return call(), call

        return build

    flat = lambda ps: torch.cat([q.detach().reshape(-1)  # noqa: E731
                                 for q in ps])
    cases = [
        ("advi full rank", advi, lambda a: (
            torch.tensor(a.elbo_trace), *a.params)),
        ("svgd", svgd, lambda s: (s.particles,)),
        ("multi_pathfinder", pathfinder, lambda r: (
            r.draws, r.pareto_k, r.paths.draws, r.paths.logw)),
        ("neutra", neutra, lambda ns: (
            torch.from_numpy(ns[0].fit_result.elbo_history),
            flat(ns[0].params), ns[1].get_samples())),
        ("bootstrap filter", bootstrap, lambda r: (
            r.loglik, r.filter_means, r.ess)),
        ("pmmh", pmmh, lambda pm: (pm.get_samples(), pm.get_log_probs(),
                                   pm.acceptance_fraction)),
        ("rbpf", rbpf, lambda r: (r.loglik, r.x_means, r.z_stats, r.ess,
                                  r.final_means)),
        ("if2", if2, lambda r: (r.theta, r.swarm, r.loglik_trace)),
        ("ibis", ibis, lambda s: (s.state.particles, s.state.log_w,
                                  s.log_evidence_trace, s.n_resamples)),
        ("smc2", smc2, lambda s: (s.state.theta, s.state.xs,
                                  s.log_evidence_trace, s.n_resamples)),
        ("enkf stochastic", enkf("stochastic"), lambda r: (
            r.loglik, r.means, r.spread, r.ensemble)),
        ("etkf", enkf("etkf"), lambda r: (r.loglik, r.means, r.ensemble)),
        ("eki", eki_eks(mt.ensemble_kalman_inversion), lambda r: (
            r.theta, r.ensemble, r.misfit_trace)),
        ("eks", eki_eks(mt.ensemble_kalman_sampler), lambda r: (
            r.ensemble, r.cov, r.misfit_trace)),
    ]
    # the unit a timed call counts (its n), and what it is
    units = {"advi full rank": (5, "fit step"), "svgd": (2, "fit step"),
             "multi_pathfinder": (1, "call"), "neutra": (5, "fit step"),
             "bootstrap filter": (VT_PF_T, "time step"),
             "pmmh": (2, "transition"), "rbpf": (VT_RBPF_T, "time step"),
             "if2": (1, "pass"), "ibis": (5, "stage"),
             "smc2": (5, "stage"), "enkf stochastic": (VT_ENKF_T,
                                                       "time step"),
             "etkf": (VT_ENKF_T, "time step"),
             "eki": (VT_EKS_ITERS, "iteration"),
             "eks": (VT_EKS_ITERS, "iteration")}

    def equal(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), torch.as_tensor(b).cpu())
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b

    reset_launches(fs)
    sharded = {}
    for label, build, result in cases:
        t0 = time.perf_counter()
        obj, steps = build(walkers)
        sharded[label] = (obj, steps, result(obj), time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    print(f"  stretch-kernel launches on the sharded variational and "
          f"time-series path: {launches}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"the sharded variational and time-series "
                             f"path launched a stretch kernel: {launches}")

    calls, originals = count_collectives()
    try:
        for label, build, result in cases:
            obj_sh, steps_sh, got, build_sh = sharded.pop(label)
            t0 = time.perf_counter()
            obj_un, steps_un = build(None)
            want = result(obj_un)
            build_un = time.perf_counter() - t0
            same = [equal(g, w) for g, w in zip(got, want)]
            if not all(same):
                raise AssertionError(f"{label}: sharded != unsharded "
                                     f"({same})")
            n, unit = units[label]
            readings = {}
            for name, fn in (("unsharded", steps_un), ("sharded", steps_sh),
                             ("sharded", steps_sh), ("unsharded", steps_un)):
                readings.setdefault(name, []).append(
                    per_step_timing(fn, n, calls))
            un, sh = readings["unsharded"], readings["sharded"]
            print(f"  {label}: sharded == unsharded by torch.equal "
                  f"({len(same)} results; built and run in {build_sh:.1f} s "
                  f"sharded, {build_un:.1f} s unsharded); per {unit}, in "
                  f"turns (device-timeline us, host us to enqueue): "
                  f"unsharded " + ", ".join(f"{d:.1f} / {h:.1f}"
                                            for d, h, _ in un)
                  + "; sharded " + ", ".join(f"{d:.1f} / {h:.1f}"
                                             for d, h, _ in sh)
                  + f"; collectives per {unit}: sharded {sh[0][2]:g}, "
                  f"unsharded {un[0][2]:g} [{card}]", flush=True)
            del obj_sh, obj_un, steps_sh, steps_un
            torch.cuda.empty_cache()
    finally:
        for fn, f in originals.items():
            setattr(dist, fn, f)
    return launches


def count_collectives():
    """``(calls, originals)``: the collectives of ``torch.distributed``
    wrapped to count their calls in ``calls[0]``; put ``originals`` back
    when done."""
    import torch.distributed as dist

    calls = [0]
    originals = {}
    for fn in ("all_gather_into_tensor", "all_gather_single", "all_reduce"):
        if hasattr(dist, fn):
            originals[fn] = getattr(dist, fn)

            def counted(*a, _f=originals[fn], **k):
                calls[0] += 1
                return _f(*a, **k)

            setattr(dist, fn, counted)
    return calls, originals


def per_step_timing(fn, n, calls):
    """(device-timeline us, host us, collectives) a step of ``fn(n)``
    (``n`` steps) between two fences, after one warm call."""
    fn(n)  # warm: allocations, a first call's lazy set-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    calls[0] = 0
    start.record()
    t0 = time.perf_counter()
    fn(n)
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) * 1e3 / n, host_s * 1e6 / n,
            calls[0] / n)


def sharded_gather_profile(mt, card):
    """Phase 15 (b), after phase 7: a sharded flagship step's device rows
    under the profiler, and the device time a step spends in the two
    all-gathers (NCCL's kernels, or the copy it makes in a group of one)."""
    from mcmcpp_tpu_torch.sampler import run_nostore

    s = mt.ShardedEnsembleSampler(mt.equicorrelated_gaussian(
        P_FULL, 0.5, device="cuda"), W_FULL, P_FULL,
        mover=mt.FusedStretchMove(), seed=0, batched=True)
    s.init_ball(np.zeros(P_FULL), 0.5)
    s.state = run_nostore(s.state, s._step_fn, 20)
    steps = 50
    rows = device_rows_per_step(
        lambda: run_nostore(s.state, s._step_fn, steps), steps)
    gather = {k: v for k, v in rows.items()
              if "nccl" in k.lower() or "allgather" in k.lower()
              or "Memcpy DtoD" in k}
    if not gather:
        raise AssertionError(f"no all-gather among the device rows: "
                             f"{sorted(rows)}")
    print(f"sharded flagship W=2^21 step, {steps} steps profiled: device "
          f"time {sum(us for _, us in rows.values()):.1f} us/step in "
          f"{sum(n for n, _ in rows.values()):g} launches/step, of which "
          f"the all-gathers {sum(us for _, us in gather.values()):.1f} "
          f"us/step in {sum(n for n, _ in gather.values()):g} [{card}]:")
    for k, (n, us) in sorted(rows.items(), key=lambda r: -r[1][1]):
        print(f"  {n:g} x {us / n:.2f} us  {k[:120]}")
    # where the host's time of one all-gather goes: the host-side rows of
    # 20 calls by self time
    from torch.profiler import ProfilerActivity, profile

    from mcmcpp_tpu_torch.parallel import distributed

    half = s.state.red
    buf = torch.empty((W_FULL // 2, P_FULL), device="cuda")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            distributed.all_gather_rows(buf, half)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print("  host time of an all-gather call, by self time (20 calls): "
          + "; ".join(f"{e.key[:60]} {e.self_cpu_time_total / 20:.1f} us"
                      for e in top[:6]) + f" [{card}]", flush=True)
    del s, half, buf
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--examples-child"] and len(sys.argv) == 3:
        raise SystemExit(examples_child(sys.argv[2]))
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch import _build
    from mcmcpp_tpu_torch.ops import fused_stretch as fs
    from mcmcpp_tpu_torch.ops import random as rnd
    from mcmcpp_tpu_torch.sampler import run_nostore

    # full-float32 plain versions: TF32 would keep ~3 decimal digits and
    # break the kernel-vs-plain tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    chosen = phases_from_argv(sys.argv[1:])

    def run_phase(name):
        return chosen is None or name in chosen

    kernels = {}
    store_launches = {}
    wide = None

    def wide_gauss(q):
        return mt.GaussianTarget(random_chol(q, np.random.default_rng(q)),
                                 device=dev)

    # the targets several phases share
    flagship = mt.equicorrelated_gaussian(10, 0.5, device=dev)
    funnel = mt.neal_funnel(10)
    skewed = mt.skewed_gaussian(0.13, device=dev)

    # -- phase 1: the card ------------------------------------------------
    with phase("1 card and build"):
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        print(f"card: {card}")
        t0 = time.perf_counter()
        lib = _build.load_library()
        print(f"kernel library {_build.library_path().name} ready in "
              f"{time.perf_counter() - t0:.1f} s")
        for line in _build.log_path().read_text().splitlines():
            if "Compiling entry" in line or "registers" in line:
                print("  " + line.strip())
        # the fused kernel's tiles are dynamic shared memory, which ptxas
        # does not count
        print("  fused_stretch_half dynamic shared memory per block: "
              + ", ".join(
                  f"P={q}: {lib.mcmcpp_fused_stretch_half_smem_bytes(q)} B"
                  for q in (2, 10, 16)))
        for q in (65, 100, 128, 257, 297, 384, 512, 784, 785, 1000, 1536,
                  2944, 2945, 3000, 4096):
            print(f"  fused_stretch_wide at P={q}: "
                  f"{fs.WIDE_ROUTES[fs.wide_layout(q, dev)['route']]}, "
                  f"{fs.wide_layout(q, dev)}")

    # -- phase 2: fused kernel vs plain version -----------------------------
    if run_phase("2"):
        with phase("2 fused kernel vs plain"):
            rng = np.random.default_rng(0)
            # the kernels' own u and ue against the plain twin, bit for bit
            for key, n in [(0, 50), (0xDEADBEEFCAFEF00D, 1000),
                           ((1 << 64) - 1, 1 << 20)]:
                k_u, k_ue = fs.kernel_unit_uniforms(key, n, dev)
                torch.cuda.synchronize()
                t_u, t_ue = rnd.philox_unit_uniforms(key, n, dev)
                if not (torch.equal(k_u, t_u) and torch.equal(k_ue, t_ue)):
                    raise AssertionError(
                        f"the kernels' uniforms differ from philox_unit_uniforms "
                        f"(key {key:#x}, n {n})")
            print("  kernel u, ue == philox_unit_uniforms bit for bit "
                  "(n = 50, 1000, 2^20)")
            main_err, main_args, main_key, main_planes = kernel_case(
                fs, rnd, flagship, 1 << 20, seed=1)
            errs = [main_err]

            def gauss(q):
                return mt.GaussianTarget(random_chol(q, rng), device=dev)

            skewed2 = mt.skewed_gaussian(device=dev)
            for target, n, neg, shift in [
                (skewed2, 160, 0, None),
                (gauss(3), 1000, 0, None),
                (gauss(16), 1 << 14, 0, None),
                (flagship, 4096, 5, None),
                (flagship, 1 << 16, 0, 0),
                (flagship, 1 << 16, 0, 1),
                (flagship, 1 << 16, 0, "last"),
                (flagship, 1 << 16, 0, "mid"),
                (flagship, 1000, 7, "negative"),
                (flagship, 1000, 0, "beyond"),
                (flagship, 50, 0, "mid"),
                (skewed2, 160, 0, 1),
                (gauss(7), 1000, 0, "mid"),
                (gauss(13), 1000, 0, 1),
                (gauss(16), 300, 0, "mid"),
            ]:
                errs.append(kernel_case(fs, rnd, target, n, seed=n,
                                        neg_inf_every=neg, shift=shift)[0])

            def kernel_call():
                fs.fused_stretch_half(*main_args, key=main_key, logp_fn=flagship)

            def plain_call():
                fs.fused_stretch_half_reference(*main_args, *main_planes,
                                                logp_fn=flagship)

            # in turns, plain / kernel / kernel / plain, on one card
            blocker = torch.empty(1 << 28, dtype=torch.float32, device=dev)
            (plain_ms, kernel_ms), ((p1, p2), (k1, k2)), (_, host_us) = in_turns(
                [plain_call, kernel_call], 50, blocker)
            print(f"  half-step n=2^20 P=10: kernel {kernel_ms:.4f} ms "
                  f"({k1:.4f}, {k2:.4f}; the host enqueues one call in "
                  f"{host_us:.1f} us), plain {plain_ms:.4f} ms "
                  f"({p1:.4f}, {p2:.4f}) [{card}]")
            kernels.setdefault("fused_stretch_half", {}).update(
                source="mcmcpp_tpu_torch/csrc/fused_stretch.cu",
                max_abs_err=max(errs), ms=kernel_ms, plain_ms=plain_ms)
            # a GaussianTarget wider than fs.MAX_P: the wide kernel
            wide = wide_kernel(mt, fs, rnd, card, blocker)

    # -- phase 2b: the split kernels vs their plain versions ----------------
    if run_phase("2b"):
        with phase("2b split kernels vs plain"):
            blocker = torch.empty(1 << 28, dtype=torch.float32, device=dev)
            split_err, sargs, skey, (u, ue) = split_case(fs, rnd, funnel, 1 << 20,
                                                         seed=2)
            split_errs = [split_err]
            for target, n, neg, nan, shift in [
                (mt.rosenbrock(), 160, 0, 0, None),
                (mt.logistic_regression(dim=4, device=dev), 1000, 0, 0, None),
                (funnel, 4096, 5, 0, None),
                (funnel, 4096, 0, 7, None),
                (funnel, 1 << 16, 0, 0, 0),
                (funnel, 1 << 16, 0, 0, 1),
                (funnel, 1 << 16, 0, 0, "last"),
                (funnel, 1 << 16, 0, 0, "mid"),
                (funnel, 1000, 0, 7, "negative"),
                (funnel, 1000, 0, 0, "beyond"),
                (funnel, 50, 0, 0, "mid"),
                (mt.rosenbrock(), 160, 0, 0, 1),
                (mt.neal_funnel(3), 1000, 0, 0, "mid"),
                (mt.neal_funnel(7), 1000, 0, 0, 1),
                (mt.neal_funnel(33), 1000, 0, 0, "mid"),
                (mt.neal_funnel(64), 300, 0, 0, "last"),
                # GaussianTargets as plain callables (``split_case`` wraps
                # the logp): the split path around their torch logp at the
                # widths it took for them before the wide kernel
                (wide_gauss(65), 1000, 0, 0, "mid"),
                (wide_gauss(100), 4096, 5, 0, None),
                (wide_gauss(100), 300, 0, 0, "last"),
            ]:
                split_errs.append(split_case(fs, rnd, target, n, seed=n + 1,
                                             neg_inf_every=neg, nan_every=nan,
                                             shift=shift)[0])
            act, lp, other, shift = sargs
            prop, fac = fs.stretch_propose_reference(act, other, shift, u)
            lp_new = funnel(prop)
            calls = {
                "split": lambda: fs.fused_stretch_half(*sargs, key=skey,
                                                       logp_fn=funnel),
                "split_plain": lambda: fs.fused_stretch_half_reference(
                    *sargs, u, ue, logp_fn=funnel),
                "propose": lambda: fs.stretch_propose(act, other, shift, skey),
                "propose_plain": lambda: fs.stretch_propose_reference(
                    act, other, shift, u),
                "accept": lambda: fs.stretch_accept(act, prop, lp, lp_new, fac,
                                                    skey),
                "accept_plain": lambda: fs.stretch_accept_reference(
                    act, prop, lp, lp_new, fac, ue),
            }
            ms = {}
            for a, b in [("split_plain", "split"), ("propose_plain", "propose"),
                         ("accept_plain", "accept")]:
                (ms[a], ms[b]), _, _ = in_turns([calls[a], calls[b]], 50,
                                                blocker)
            print(f"  funnel n=2^20 P=10, ms per call (in turns): split half-step "
                  f"{ms['split']:.4f} vs plain {ms['split_plain']:.4f}; propose "
                  f"{ms['propose']:.4f} vs {ms['propose_plain']:.4f}; accept "
                  f"{ms['accept']:.4f} vs {ms['accept_plain']:.4f} [{card}]")
            for name in ("propose", "accept"):
                kernels.setdefault(f"stretch_{name}", {}).update(
                    source="mcmcpp_tpu_torch/csrc/stretch_split.cu",
                    max_abs_err=max(split_errs), ms=ms[name],
                    plain_ms=ms[f"{name}_plain"])
            del sargs, act, lp, other, shift, u, ue, prop, fac, lp_new, calls
            del blocker

    # -- phase 3: the flagship at full width --------------------------------
    if run_phase("3"):
        with phase("3 flagship"):
            n_walkers, burn, n_store, thin = W_FULL, 200, 40, 10
            nosync_steps = 20
            reset_launches(fs)
            s = mt.EnsembleSampler(flagship, n_walkers=n_walkers, n_params=10,
                                   mover=mt.FusedStretchMove(), seed=0,
                                   batched=True, device="cuda")
            s.init_ball(np.zeros(10), 0.5)
            # the step loop alone may not wait on the device: the key comes
            # from the host generator and reaches the kernel by value
            with no_host_sync():
                s.state = run_nostore(s.state, s._step_fn, nosync_steps)
            # three runs, each printed: the step is bound by the host, whose
            # pace varies from run to run
            burn_runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.run_mcmc(burn, store=False)
                torch.cuda.synchronize()
                burn_runs.append(time.perf_counter() - t0)
            if not s.run_mcmc(n_store, thin=thin):
                raise AssertionError("chain capacity hit in the flagship run")
            launches = dict(fs.LAUNCHES)
            n_steps = nosync_steps + 3 * burn + n_store
            if launches != {"fused_stretch_wide": 0,
                            "fused_stretch_half": 2 * n_steps,
                            "stretch_propose": 0, "stretch_accept": 0}:
                raise AssertionError(f"flagship launches {launches}, expected "
                                     f"{2 * n_steps} fused only")
            kernels.setdefault("fused_stretch_half", {}).update(
                launches_per_step=launches["fused_stretch_half"] / n_steps,
                launches=launches["fused_stretch_half"])
            samples = check_stored(s, flagship, "flagship")
            if samples.shape != (n_store // thin, n_walkers, 10):
                raise AssertionError(f"stored shape {samples.shape}")
            acc = s.acceptance_fraction
            print(f"flagship W=2^21 P=10: {launches['fused_stretch_half']} "
                  f"kernel launches, acceptance {acc:.4f}, stored "
                  f"{samples.shape}")
            if not 0.2 < acc < 0.8:
                raise AssertionError(f"flagship acceptance {acc}")
            del samples

            class PlainFusedStretchMove(mt.FusedStretchMove):
                """The same draws and transition through the plain version,
                which has to make the key's planes with the twin's integer
                ops: its time is a plain version's time, not a yardstick."""

                def apply(self, active, active_logp, other, logp_fn, state,
                          noise, beta=1.0):
                    shift, key = noise
                    u, ue = rnd.philox_unit_uniforms(key, active.shape[0],
                                                     active.device)
                    return fs.fused_stretch_half_reference(
                        active, active_logp, other, shift, u, ue,
                        logp_fn=logp_fn, a=self.a)

            sp = mt.EnsembleSampler(flagship, n_walkers=n_walkers, n_params=10,
                                    mover=PlainFusedStretchMove(), seed=0,
                                    batched=True, device="cuda")
            sp.init_ball(np.zeros(10), 0.5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp.run_mcmc(burn, store=False)
            torch.cuda.synchronize()
            plain_burn_s = time.perf_counter() - t0
            rates = ", ".join(f"{burn * n_walkers / t:.6e}" for t in burn_runs)
            plain_rate = burn * n_walkers / plain_burn_s
            print(f"flagship burn-in, {burn} steps a run: kernel {rates} "
                  f"walker-updates/s, plain (with the twin's integer ops for u "
                  f"and ue; no yardstick) {plain_rate:.6e} walker-updates/s "
                  f"({plain_burn_s:.4f} s) [{card}]")
            del s, sp
            torch.cuda.empty_cache()

    # -- phase 4: skewed-Gaussian oracle through the kernel -----------------
    if run_phase("4"):
        with phase("4 skewed oracle (fused)"):
            so = mt.EnsembleSampler(skewed, n_walkers=320, n_params=2,
                                    mover=mt.FusedStretchMove(), seed=42,
                                    batched=True, device="cuda")
            so.init_ball(np.zeros(2), scale=0.3)
            so.run_mcmc(1000, store=False)
            if not so.run_mcmc(8000, thin=4):
                raise AssertionError("chain capacity hit in the oracle run")
            x = so.get_samples()
            cov = np.cov(x.reshape(-1, 2).T)
            tau = mt.analysis.autocorr_time(torch.from_numpy(x).to(dev))
            acc = so.acceptance_fraction
            print(f"skewed oracle: acceptance {acc:.4f}, cov {cov.tolist()}, "
                  f"tau {tau.tolist()}")
            if not 0.6 < acc < 0.8:
                raise AssertionError(f"oracle acceptance {acc}")
            if not np.allclose(cov, SKEWED_COV, atol=0.05):
                raise AssertionError(f"oracle covariance {cov}")
            if not (np.all(tau > 0) and np.all(tau < 20)):
                raise AssertionError(f"oracle autocorrelation time {tau}")

    # -- phase 5: every other mover and partner mode at full width ----------
    class CountingMixture(mt.MixtureMover):
        """The mixture mover, counting the branches it draws."""

        def __init__(self, movers):
            super().__init__(movers)
            self.picks = [0] * len(self.movers)

        def draw_noise(self, *args, **kwargs):
            noise = super().draw_noise(*args, **kwargs)
            self.picks[noise[0]] += 1
            return noise

    sigma = 0.5 * np.ones((10, 10)) + 0.5 * np.eye(10)
    configs = [
        ("stretch_block", flagship,
         lambda: mt.StretchMove(partner_mode="block")),
        ("stretch_gather", flagship,
         lambda: mt.StretchMove(partner_mode="gather")),
        ("walk_roll", flagship, lambda: mt.WalkMove(6)),
        ("walk_gather", flagship,
         lambda: mt.WalkMove(6, partner_mode="gather")),
        ("de_roll", flagship, lambda: mt.DifferentialEvolutionMove()),
        ("de_block", flagship,
         lambda: mt.DifferentialEvolutionMove(partner_mode="block")),
        ("snooker", flagship, lambda: mt.DESnookerMove()),
        ("mh", flagship, lambda: mt.MetropolisHastingsMove(
            covariance=2.38 ** 2 / 10 * sigma)),
        ("dram", flagship, lambda: mt.DRAMMove()),
        ("slice", flagship, lambda: mt.EnsembleSliceMove()),
        ("mixture", flagship, lambda: CountingMixture([
            (mt.FusedStretchMove(), 2.0),
            (mt.DifferentialEvolutionMove(), 1.0),
            (mt.DESnookerMove(), 1.0)])),
        ("fused_funnel", funnel, lambda: mt.FusedStretchMove()),
    ]
    if run_phase("5"):
        with phase("5 every path at W=2^21"):
            steps = BURN_FULL + 2
            for name, target, make in configs:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                mover = make()
                s = mt.EnsembleSampler(target, W_FULL, P_FULL, mover=mover,
                                       seed=0, batched=True, device="cuda")
                s.init_ball(np.zeros(P_FULL), 0.5)
                reset_launches(fs)
                # the step loop alone (s.state carries the int32 accept
                # counters, harvested by the stored run below)
                # the slice move waits on the device by design
                guard = nullcontext if name == "slice" else no_host_sync
                timed_steps = BURN_FULL - WARM_FULL
                with guard():
                    s.state = run_nostore(s.state, s._step_fn, WARM_FULL)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with guard():
                    s.state = run_nostore(s.state, s._step_fn, timed_steps)
                torch.cuda.synchronize()
                burn_s = time.perf_counter() - t0
                if not s.run_mcmc(2):
                    raise AssertionError(f"{name}: chain capacity hit")
                launches = dict(fs.LAUNCHES)
                check_stored(s, target, name)
                acc = s.acceptance_fraction
                lo, hi = ACCEPT_WINDOWS[name]
                if not lo <= acc <= hi:
                    raise AssertionError(f"{name}: acceptance {acc} outside "
                                         f"[{lo}, {hi}]")
                extra = ""
                if name == "slice":
                    extra = (f", {mover.loop_iterations / mover.half_steps:.2f} "
                             "loop iterations per half-step")
                if name == "mixture":
                    want = {"fused_stretch_wide": 0,
                            "fused_stretch_half": mover.picks[0],
                            "stretch_propose": 0, "stretch_accept": 0}
                    if launches != want:
                        raise AssertionError(f"mixture launches {launches}, "
                                             f"expected {want}")
                    extra = f", branch picks {mover.picks}, launches {launches}"
                if name == "fused_funnel":
                    want = {"fused_stretch_wide": 0,
                            "fused_stretch_half": 0,
                            "stretch_propose": 2 * steps,
                            "stretch_accept": 2 * steps}
                    if launches != want:
                        raise AssertionError(f"funnel launches {launches}, "
                                             f"expected {want}")
                    for k in ("stretch_propose", "stretch_accept"):
                        kernels.setdefault(k, {}).update(
                            launches=launches[k],
                            launches_per_step=launches[k] / steps)
                    extra = f", launches {launches}"
                print(f"  {name}: {timed_steps * W_FULL / burn_s:.6e} "
                      f"walker-updates/s ({burn_s:.4f} s for {timed_steps} steps"
                      f"{'' if name == 'slice' else ', no host sync'}), "
                      f"acceptance {acc:.4f}, peak "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB"
                      f"{extra} [{card}]", flush=True)
                del s, mover

            # partner modes in turns, on one card
            torch.cuda.empty_cache()
            for label, make in [("stretch", lambda m: mt.StretchMove(
                                    partner_mode=m)),
                                ("walk6", lambda m: mt.WalkMove(
                                    6, partner_mode=m))]:
                runs = {}
                for mode in ("roll", "block", "gather"):
                    s = mt.EnsembleSampler(flagship, W_FULL, P_FULL,
                                           mover=make(mode), seed=1,
                                           batched=True, device="cuda")
                    s.init_ball(np.zeros(P_FULL), 0.5)
                    s.state = run_nostore(s.state, s._step_fn, 2)
                    runs[mode] = s

                def timed(mode, n=10):
                    s = runs[mode]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    s.state = run_nostore(s.state, s._step_fn, n)
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) / n * 1e3

                order = ["roll", "block", "gather", "gather", "block", "roll"]
                got = {m: [] for m in runs}
                for mode in order:
                    got[mode].append(timed(mode))
                print(f"  partner modes, {label}, W=2^21, ms per step (in turns): "
                      + ", ".join(f"{m} {sum(v) / 2:.4f} ({v[0]:.4f}, "
                                  f"{v[1]:.4f})" for m, v in got.items())
                      + f" [{card}]", flush=True)
                del runs, s
                torch.cuda.empty_cache()

    # phase 14 (a)'s programs start now, after the phases that time kernels
    # and the movers, and run beside phases 6-13
    examples = None
    if run_phase("14"):
        examples = start_examples(os.path.dirname(os.path.abspath(__file__)))

    # -- phase 6: the reference's oracles on the card -----------------------
    if run_phase("6"):
        with phase("6 oracles"):
            for name, make, n_steps, atol in [
                ("walk", lambda: mt.WalkMove(6), 600, 0.12),
                ("de", lambda: mt.DifferentialEvolutionMove(), 2000, 0.15),
                ("mh", lambda: mt.MetropolisHastingsMove(
                    covariance=SKEWED_COV, scale=1.2), 2000, 0.15),
                ("snooker", lambda: mt.DESnookerMove(), 600, 0.15),
                ("dram", lambda: mt.DRAMMove(), 600, 0.15),
                ("mixture", lambda: mt.MixtureMover([
                    (mt.FusedStretchMove(), 2.0),
                    (mt.DifferentialEvolutionMove(), 1.0),
                    (mt.DESnookerMove(), 1.0)]), 2000, 0.15),
                ("slice", lambda: mt.EnsembleSliceMove(), 60, 0.12),
            ]:
                t0 = time.perf_counter()
                so = mt.EnsembleSampler(skewed, 320, 2, mover=make(), seed=42,
                                        batched=True, device="cuda")
                so.init_ball(np.zeros(2), scale=0.3)
                so.run_mcmc(SKEWED_BURN, store=False)
                if not so.run_mcmc(n_steps, thin=4):
                    raise AssertionError(f"skewed {name}: chain capacity hit")
                flat = so.get_samples(flat=True)
                cov = np.cov(flat.T)
                acc = so.acceptance_fraction
                print(f"  skewed {name}: acceptance {acc:.4f}, cov "
                      f"{np.round(cov, 4).tolist()} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                if not np.allclose(cov, SKEWED_COV, atol=atol):
                    raise AssertionError(f"skewed {name}: covariance {cov}")
                if not np.allclose(flat.mean(axis=0), 0.0, atol=0.15):
                    raise AssertionError(f"skewed {name}: mean "
                                         f"{flat.mean(axis=0)}")
                if name == "slice" and not acc > 0.999:
                    raise AssertionError(f"slice acceptance {acc}")

            banana = mt.rosenbrock(1.0, 5.0, 4.0)
            for name, mover, n_steps in [
                    ("fused a=3 (split kernels)", mt.FusedStretchMove(a=3.0),
                     6000),
                    ("walk6", mt.WalkMove(6), 1000),
                    ("de", mt.DifferentialEvolutionMove(), 3000)]:
                reset_launches(fs)
                t0 = time.perf_counter()
                sb = mt.EnsembleSampler(banana, 256, 2, mover=mover, seed=3,
                                        batched=True, device="cuda")
                sb.init_ball(np.array([1.0, 1.0]), scale=0.5, seed=4)
                sb.run_mcmc(BANANA_BURN, store=False)
                if not sb.run_mcmc(n_steps, thin=4):
                    raise AssertionError(f"banana {name}: chain capacity hit")
                flat = sb.get_samples(flat=True)
                mx, vx = flat[:, 0].mean(), flat[:, 0].var()
                ry = (flat[:, 1] - flat[:, 0] ** 2).mean()
                print(f"  banana {name}: E[x] {mx:.4f}, Var[x] {vx:.4f}, "
                      f"E[y - x^2] {ry:.4f}, acceptance "
                      f"{sb.acceptance_fraction:.4f}, launches {fs.LAUNCHES} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
                if not (abs(mx - 1.0) < 0.12 and abs(vx - 2.0) < 0.25 * 2.0
                        and abs(ry) < 0.15):
                    raise AssertionError(f"banana {name}: moments")
                if isinstance(mover, mt.FusedStretchMove) and fs.LAUNCHES != {
                        "fused_stretch_wide": 0, "fused_stretch_half": 0,
                        "stretch_propose": 2 * (BANANA_BURN + 6000),
                        "stretch_accept": 2 * (BANANA_BURN + 6000)}:
                    raise AssertionError(f"banana launches {fs.LAUNCHES}")

            t0 = time.perf_counter()
            phis = np.array([0.8, 0.904761904762])
            ar = mt.AutoRegressiveMove(np.zeros(2), phis, np.ones(2))
            sa = mt.EnsembleSampler(lambda t: torch.zeros_like(t[:, 0]), 100, 2,
                                    mover=ar, seed=5, batched=True, device="cuda")
            sa.set_initial_walker_pos(ar.initial_positions(
                torch.Generator(device=dev).manual_seed(6), 100, device=dev))
            sa.run_mcmc(32768)
            tau = mt.analysis.autocorr_time(
                torch.from_numpy(sa.get_samples()).to(dev))
            print(f"  AcTime: tau {tau.tolist()} vs {ar.true_act.tolist()} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if not np.allclose(tau, ar.true_act, rtol=0.12):
                raise AssertionError(f"AR(1) autocorrelation times {tau}")

            seq = mt.SequenceMove([1.0, 0.5])
            sq = mt.EnsembleSampler(lambda t: torch.zeros_like(t[:, 0]), 100, 2,
                                    mover=seq, seed=0, batched=True,
                                    device="cuda")
            sq.set_initial_walker_pos(seq.initial_positions(None, 100,
                                                            device=dev))
            n_seq = 1000
            sq.run_mcmc(n_seq, store=False)
            want = torch.tensor([1.0, 0.5], device=dev) * n_seq
            if not torch.equal(sq.current_positions,
                               want.expand(100, 2).contiguous()):
                raise AssertionError("sequence positions are not N·step")
            print(f"  InnerBenchmark: {n_seq} steps, positions exactly N·step")

            st = mt.EnsembleSampler(skewed, 320, 2, mover=mt.FusedStretchMove(),
                                    seed=7, batched=True, device="cuda")
            st.init_ball(np.zeros(2), scale=0.3)
            st.run_mcmc(100, step_action=lambda pos, lp: {"mean_logp": lp.mean()})
            m = st.step_metrics["mean_logp"]
            if m.shape != (100,):
                raise AssertionError(f"step_metrics shape {m.shape}")
            np.testing.assert_allclose(m, st.get_log_probs().mean(axis=1),
                                       rtol=1e-5, atol=1e-6)
            print("  step_action: 100 rows, equal to the chain's mean logp")

    # -- phase 8: store, checkpoint, resume, analyse -------------------------
    if run_phase("8"):
        with phase("8 store, checkpoint, resume, analyse"):
            import mcmcpp_tpu_torch.io.checkpoint as ckpt
            from mcmcpp_tpu_torch.chain import e4m3_ready, to_held
            from mcmcpp_tpu_torch.chain_disk import DiskChain
            from mcmcpp_tpu_torch.convergence import run_until_converged
            from mcmcpp_tpu_torch.io import (
                CsvEngine, DataWriter, HistMultiOutput, MatrixOutput, NpzEngine,
                ScalarOutput, load_checkpoint)
            from mcmcpp_tpu_torch.io.engines import read_npz

            root = os.path.dirname(os.path.abspath(__file__))
            out_dir = os.path.join(root, "build", "smoke")
            shutil.rmtree(out_dir, ignore_errors=True)
            os.makedirs(out_dir)
            fused_only = lambda n: {"fused_stretch_wide": 0,  # noqa: E731
                                    "fused_stretch_half": 2 * n,
                                    "stretch_propose": 0, "stretch_accept": 0}
            split_only = lambda n: {"fused_stretch_wide": 0,  # noqa: E731
                                    "fused_stretch_half": 0,
                                    "stretch_propose": 2 * n,
                                    "stretch_accept": 2 * n}

            def full_width(target, seed, **kw):
                return mt.EnsembleSampler(target, W_FULL, P_FULL,
                                          mover=mt.FusedStretchMove(), seed=seed,
                                          batched=True, device="cuda", **kw)

            def bits(t):
                """A reduced tensor's raw bits on the host."""
                view = torch.int16 if t.dtype.itemsize == 2 else torch.uint8
                return t.view(view).cpu().numpy()

            # (a) the store tiers: rows reduced on the card, as raw bits on the host
            for store_dtype, n_steps in [(torch.bfloat16, 60),
                                         (torch.float8_e4m3fn, 20)]:
                thin = 10
                s = full_width(flagship, 0, store_dtype=store_dtype)
                s.init_ball(np.zeros(P_FULL), 0.5)
                s.run_mcmc(20, store=False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.run_mcmc(n_steps, store=False)
                torch.cuda.synchronize()
                nostore_s = time.perf_counter() - t0
                append_s = []
                chain_append = s.chain.append

                def timed_append(pos, logp, _append=chain_append,
                                 _into=append_s):
                    t0 = time.perf_counter()
                    ok = _append(pos, logp)
                    _into.append(time.perf_counter() - t0)
                    return ok

                s.chain.append = timed_append
                reset_launches(fs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not s.run_mcmc(n_steps, thin=thin):
                    raise AssertionError("chain capacity hit in the storing run")
                torch.cuda.synchronize()
                store_s = time.perf_counter() - t0
                if fs.LAUNCHES != fused_only(n_steps):
                    raise AssertionError(f"storing run launched {fs.LAUNCHES}")
                if store_dtype is torch.bfloat16:
                    store_launches = dict(fs.LAUNCHES)
                n_rows = n_steps // thin
                eight_bit = store_dtype.itemsize < 2
                logp_dtype = torch.bfloat16 if eight_bit else store_dtype
                if (s.chain.n_steps != n_rows or s.chain.dtype != store_dtype
                        or s.chain.logp_dtype != logp_dtype):
                    raise AssertionError(
                        f"chain holds {s.chain.n_steps} rows at {s.chain.dtype} "
                        f"/ {s.chain.logp_dtype}")
                row_bytes = W_FULL * (P_FULL * store_dtype.itemsize
                                      + logp_dtype.itemsize)
                if s.chain.nbytes != n_rows * row_bytes:
                    raise AssertionError(f"chain bytes {s.chain.nbytes}")
                # the last stored row is the state (n_steps is a multiple of
                # thin), cast on the card; the CPU's cast gives the same bits
                pos, lp = s._current_ensemble()
                held_pos = s.chain.get(held=True)[-1]
                held_lp = s.chain.get_logp(held=True)[-1]
                for what, held, full, dt in [("rows", held_pos, pos, store_dtype),
                                             ("logp", held_lp, lp, logp_dtype)]:
                    full = e4m3_ready(full, dt)
                    if not (np.array_equal(held, bits(full.to(dt)))
                            and np.array_equal(held, bits(full.cpu().to(dt)))):
                        raise AssertionError(
                            f"{store_dtype}: stored {what} are not the state "
                            "cast on the card and on the CPU, bit for bit")
                # the stored logp against the target at the cast-up rows. The
                # plane alone is exact to its 8 bits (checked bit for bit above);
                # the rows' rounding (2^-9 relative a coordinate under bf16,
                # 2^-4 under e4m3) moves the quadratic form besides, so the
                # bounds are 2^-6 and 2^-2 relative, four and a half times and
                # twice what this target shows at 2^21 rows drawn from it
                rows_up = torch.from_numpy(s.get_samples()[-1]).to(dev)
                lp_up = torch.from_numpy(s.get_log_probs()[-1]).to(dev)
                if rows_up.dtype != torch.float32 or not bool(
                        torch.isfinite(rows_up).all()):
                    raise AssertionError(f"{store_dtype}: cast-up rows")
                dev_rel = ((lp_up - flagship(rows_up)).abs()
                           / lp_up.abs().clamp(min=1.0))
                tol = 2.0 ** -2 if eight_bit else 2.0 ** -6
                in_plane_tol = float((dev_rel <= 2.0 ** -8).float().mean())
                if float(dev_rel.max()) > tol:
                    raise AssertionError(
                        f"{store_dtype}: stored logp against the target at the "
                        f"cast-up rows: max {float(dev_rel.max()):.3e} relative, "
                        f"bound {tol}")
                rate = lambda t: n_steps * W_FULL / t  # noqa: E731
                print(f"  store_dtype={str(store_dtype).split('.')[1]}: "
                      f"{n_steps} steps at thin {thin}, {n_rows} rows of "
                      f"{row_bytes / 1e6:.1f} MB: {rate(store_s):.6e} "
                      f"walker-updates/s storing ({store_s:.4f} s, of which "
                      f"{sum(append_s):.4f} s inside Chain.append: "
                      f"{[round(t, 4) for t in append_s]}), {rate(nostore_s):.6e}"
                      f" with store=False ({nostore_s:.4f} s); stored bits equal "
                      f"the state's cast (card and CPU); logp vs target at the "
                      f"cast-up rows: max {float(dev_rel.max()):.3e} relative (bound "
                      f"{tol:g}; {in_plane_tol:.4f} of the rows within 2^-8) "
                      f"[{card}]", flush=True)
                del s, pos, lp, rows_up, lp_up, dev_rel
            refused = False
            try:
                full_width(flagship, 0, store_dtype=torch.float8_e4m3fn,
                           chain=DiskChain(os.path.join(out_dir, "f8_spool"),
                                           W_FULL, P_FULL,
                                           dtype="float8_e4m3fn"))
            except ValueError as e:
                refused = "logp plane" in str(e)
            if not refused:
                raise AssertionError("an injected 8-bit-logp chain was accepted")
            print("  an injected chain with an 8-bit logp plane is refused")
            # beyond e4m3fn's range the port stores NaN of the value's sign,
            # as the JAX package does, whatever torch's own cast does there:
            # JAX's bits on the card and on the CPU
            edge = torch.tensor([448.0, 464.0, 464.1, -1e4, float("inf")])
            jax_bits = np.array([0x7E, 0x7E, 0x7F, 0xFF, 0x7F], np.uint8)
            on_card = to_held(edge.to(dev), "float8_e4m3fn")
            on_cpu = to_held(edge, "float8_e4m3fn")
            if not (np.array_equal(on_card, jax_bits)
                    and np.array_equal(on_cpu, jax_bits)):
                raise AssertionError(f"e4m3fn beyond its range: card "
                                     f"{on_card}, CPU {on_cpu}, JAX "
                                     f"{jax_bits}")
            print(f"  float8_e4m3fn of {edge.tolist()}: the port's bits "
                  f"{[hex(b) for b in on_card]} on the card and on the CPU, "
                  f"JAX's (torch {torch.__version__}'s own cast gives "
                  f"{edge.to(torch.float8_e4m3fn).float().tolist()})")

            # (b) resume from a checkpoint is bitwise
            saves = []
            real_save = ckpt.save_checkpoint

            def timed_save(sampler, path):
                t0 = time.perf_counter()
                out = real_save(sampler, path)
                saves.append((time.perf_counter() - t0, os.path.getsize(out)))
                return out

            ckpt.save_checkpoint = timed_save
            try:
                for label, target, want, kw in [
                    ("fused", flagship, fused_only, lambda tag: {}),
                    ("funnel_split", funnel, split_only, lambda tag: {}),
                    ("fused_diskchain_bf16", flagship, fused_only,
                     lambda tag: {
                         "store_dtype": torch.bfloat16,
                         "chain": DiskChain(
                             os.path.join(out_dir, f"spool_{tag}"), W_FULL,
                             P_FULL, dtype="bfloat16")}),
                ]:
                    path = os.path.join(out_dir, f"ck_{label}")
                    a = full_width(target, 11, **kw("a"))
                    a.init_ball(np.zeros(P_FULL), 0.5)
                    reset_launches(fs)
                    # thin 40 (1 + 1 rows, cut from 4 + 4 in PR 11 and
                    # from 2 + 2 in PR 16): the snapshot's compressed write
                    # sets this block's pace
                    a.run_mcmc(40, thin=40, checkpoint_path=path,
                               checkpoint_every=8)
                    if fs.LAUNCHES != want(40):
                        raise AssertionError(f"{label}: launches {fs.LAUNCHES}")
                    if label == "funnel_split":
                        store_launches.update(
                            {k: v for k, v in fs.LAUNCHES.items() if v})
                    save_s, save_bytes = saves[-1]
                    b = full_width(target, 99, **kw("b"))
                    t0 = time.perf_counter()
                    load_checkpoint(b, path)
                    load_s = time.perf_counter() - t0
                    a.run_mcmc(40, thin=40)
                    b.run_mcmc(40, thin=40)
                    same = all(torch.equal(x, y)
                               for x, y in zip(a.state[:6], b.state[:6]))
                    same = same and a.state.step == b.state.step == 80
                    same = same and np.array_equal(a.per_walker_accepted,
                                                   b.per_walker_accepted)
                    same = same and a.total_steps == b.total_steps
                    for get in ("get", "get_logp"):
                        ra = torch.from_numpy(getattr(a.chain, get)(held=True))
                        rb = torch.from_numpy(getattr(b.chain, get)(held=True))
                        same = same and ra.shape[0] == 2 and torch.equal(ra, rb)
                    if not same:
                        raise AssertionError(
                            f"{label}: the resumed run differs from the "
                            "uninterrupted one")
                    print(f"  resume {label}: 40 + 40 steps == 40, load, 40 "
                          f"bitwise (state, counters, 2 rows at "
                          f"{a.chain.dtype.name}, backend {a.chain.backend}); "
                          f"checkpoint {save_bytes} B written in {save_s:.2f} s, "
                          f"loaded in {load_s:.2f} s [{card}]", flush=True)
                    del a, b, ra, rb
            finally:
                ckpt.save_checkpoint = real_save

            # (c) a convergence-driven run on the skewed Gaussian (as phase 4)
            sc = mt.EnsembleSampler(skewed, 320, 2, mover=mt.FusedStretchMove(),
                                    seed=42, batched=True, device="cuda")
            sc.init_ball(np.zeros(2), scale=0.3)
            sc.run_mcmc(1000, store=False)
            t0 = time.perf_counter()
            rep = run_until_converged(sc, max_steps=16000, check_every=2000,
                                      thin=4, rhat_threshold=1.01, mess_rule=True)
            print(f"  run_until_converged: {rep.reason} after {rep.steps_run} "
                  f"steps, {rep.checks} checks, tau {rep.tau.tolist()}, rhat "
                  f"{rep.rhat.tolist()}, mESS {rep.mess:.0f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if not (rep.converged and np.all(rep.tau > 0)
                    and np.all(rep.tau < 20) and np.all(rep.rhat < 1.01)):
                raise AssertionError(f"run_until_converged: {rep}")
            chain_sk = sc.get_samples()
            summ = mt.analysis.summary(chain_sk)
            ess = mt.analysis.effective_sample_size(chain_sk)
            want_sd = np.sqrt(np.diag(SKEWED_COV))
            if not (np.allclose(summ["mean"], 0.0, atol=0.05)
                    and np.allclose(summ["sd"], want_sd, atol=0.05)
                    and np.all(summ["rhat"] < 1.01) and np.all(ess > 1000)):
                raise AssertionError(f"summary {summ}, ess {ess}")
            print(f"  summary: mean {summ['mean'].tolist()}, sd "
                  f"{summ['sd'].tolist()} (oracle {want_sd.tolist()}), ess "
                  f"{ess.tolist()}, ess_bulk {summ['ess_bulk'].tolist()}")

            # (d) the Analysis layer on a flagship chain: 600 burn-in steps
            # from the ball, then 4 rows of 2^21 walkers
            s = full_width(flagship, 5)
            s.init_ball(np.zeros(P_FULL), 0.5)
            s.run_mcmc(600, store=False)
            s.run_mcmc(40, thin=10)
            x = s.get_samples()
            flat = x.reshape(-1, P_FULL)
            t0 = time.perf_counter()
            cov = mt.analysis.covariance_matrix(x)
            cov_np_input_s = time.perf_counter() - t0
            xt = torch.from_numpy(x).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cov_t = mt.analysis.covariance_matrix(xt)
            cov_dev_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = np.cov(flat.astype(np.float64).T)
            ref_s = time.perf_counter() - t0
            rel = np.abs(cov - ref).max() / np.abs(ref).max()
            if not (rel <= 1e-5 and np.array_equal(cov, cov_t)):
                raise AssertionError(f"covariance on the card off by {rel}")
            off_truth = np.abs(cov - sigma).max()
            corr = mt.analysis.correlation_matrix(xt)
            if not (off_truth <= 0.02 and np.allclose(np.diag(corr), 1.0)
                    and np.abs(corr - (0.5 + 0.5 * np.eye(P_FULL))).max()
                    <= 0.02):
                raise AssertionError(f"covariance {off_truth} from the truth")
            print(f"  covariance_matrix of {flat.shape} float32 rows: on the "
                  f"card {cov_dev_s * 1e3:.2f} ms (a tensor there), "
                  f"{cov_np_input_s * 1e3:.1f} ms from a numpy array, float64 "
                  f"np.cov on the host {ref_s * 1e3:.1f} ms; {rel:.3e} relative "
                  f"to it (bound 1e-5); {off_truth:.4f} absolute from "
                  f"Sigma after 600 + 40 steps (bound 0.02) [{card}]",
                  flush=True)
            sub = x[-1, ::16]
            ch = mt.analysis.CornerHistograms(n_bins=50).calculate(sub)
            if (len(ch.hist1d) != P_FULL or len(ch.hist2d) != 45
                    or any(c.sum() != sub.shape[0] for c, _ in ch.hist1d)
                    or any(c.sum() != sub.shape[0]
                           for c, _, _ in ch.hist2d.values())):
                raise AssertionError("corner histograms lose samples")
            pf = mt.analysis.PercentileAndMaximumFinder(n_bins=64)
            pf.process_chain_data(sub)
            med = [pf.get_value_from_percentile(i, 50.0) for i in range(P_FULL)]
            sig = [pf.get_value_from_percentile(i, 84.134) for i in range(P_FULL)]
            peaks = [pf.get_peak_location(i) for i in range(P_FULL)]
            if not (np.allclose(med, 0.0, atol=0.03)
                    and np.allclose(sig, 1.0, atol=0.03)
                    and np.allclose(peaks, 0.0, atol=0.5)):
                raise AssertionError(f"percentiles {med}, {sig}, peaks {peaks}")
            print(f"  corner histograms (10 + 45) and percentiles of "
                  f"{sub.shape[0]} walkers: medians within "
                  f"{np.abs(med).max():.4f}, +1 sigma within "
                  f"{np.abs(np.array(sig) - 1).max():.4f} of 1")
            outputs = [MatrixOutput("covariance", cov),
                       ScalarOutput("acceptance", s.acceptance_fraction),
                       HistMultiOutput("corner", ch)]
            with DataWriter(CsvEngine(os.path.join(out_dir, "csv"))) as w:
                for o in outputs:
                    w.add(o)
            with DataWriter(NpzEngine(os.path.join(out_dir, "out.npz"))) as w:
                for o in outputs:
                    w.add(o)
            arrays, _ = read_npz(os.path.join(out_dir, "out.npz"))
            n_written = 0
            for o in outputs:
                for name, array, _ in o.emit():
                    back = np.loadtxt(os.path.join(out_dir, "csv", f"{name}.csv"),
                                      delimiter=",", comments="#", ndmin=2)
                    array = np.asarray(array)
                    if not (np.array_equal(arrays[name], array)
                            and np.array_equal(back.reshape(array.shape),
                                               array.astype(np.float64))):
                        raise AssertionError(f"{name} does not read back equal")
                    n_written += 1
            print(f"  DataWriter: {n_written} outputs through the CSV and NPZ "
                  "engines, read back equal")
            del s, x, xt, flat

            # (e) the reference's three test programs, as a user runs them,
            # the three processes at once; actime and inner_benchmark at cut
            # steps (§4 of PERF.md), to make room for phase 15
            t0 = time.perf_counter()
            runs = {}
            for mod, extra in [("skewed_gaussian",
                                ["--outdir", os.path.join(out_dir, "skewed")]),
                               ("actime", ["--steps", "16384"]),
                               ("inner_benchmark", ["--steps", "5000"])]:
                runs[mod] = subprocess.Popen(
                    [sys.executable, "-m", f"mcmcpp_tpu_torch.examples.{mod}",
                     "--device", "cuda", *extra],
                    cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                _CHILDREN.append(runs[mod])
            for mod, proc in runs.items():
                out, err = proc.communicate(timeout=300)
                print("    " + out.strip().replace("\n", "\n    "))
                if proc.returncode != 0:
                    raise AssertionError(
                        f"example {mod} exited {proc.returncode}: "
                        f"{err[-2000:]}")
                print(f"  example {mod}: exit 0 (the three at once "
                      f"{time.perf_counter() - t0:.1f} s)", flush=True)
            torch.cuda.empty_cache()

    # -- phase 9: the gradient engines (no hand kernel on their path) --------
    if run_phase("9"):
        with phase("9 gradient engines"):
            gradient_engines(mt, card, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "build", "smoke"))
            torch.cuda.empty_cache()

    # -- phase 10: the population engines (no hand kernel on their path) -----
    if run_phase("10"):
        with phase("10 population engines"):
            population_engines(mt, card, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "build", "smoke"))
            torch.cuda.empty_cache()

    # -- phase 11: the evidence and variational engines; the SMC ensemble
    # mutation with FusedStretchMove runs the split kernels ------------------
    smc_launches = {}
    if run_phase("11"):
        with phase("11 evidence and variational engines"):
            smc_launches = evidence_engines(mt, fs, rnd, card, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "build", "smoke"))
            torch.cuda.empty_cache()

    # -- phase 12: the DSL, the GP models and the rest of the analysis layer;
    # the ensemble sampler on the DSL's logp runs the split kernels ---------
    dsl_launches = {}
    if run_phase("12"):
        with phase("12 DSL, GP models and analysis"):
            dsl_launches = dsl_gp_analysis(mt, fs, rnd, card, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "build", "smoke"))
            torch.cuda.empty_cache()

    # -- phase 13: the time-series layer (no hand kernel on its path: the
    # stretch kernels' launches there are counted and must stay 0) ----------
    ts_launches = {}
    if run_phase("13"):
        with phase("13 time-series layer"):
            reset_launches(fs)
            time_series(mt, card, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "build", "smoke"))
            ts_launches = dict(fs.LAUNCHES)
            if any(ts_launches.values()):
                raise AssertionError(f"the time-series path launched a "
                                     f"stretch kernel: {ts_launches}")
            print(f"  stretch-kernel launches on the time-series path: "
                  f"{ts_launches}", flush=True)
            torch.cuda.empty_cache()

    # -- phase 14: the eight later example programs (no hand kernel on their
    # path: the stretch kernels' launches there are counted and must stay 0),
    # the native chain arena against numpy, numpy inputs on the card ---------
    ex_launches = {}
    if run_phase("14"):
        with phase("14 example programs, native arena, numpy on the card"):
            ex_launches = finish_examples(*examples)
            if any(ex_launches.values()):
                raise AssertionError(f"the examples' path launched a stretch "
                                     f"kernel: {ex_launches}")
            print(f"  stretch-kernel launches on the examples' path: "
                  f"{ex_launches}", flush=True)
            torch.cuda.empty_cache()
            rows = native_arena(mt, card)
            torch.cuda.empty_cache()
            numpy_on_the_card(mt, rows, card)
            del rows
            torch.cuda.empty_cache()

    # -- phase 15: the sharded ensemble in an NCCL process group of one: the
    # kernels over row shards, ShardedEnsembleSampler against EnsembleSampler
    # bit for bit, the two examples with --sharded -----------------------------
    sharded_launches = {}
    if run_phase("15"):
        with phase("15 sharded ensemble"):
            from mcmcpp_tpu_torch.examples import actime, inner_benchmark
            from mcmcpp_tpu_torch.parallel import distributed

            # stays up to the end: the profiled step after phase 7 needs it
            rank, world = distributed.initialize(device=dev)
            if (rank, world) != (0, 1) or (
                    torch.distributed.get_backend() != "nccl"):
                raise AssertionError(
                    f"expected an NCCL group of one, got rank {rank} of "
                    f"{world}, {torch.distributed.get_backend()}")
            blocker = torch.empty(1 << 28, dtype=torch.float32, device=dev)
            for name, (err, t) in sharded_kernels(
                    fs, rnd, flagship, funnel, card, blocker).items():
                k = kernels.setdefault(name, {})
                k["max_abs_err"] = max(k.get("max_abs_err", 0.0), err)
                k["row_offset_ms"] = t
            del blocker
            torch.cuda.empty_cache()
            sharded_launches = sharded_runs(mt, fs, flagship, funnel, skewed,
                                            card)
            # their steps cut (§4 of PERF.md): each collective call costs the
            # host ~160 us; at 32768 steps actime's estimates stayed within
            # 5% of the truth against its 12% gate, so 16384 steps
            for mod, steps in ((actime, "16384"), (inner_benchmark, "5000")):
                t0 = time.perf_counter()
                rc = mod.main(["--sharded", "--steps", steps])
                if rc != 0:
                    raise AssertionError(f"{mod.__name__} --sharded exited "
                                         f"{rc}")
                print(f"  {mod.__name__} --sharded: exit 0 "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
            torch.cuda.empty_cache()

    # -- phase 16: the engines with mesh= in the NCCL group of one (the one
    # of phase 15, else its own), sharded == unsharded bit for bit; SMC's
    # sharded mutation runs the split kernels -------------------------------
    sharded_engines_launches = {}
    if run_phase("16"):
        with phase("16 sharded engines"):
            from mcmcpp_tpu_torch.parallel import distributed

            made = not torch.distributed.is_initialized()
            distributed.initialize(device=dev)
            if torch.distributed.get_backend() != "nccl" or (
                    distributed.world_size() != 1):
                raise AssertionError("phase 16 needs an NCCL group of one")
            sharded_engines_launches = sharded_engines(mt, fs, card)
            if made:
                torch.distributed.destroy_process_group()
            torch.cuda.empty_cache()

    # -- phase 17: the variational and time-series engines with mesh= in the
    # NCCL group of one (the one of phase 15, else its own), sharded ==
    # unsharded bit for bit; no stretch kernel on their path -----------------
    vi_ts_launches = {}
    if run_phase("17"):
        with phase("17 sharded variational and time-series engines"):
            from mcmcpp_tpu_torch.parallel import distributed

            made = not torch.distributed.is_initialized()
            distributed.initialize(device=dev)
            if torch.distributed.get_backend() != "nccl" or (
                    distributed.world_size() != 1):
                raise AssertionError("phase 17 needs an NCCL group of one")
            vi_ts_launches = sharded_vi_ts(mt, fs, card)
            if made:
                torch.distributed.destroy_process_group()
            torch.cuda.empty_cache()

    # -- phase 7: what a flagship step puts on the device --------------------
    # Last, because the profiler's tracing stays attached to the process
    # and slows every later launch: no timing may follow it.
    if run_phase("7"):
        with phase("7 steps under the profiler"):
            prof_steps = 50
            for label, target, expect in [
                    ("flagship", flagship, {"fused_stretch_half": 2}),
                    ("funnel", funnel, {"stretch_propose": 2,
                                        "stretch_accept": 2})]:
                s = mt.EnsembleSampler(target, n_walkers=W_FULL,
                                       n_params=P_FULL,
                                       mover=mt.FusedStretchMove(), seed=0,
                                       batched=True, device="cuda")
                s.init_ball(np.zeros(P_FULL), 0.5)
                s.state = run_nostore(s.state, s._step_fn, 20)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.state = run_nostore(s.state, s._step_fn, prof_steps)
                enqueue_us = (time.perf_counter() - t0) / prof_steps * 1e6
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) / prof_steps * 1e6
                rows = device_rows_per_step(
                    lambda: run_nostore(s.state, s._step_fn, prof_steps),
                    prof_steps)
                print(f"{label} W=2^21, {prof_steps} steps: unprofiled wall "
                      f"{wall_us:.1f} us/step, of which the host enqueues for "
                      f"{enqueue_us:.1f}; profiled device time "
                      f"{sum(us for _, us in rows.values()):.1f} us/step in "
                      f"{sum(n for n, _ in rows.values()):g} launches/step "
                      f"[{card}]:")
                for k, (n, us) in sorted(rows.items(), key=lambda r: -r[1][1]):
                    print(f"  {n:g} x {us / n:.2f} us  {k[:120]}")
                for kernel in fs.LAUNCHES:
                    got = sum(n for k, (n, _) in rows.items() if kernel in k)
                    if got != expect.get(kernel, 0):
                        raise AssertionError(
                            f"a {label} step must launch {kernel} "
                            f"{expect.get(kernel, 0)} times, saw {got}")
                # torch.rand's kernel is a float distribution kernel built by
                # uniform_and_transform (the shift's randint is an unsigned int
                # one)
                drawn = [k for k in rows
                         if "distribution_elementwise_grid_stride_kernel<float"
                         in k or "uniform_and_transform" in k
                         or "uniform_real" in k
                         or (label == "flagship" and "clamp" in k.lower())]
                if drawn:
                    raise AssertionError(f"a {label} step still draws or clamps "
                                         f"planes on the device: {drawn}")
                del s
                torch.cuda.empty_cache()

            # a storing run in the same window: what the store path adds to the
            # device (the row copies that cast to the stored dtype, the chunks'
            # device-to-host copies) beside the steps
            s = mt.EnsembleSampler(flagship, W_FULL, P_FULL,
                                   mover=mt.FusedStretchMove(), seed=0,
                                   batched=True, device="cuda",
                                   store_dtype=torch.bfloat16)
            s.init_ball(np.zeros(P_FULL), 0.5)
            s.run_mcmc(20, thin=10)
            rows = device_rows_per_step(lambda: s.run_mcmc(20, thin=10), 20)
            print(f"storing run (bf16 rows, 20 steps at thin 10, 2 rows), per "
                  f"step: profiled device time "
                  f"{sum(us for _, us in rows.values()):.1f} us in "
                  f"{sum(n for n, _ in rows.values()):g} launches [{card}]:")
            for k, (n, us) in sorted(rows.items(), key=lambda r: -r[1][1]):
                print(f"  {n:g} x {us / n:.2f} us  {k[:120]}")
            if not any("Memcpy DtoH" in k for k in rows):
                raise AssertionError("the storing run shows no device-to-host "
                                     "copy under the profiler")
            del s
            torch.cuda.empty_cache()

            # a PT step of phase 10 (a): K = 16 rungs of 2^17 walkers as one
            # vmapped half-step each, no hand kernel
            pt = mt.ParallelTemperingSampler(
                flagship, PT_WALKERS, P_FULL, n_temps=PT_RUNGS, seed=0,
                batched=True, device="cuda")
            pt.init_ball(np.zeros(P_FULL), 1.0)

            def pt_steps(n):
                state = pt.state
                for _ in range(n):
                    state = pt.step(state)
                pt.state = state

            pt_steps(10)
            (_, wall_s), enqueue_s = fenced_steps(pt_steps, 20)
            rows = device_rows_per_step(lambda: pt_steps(20), 20)
            print(f"PT K={PT_RUNGS} W={PT_WALKERS} P={P_FULL}, 20 steps: "
                  f"unprofiled "
                  f"wall {wall_s / 20 * 1e6:.1f} us/step, of which the host "
                  f"enqueues for {enqueue_s / 20 * 1e6:.1f}; profiled device "
                  f"time {sum(us for _, us in rows.values()):.1f} us/step in "
                  f"{sum(n for n, _ in rows.values()):g} launches/step "
                  f"[{card}]:")
            for k, (n, us) in sorted(rows.items(), key=lambda r: -r[1][1]):
                print(f"  {n:g} x {us / n:.2f} us  {k[:120]}")
            if any(kernel in k for k in rows for kernel in fs.LAUNCHES):
                raise AssertionError("a PT step launched a stretch kernel")
            del pt
            torch.cuda.empty_cache()

    # phase 12 (a)'s launches per logp evaluation: under the profiler, so
    # after phase 7
    if run_phase("12"):
        with phase("12 (a) launches per logp evaluation, profiled"):
            dsl_launch_count(mt, card)

    # phase 13's launches per time step: under the profiler, so after phase 7
    if run_phase("13"):
        with phase("13 launches per time step, profiled"):
            time_series_launch_count(mt, card)

    # phase 15's all-gather under the profiler: after phase 7
    if run_phase("15"):
        with phase("15 (b) the sharded step's all-gathers, profiled"):
            sharded_gather_profile(mt, card)
            torch.distributed.destroy_process_group()

    if chosen is not None:
        # a chosen subset: the kernel line needs every phase's launches
        print(f"phases {sorted(chosen)} only: no kernel line")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return
    for name, k in kernels.items():
        if not (k.get("launches") and store_launches.get(name)):
            raise AssertionError(f"{name} was not launched on its main path")
    for name in kernels:
        if not sharded_launches.get(name):
            raise AssertionError(f"{name} was not launched on the sharded "
                                 "path")
    for name in ("stretch_propose", "stretch_accept"):
        if not smc_launches.get(name):
            raise AssertionError(f"{name} was not launched on the SMC path")
        if not sharded_engines_launches.get(name):
            raise AssertionError(f"{name} was not launched on the sharded "
                                 "engines' path")
        if not dsl_launches.get(name):
            raise AssertionError(f"{name} was not launched on the DSL path")
    if wide is None or not wide["launches"]:
        raise AssertionError("fused_stretch_wide was not launched on its "
                             "main path")
    # ms, plain_ms and bound_ms at n = 2^20, P = 10, the half-step of the
    # main path (the wide kernel's at P = 100, its first sampler's; its
    # launches those of its samplers at P = 100 and 257). library_ms is
    # null: no one PyTorch call computes any of the four functions (the
    # plain versions are four to ten ops each).
    bounds = kernel_bounds(1 << 20, P_FULL)
    wide_bound = kernel_bounds(1 << 20, wide["p"])["fused_stretch_wide"]
    paths = {"store": store_launches, "smc": smc_launches,
             "dsl": dsl_launches, "timeseries": ts_launches,
             "examples": ex_launches, "sharded": sharded_launches,
             "sharded_engines": sharded_engines_launches,
             "sharded_vi_ts": vi_ts_launches}
    wide_line = {
        "name": "fused_stretch_wide", "route": "cuda",
        "source": wide["source"],
        "replaces": "mcmcpp_tpu/ops/pallas_stretch.py:164",
        "launches": wide["launches"],
        "launches_per_step": wide["launches_per_step"],
        **{f"launches_{k}_path": d.get("fused_stretch_wide", 0)
           for k, d in paths.items()},
        "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
        "plain_ms": wide["plain_ms"], "bound_ms": wide_bound[0],
        "bound_by": wide_bound[1], "library_ms": None, "p": wide["p"],
        "split_route_ms": wide["split_route_ms"],
        "walker_updates_per_s": wide["walker_updates_per_s"],
        "split_route_walker_updates_per_s":
            wide["split_route_walker_updates_per_s"],
        "launches_by_p": wide["launches_by_p"],
        "sampler_by_p": wide["sampler_by_p"], "by_p": wide["by_p"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": "mcmcpp_tpu/ops/pallas_stretch.py:164",
         "launches": k["launches"],
         "launches_per_step": k["launches_per_step"],
         "launches_store_path": store_launches.get(name, 0),
         "launches_smc_path": smc_launches.get(name, 0),
         "launches_dsl_path": dsl_launches.get(name, 0),
         "launches_timeseries_path": ts_launches.get(name, 0),
         "launches_examples_path": ex_launches.get(name, 0),
         "launches_sharded_path": sharded_launches.get(name, 0),
         "launches_sharded_engines_path": sharded_engines_launches.get(
             name, 0),
         "launches_sharded_vi_ts_path": vi_ts_launches.get(name, 0),
         "ms_shard_2p18": k["row_offset_ms"]["shard"],
         "ms_shard_2p18_row_offset": k["row_offset_ms"]["shard_offset"],
         "ms_half_as_4_shards": k["row_offset_ms"]["half_4"],
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, k in kernels.items()] + [wide_line]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    finally:
        for p in _CHILDREN:
            if p.poll() is None:
                p.kill()
                p.wait()
