"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
   33, 64; n = 50, 160, 1000; shifts 0, 1, n - 1, a wrap in the middle of a
   tile, a negative and an out-of-range shift; rows with lp_old = -inf);
   times both at the main path's shape;
2b. holds the split path's propose and accept kernels (any torch logp)
   against their plain versions, each alone bit for bit: Neal's funnel at
   n = 2^20, P = 10 and at the edge shapes and shifts above, the Rosenbrock
   banana (P = 2), a logistic regression at ragged n = 1000, rows with
   lp_old = -inf (which accept) and a logp that is NaN on some rows (which
   reject); times each kernel and the split half-step against the plain
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
   against 40, load, 40; the checkpoint's bytes and seconds);
   ``run_until_converged`` on the skewed Gaussian; the Analysis layer on a
   flagship chain (``covariance_matrix`` on the card against float64 numpy
   and against Σ, correlation, corner histograms, percentiles, summary,
   ESS) and the CSV and NPZ writers read back; the three example programs
   as subprocesses;
7. times 50 steps of the flagship and of Neal's funnel (wall time and the
   host's enqueue time per step) and takes a ``torch.profiler`` window over
   50 more of each: device time and launches per step by kernel; a flagship
   step must launch the fused kernel twice, a funnel step the propose and
   accept kernels twice each, and neither a ``uniform_`` kernel (nor the
   flagship a ``clamp_``), and a window over a storing run (bfloat16 rows):
   the casting row copies and the device-to-host copies beside the steps.
   Last, since the profiler's tracing slows every launch after it.

Any failure raises (non-zero exit); every phase prints its seconds. The
second-to-last lines are the kernel table (each kernel's time beside its
plain version's and its bound: its bytes, each input read once and each
output written once, over the card's 3.35 TB/s, or its operations over
67 TFLOP/s, whichever is larger) and the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script raises before printing any result.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

# published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12
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


@contextmanager
def phase(name):
    """Print the phase's seconds when it ends (failures propagate)."""
    print(f"-- phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"-- phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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


def timed_ms(fn, iters, blocker):
    """Mean ms per call of ``fn`` between CUDA events, after a warm-up, and
    the host's microseconds to enqueue one call. The calls queue up behind
    BLOCKER_FILLS fills of ``blocker`` (1 GiB: some 6 ms of device work), so
    the device runs them back to back and the time between the events is
    the device's, also when the host needs longer to enqueue a call than
    the device to run it."""
    for _ in range(3):
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


def in_turns(fns, iters, blocker):
    """Mean ms per call of each of ``fns``, timed in turns a, b, …, …, b, a
    on one card: (the means in the order given, each one's two readings,
    each one's mean host microseconds per enqueue)."""
    order = list(fns) + list(reversed(fns))
    times, host = {}, {}
    for f in order:
        ms, us = timed_ms(f, iters, blocker)
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
            "stretch_propose": bound_ms(n, p, 3, 1, 3 * p + 120),
            "stretch_accept": bound_ms(n, p, 3, 5, p + 120)}


def card_shift(n, shift):
    """Named shifts of the edge cases; "mid" wraps the partner run of a
    256-row tile at n in the middle of the tile."""
    named = {"last": n - 1, "mid": n - 100 if n > 100 else n // 2,
             "negative": -7, "beyond": 3 * n + 5}
    return named.get(shift, shift)


def half_inputs(fs_random, p, n, seed, neg_inf_every=0, lp_fn=None,
                shift=None):
    """Active rows near the mode, partners with every fourth row ×10 (far
    partners give rejections beside the accepts), lp_old (−inf on every
    ``neg_inf_every``-th row) and a shift on the card: the kernel's tensor
    arguments; then the Philox key and its planes (u, ue) from the plain
    twin."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    act = 0.5 * torch.randn((n, p), generator=g, device=dev)
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


def kernel_case(fs, rnd, target, n, seed, neg_inf_every=0, shift=None):
    """Fused kernel (uniforms from the key) vs plain version (the key's
    planes) on one input set; returns (max_abs_err, tensor args, key,
    planes)."""
    args, key, (u, ue) = half_inputs(rnd, target.dim, n, seed, neg_inf_every,
                                     target, shift)
    k_out = fs.fused_stretch_half(*args, key=key, logp_fn=target)
    torch.cuda.synchronize()
    r_out = fs.fused_stretch_half_reference(*args, u, ue, logp_fn=target)
    _, _, log_ratio = fs.stretch_proposal(*args, u, logp_fn=target)
    torch.cuda.synchronize()
    neg = slice(None, None, neg_inf_every) if neg_inf_every else None
    err = compare_half(f"fused n={n} P={target.dim} shift={int(args[3])}",
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
    if counted != {"fused_stretch_half": 0, "stretch_propose": 1,
                   "stretch_accept": 1}:
        raise AssertionError(f"split half-step launched {counted}")
    r_out = fs.fused_stretch_half_reference(*args, u, ue, logp_fn=logp)
    proposal, lp_new, log_ratio = fs.stretch_proposal(*args, u, logp_fn=logp)
    neg = slice(None, None, neg_inf_every) if neg_inf_every else None
    label = (f"split {target.name} n={n} P={target.dim} "
             f"shift={int(shift)}")
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    kernels = {}

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
                  for q in (2, 10, 33, 64)))

    # -- phase 2: fused kernel vs plain version -----------------------------
    with phase("2 fused kernel vs plain"):
        rng = np.random.default_rng(0)
        flagship = mt.equicorrelated_gaussian(10, 0.5, device=dev)
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
            (gauss(64), 1 << 14, 0, None),
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
            (gauss(33), 1000, 0, 1),
            (gauss(64), 300, 0, "mid"),
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
        kernels["fused_stretch_half"] = {
            "source": "mcmcpp_tpu_torch/csrc/fused_stretch.cu",
            "max_abs_err": max(errs), "ms": kernel_ms, "plain_ms": plain_ms}

    # -- phase 2b: the split kernels vs their plain versions ----------------
    with phase("2b split kernels vs plain"):
        funnel = mt.neal_funnel(10)
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
            kernels[f"stretch_{name}"] = {
                "source": "mcmcpp_tpu_torch/csrc/stretch_split.cu",
                "max_abs_err": max(split_errs), "ms": ms[name],
                "plain_ms": ms[f"{name}_plain"]}
        del sargs, act, lp, other, shift, u, ue, prop, fac, lp_new, calls
        del blocker

    # -- phase 3: the flagship at full width --------------------------------
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
        if launches != {"fused_stretch_half": 2 * n_steps,
                        "stretch_propose": 0, "stretch_accept": 0}:
            raise AssertionError(f"flagship launches {launches}, expected "
                                 f"{2 * n_steps} fused only")
        kernels["fused_stretch_half"]["launches_per_step"] = (
            launches["fused_stretch_half"] / n_steps)
        kernels["fused_stretch_half"]["launches"] = launches[
            "fused_stretch_half"]
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
    with phase("4 skewed oracle (fused)"):
        skewed = mt.skewed_gaussian(0.13, device=dev)
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
                want = {"fused_stretch_half": mover.picks[0],
                        "stretch_propose": 0, "stretch_accept": 0}
                if launches != want:
                    raise AssertionError(f"mixture launches {launches}, "
                                         f"expected {want}")
                extra = f", branch picks {mover.picks}, launches {launches}"
            if name == "fused_funnel":
                want = {"fused_stretch_half": 0,
                        "stretch_propose": 2 * steps,
                        "stretch_accept": 2 * steps}
                if launches != want:
                    raise AssertionError(f"funnel launches {launches}, "
                                         f"expected {want}")
                for k in ("stretch_propose", "stretch_accept"):
                    kernels[k]["launches"] = launches[k]
                    kernels[k]["launches_per_step"] = launches[k] / steps
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

    # -- phase 6: the reference's oracles on the card -----------------------
    with phase("6 oracles"):
        for name, make, n_steps, atol in [
            ("walk", lambda: mt.WalkMove(6), 4000, 0.12),
            ("de", lambda: mt.DifferentialEvolutionMove(), 8000, 0.15),
            ("mh", lambda: mt.MetropolisHastingsMove(
                covariance=SKEWED_COV, scale=1.2), 8000, 0.15),
            ("snooker", lambda: mt.DESnookerMove(), 4000, 0.15),
            ("dram", lambda: mt.DRAMMove(), 4000, 0.15),
            ("mixture", lambda: mt.MixtureMover([
                (mt.FusedStretchMove(), 2.0),
                (mt.DifferentialEvolutionMove(), 1.0),
                (mt.DESnookerMove(), 1.0)]), 8000, 0.15),
            ("slice", lambda: mt.EnsembleSliceMove(), 400, 0.12),
        ]:
            t0 = time.perf_counter()
            so = mt.EnsembleSampler(skewed, 320, 2, mover=make(), seed=42,
                                    batched=True, device="cuda")
            so.init_ball(np.zeros(2), scale=0.3)
            so.run_mcmc(1000, store=False)
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
                 12000),
                ("walk6", mt.WalkMove(6), 4000),
                ("de", mt.DifferentialEvolutionMove(), 6000)]:
            reset_launches(fs)
            t0 = time.perf_counter()
            sb = mt.EnsembleSampler(banana, 256, 2, mover=mover, seed=3,
                                    batched=True, device="cuda")
            sb.init_ball(np.array([1.0, 1.0]), scale=0.5, seed=4)
            sb.run_mcmc(2000, store=False)
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
                    "fused_stretch_half": 0, "stretch_propose": 28000,
                    "stretch_accept": 28000}:
                raise AssertionError(f"banana launches {fs.LAUNCHES}")

        t0 = time.perf_counter()
        phis = np.array([0.8, 0.904761904762])
        ar = mt.AutoRegressiveMove(np.zeros(2), phis, np.ones(2))
        sa = mt.EnsembleSampler(lambda t: torch.zeros_like(t[:, 0]), 100, 2,
                                mover=ar, seed=5, batched=True, device="cuda")
        sa.set_initial_walker_pos(ar.initial_positions(
            torch.Generator(device=dev).manual_seed(6), 100, device=dev))
        sa.run_mcmc(65536)
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
    with phase("8 store, checkpoint, resume, analyse"):
        import mcmcpp_tpu_torch.io.checkpoint as ckpt
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
        fused_only = lambda n: {"fused_stretch_half": 2 * n,  # noqa: E731
                                "stretch_propose": 0, "stretch_accept": 0}
        split_only = lambda n: {"fused_stretch_half": 0,  # noqa: E731
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
        store_launches = {}
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
        # beyond e4m3fn's range the rule is torch's own (the JAX package
        # stores NaN there): the card must apply the rule the CPU applies
        edge = torch.tensor([448.0, 464.0, 464.1, -1e4, float("inf")])
        on_card = bits(edge.to(dev).to(torch.float8_e4m3fn))
        on_cpu = bits(edge.to(torch.float8_e4m3fn))
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"e4m3fn beyond its range: card {on_card}, "
                                 f"CPU {on_cpu}")
        print(f"  float8_e4m3fn of {edge.tolist()} (torch "
              f"{torch.__version__}): "
              f"{edge.to(torch.float8_e4m3fn).float().tolist()}, the same "
              "bits on the card and on the CPU")

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
                a.run_mcmc(40, thin=10, checkpoint_path=path,
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
                a.run_mcmc(40, thin=10)
                b.run_mcmc(40, thin=10)
                same = all(torch.equal(x, y)
                           for x, y in zip(a.state[:6], b.state[:6]))
                same = same and a.state.step == b.state.step == 80
                same = same and np.array_equal(a.per_walker_accepted,
                                               b.per_walker_accepted)
                same = same and a.total_steps == b.total_steps
                for get in ("get", "get_logp"):
                    ra = torch.from_numpy(getattr(a.chain, get)(held=True))
                    rb = torch.from_numpy(getattr(b.chain, get)(held=True))
                    same = same and ra.shape[0] == 8 and torch.equal(ra, rb)
                if not same:
                    raise AssertionError(
                        f"{label}: the resumed run differs from the "
                        "uninterrupted one")
                print(f"  resume {label}: 40 + 40 steps == 40, load, 40 "
                      f"bitwise (state, counters, 8 rows at "
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

        # (e) the reference's three test programs, as a user runs them
        for mod, extra in [("skewed_gaussian",
                            ["--outdir", os.path.join(out_dir, "skewed")]),
                           ("actime", []), ("inner_benchmark", [])]:
            t0 = time.perf_counter()
            done = subprocess.run(
                [sys.executable, "-m", f"mcmcpp_tpu_torch.examples.{mod}",
                 "--device", "cuda", *extra],
                cwd=root, capture_output=True, text=True, timeout=300)
            print("    " + done.stdout.strip().replace("\n", "\n    "))
            if done.returncode != 0:
                raise AssertionError(
                    f"example {mod} exited {done.returncode}: "
                    f"{done.stderr[-2000:]}")
            print(f"  example {mod}: exit 0 "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()

    # -- phase 7: what a flagship step puts on the device --------------------
    # Last, because the profiler's tracing stays attached to the process
    # and slows every later launch: no timing may follow it.
    with phase("7 steps under the profiler"):
        prof_steps = 50
        for label, target, want in [
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
            for kernel in kernels:
                got = sum(n for k, (n, _) in rows.items() if kernel in k)
                if got != want.get(kernel, 0):
                    raise AssertionError(
                        f"a {label} step must launch {kernel} "
                        f"{want.get(kernel, 0)} times, saw {got}")
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

    for name, k in kernels.items():
        if not (k.get("launches") and store_launches.get(name)):
            raise AssertionError(f"{name} was not launched on its main path")
    # ms, plain_ms and bound_ms at n = 2^20, P = 10, the half-step of the
    # main path. library_ms is null: no one PyTorch call computes any of the
    # three functions (the plain versions are four to ten ops each).
    bounds = kernel_bounds(1 << 20, P_FULL)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": "mcmcpp_tpu/ops/pallas_stretch.py:164",
         "launches": k["launches"],
         "launches_per_step": k["launches_per_step"],
         "launches_store_path": store_launches.get(name, 0),
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, k in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
