"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``mcmcpp_tpu_torch/csrc/`` (into
``build/kernels/``), then:

1. identifies the card (torch and CUDA versions, ``nvidia-smi`` name and
   power limit);
2. holds the fused stretch kernel against its plain PyTorch version on the
   card, at the main path's shape (n = 2^20 walkers per half, P = 10) and at
   edge shapes (P = 2, ragged n = 1000 at P = 3, P = 64, rows with
   lp_old = -inf), and times both at the main path's shape;
3. runs the flagship (10-D equicorrelated Gaussian, W = 2^21 walkers)
   through ``EnsembleSampler`` + ``FusedStretchMove``: 200 burn-in steps and
   40 steps stored at thin 10, counting kernel launches, checking the stored
   logp and the acceptance, and timing the burn-in against the same steps
   through the plain version;
4. samples the 2-D skewed Gaussian oracle through the kernel and checks
   acceptance, covariance and the autocorrelation time.

Any failure raises (non-zero exit). The second-to-last lines are the kernel
table and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script raises
before printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FLOOR = 2.0 ** -25
# kernel vs plain version: logf/sqrtf against torch's ops and another
# summation order in the P×P product
RTOL = ATOL = 1e-5
# accept masks may differ only this close to the threshold
MARGIN = 1e-4


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters):
    """Mean ms per call of ``fn`` between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_chol(p, rng):
    a = rng.normal(size=(p, p))
    cov = a @ a.T / p + np.eye(p)
    return np.linalg.cholesky(np.linalg.inv(cov))


def kernel_case(fs, target, n, seed, neg_inf_every=0):
    """Kernel vs plain version on one input set; returns (max_abs_err,
    kernel args)."""
    dev = torch.device("cuda")
    p = target.dim
    g = torch.Generator(device=dev).manual_seed(seed)
    act = 0.5 * torch.randn((n, p), generator=g, device=dev)
    other = torch.randn((n, p), generator=g, device=dev)
    other[::4] *= 10.0  # far partners: rejections beside the accepts
    lp = target(act)
    if neg_inf_every:
        lp[::neg_inf_every] = -torch.inf
    u = torch.rand(n, generator=g, device=dev).clamp_(min=FLOOR)
    ue = torch.rand(n, generator=g, device=dev).clamp_(min=FLOOR)
    shift = torch.randint(0, n, (1,), generator=g, device=dev,
                          dtype=torch.int32)
    args = (act, lp, other, shift, u, ue)

    k_act, k_lp, k_acc = fs.fused_stretch_half(*args, logp_fn=target)
    torch.cuda.synchronize()
    r_act, r_lp, r_acc = fs.fused_stretch_half_reference(*args,
                                                         logp_fn=target)
    _, _, log_ratio = fs.stretch_proposal(*args[:5], logp_fn=target)
    torch.cuda.synchronize()

    n_acc = int(r_acc.sum())
    if not 0 < n_acc < n:
        raise AssertionError(f"n={n} P={p}: {n_acc} accepts, need a mix")
    if neg_inf_every and not bool((k_acc[::neg_inf_every] == 1).all()):
        raise AssertionError("a row with lp_old = -inf was rejected")
    near = ((log_ratio - torch.log(ue)).abs()
            < MARGIN * log_ratio.abs().clamp(min=1.0))
    same = k_acc == r_acc
    if not bool((same | near).all()):
        raise AssertionError(
            f"n={n} P={p}: {int((~same & ~near).sum())} accept decisions "
            "differ away from the threshold"
        )
    torch.testing.assert_close(k_act[same], r_act[same], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(k_lp[same], r_lp[same], rtol=RTOL, atol=ATOL)
    err = max(float((k_act[same] - r_act[same]).abs().max()),
              float((k_lp[same] - r_lp[same]).abs().max()))
    print(f"  kernel vs plain n={n} P={p}: accepts {n_acc}/{n}, "
          f"mask diffs {int((~same).sum())} (all near threshold), "
          f"max abs err {err:.3e}")
    return err, args


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch import _build
    from mcmcpp_tpu_torch.ops import fused_stretch as fs

    # full-float32 plain versions: TF32 would keep ~3 decimal digits and
    # break the kernel-vs-plain tolerance
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card ------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel library {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernel vs plain version ----------------------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flagship = mt.equicorrelated_gaussian(10, 0.5, device=dev)
    main_err, main_args = kernel_case(fs, flagship, 1 << 20, seed=1)
    errs = [main_err]
    for target, n, neg in [
        (mt.skewed_gaussian(device=dev), 160, 0),
        (mt.GaussianTarget(random_chol(3, rng), device=dev), 1000, 0),
        (mt.GaussianTarget(random_chol(64, rng), device=dev), 1 << 14, 0),
        (flagship, 4096, 5),
    ]:
        errs.append(kernel_case(fs, target, n, seed=n, neg_inf_every=neg)[0])

    def kernel_call():
        fs.fused_stretch_half(*main_args, logp_fn=flagship)

    def plain_call():
        fs.fused_stretch_half_reference(*main_args, logp_fn=flagship)

    # in turns, plain / kernel / kernel / plain, on one card
    p1, k1, k2, p2 = (timed_ms(f, 50) for f in
                      (plain_call, kernel_call, kernel_call, plain_call))
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"  half-step n=2^20 P=10: kernel {kernel_ms:.4f} ms "
          f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
          f"({p1:.4f}, {p2:.4f}) [{card}]")

    # -- phase 3: the flagship at full width --------------------------------
    n_walkers, burn, n_store, thin = 1 << 21, 200, 40, 10
    fs.LAUNCHES = 0
    s = mt.EnsembleSampler(flagship, n_walkers=n_walkers, n_params=10,
                           mover=mt.FusedStretchMove(), seed=0, batched=True,
                           device="cuda")
    s.init_ball(np.zeros(10), 0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_mcmc(burn, store=False)
    torch.cuda.synchronize()
    burn_s = time.perf_counter() - t0
    if not s.run_mcmc(n_store, thin=thin):
        raise AssertionError("chain capacity hit in the flagship run")
    launches = fs.LAUNCHES
    if launches != 2 * (burn + n_store):
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{2 * (burn + n_store)}")
    samples = s.get_samples()
    if samples.shape != (n_store // thin, n_walkers, 10):
        raise AssertionError(f"stored shape {samples.shape}")
    if not np.isfinite(samples).all():
        raise AssertionError("non-finite stored positions")
    stored_lp = torch.from_numpy(s.get_log_probs()).to(dev)
    recomputed = flagship(torch.from_numpy(samples).to(dev))
    torch.testing.assert_close(stored_lp, recomputed, rtol=1e-5, atol=1e-5)
    acc = s.acceptance_fraction
    print(f"flagship W=2^21 P=10: {launches} kernel launches, acceptance "
          f"{acc:.4f}, stored {samples.shape}")
    if not 0.2 < acc < 0.8:
        raise AssertionError(f"flagship acceptance {acc}")
    del samples, stored_lp, recomputed

    class PlainFusedStretchMove(mt.FusedStretchMove):
        """The same draws and transition through the plain version."""

        def apply(self, active, active_logp, other, logp_fn, state, noise,
                  beta=1.0):
            shift, u, ue = noise
            return fs.fused_stretch_half_reference(
                active, active_logp, other, shift, u, ue, logp_fn=logp_fn,
                a=self.a)

    sp = mt.EnsembleSampler(flagship, n_walkers=n_walkers, n_params=10,
                            mover=PlainFusedStretchMove(), seed=0,
                            batched=True, device="cuda")
    sp.init_ball(np.zeros(10), 0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp.run_mcmc(burn, store=False)
    torch.cuda.synchronize()
    plain_burn_s = time.perf_counter() - t0
    rate = burn * n_walkers / burn_s
    plain_rate = burn * n_walkers / plain_burn_s
    print(f"flagship burn-in {burn} steps: kernel {rate:.6e} "
          f"walker-updates/s ({burn_s:.4f} s), plain {plain_rate:.6e} "
          f"walker-updates/s ({plain_burn_s:.4f} s) [{card}]")
    del s, sp
    torch.cuda.empty_cache()

    # -- phase 4: skewed-Gaussian oracle through the kernel -----------------
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
    true_cov = np.array([[1.13, 0.435], [0.435, 0.2825]])
    if not np.allclose(cov, true_cov, atol=0.05):
        raise AssertionError(f"oracle covariance {cov}")
    if not (np.all(tau > 0) and np.all(tau < 20)):
        raise AssertionError(f"oracle autocorrelation time {tau}")

    print(json.dumps({"kernels": [{
        "name": "fused_stretch_half",
        "route": "cuda",
        "source": "mcmcpp_tpu_torch/csrc/fused_stretch.cu",
        "replaces": "mcmcpp_tpu/ops/pallas_stretch.py:164",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
